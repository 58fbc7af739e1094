"""The fishing (class-parameter) server of the port against the JAX package's, ConvNet-8
at 3x16x16 on the same weights, with the users' batches equal bit for bit:

- under a class collision (three images of one class), in one-shot mode and in recursive
  mode: the same labels, target index, query count, final cutoff (the head's bias in the
  final payload) and shared gradient, to 1e-5 of its largest entry;
- without a collision, the class attack's shared gradient and secrets;
- the feature-estimation protocol with three additional users: the chosen feature and
  its cutoff, to 1e-5;
- ``classattack_utils`` (``cal_single_gradients``, ``order_gradients``,
  ``estimate_gt_stats``, ``find_best_feat``) and ``_recover_labels``; the ``ClassAttack``
  expansion of the optimization attack, and the entry point with feature-estimation users.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.malicious import classattack_utils as jax_utils
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.optimization_based_attack import expand_class_attack
from breaching_tpu_torch.cases.malicious import classattack_utils as utils
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
FISHING = ["case=1_single_image_small", "attack=clsattack", "case/server=malicious-fishing", "case.model=ConvNet8",
           "case.data.shape=[3, 16, 16]", "case.user.provide_labels=True"]
COLLISION = FISHING + ["case.data.partition=unique-class", "case.user.user_idx=3", "case.user.num_data_points=3",
                       "seed=13"]
# a sharp transition (the JAX package's tests/test_binary_attack.py), so that the recursive
# search separates the three features of the small model
RECURSIVE = ["case.server.one_shot_binary_attack=False", "case.server.feat_multiplier=30000",
             "case.server.bias_multiplier=0"]
FEATURE_ESTIMATION = FISHING + ["case.data.partition=feat_est", "case.data.target_label=0",
                                "case.data.num_data_points=2", "case.user.num_data_points=2",
                                "case.server.target_cls_idx=0", "seed=3"]


def _flat(params, buffers=None):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers or {})):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _as_port(model, flat):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: (transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model) if key.startswith("params/")}


def _cases(overrides):
    """Both packages' fishing cases, the port's model on the JAX model's weights (loaded
    before the server keeps its original parameters)."""
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, _flat(j_model.params, j_model.buffers), strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    model = server.vet_model(model)
    user = breaching.cases.construct_user(model, loss, cfg.case, setup)
    return dict(cfg=cfg, setup=setup, user=user, server=server, model=model, loss=loss, j_cfg=j_cfg,
                j_setup=j_setup, j_user=j_user, j_server=j_server, j_model=j_model)


def _close(got, want, rel=1e-5, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _compare_exchanges(e, result, j_result):
    (shared, payloads, true), (j_shared, j_payloads, j_true) = result, j_result
    np.testing.assert_array_equal(true["data"].permute(0, 2, 3, 1).numpy(), np.asarray(j_true["data"]))
    assert e["user"].counted_queries == e["j_user"].counted_queries
    secrets, j_secrets = e["server"].secrets.get("ClassAttack"), e["j_server"].secrets.get("ClassAttack")
    assert (secrets is None) == (j_secrets is None)
    if secrets is not None:
        np.testing.assert_array_equal(secrets["target_indx"], np.asarray(j_secrets["target_indx"]))
        np.testing.assert_array_equal(secrets["all_labels"].numpy(), np.asarray(j_secrets["all_labels"]))
        assert secrets["true_num_data"] == j_secrets["true_num_data"] and secrets["num_data"] == 1
    metadata, j_metadata = shared[0]["metadata"], j_shared[0]["metadata"]
    assert metadata["num_data_points"] == j_metadata["num_data_points"]
    np.testing.assert_array_equal(torch.as_tensor(metadata["labels"]).numpy(), np.asarray(j_metadata["labels"]))
    # the final payload's head: the cutoff in the target's bias, the chosen feature's weight
    head = _as_port(e["model"], _flat(j_payloads[0]["parameters"]))
    _close(payloads[0]["parameters"]["head.bias"], head["head.bias"])
    _close(payloads[0]["parameters"]["head.weight"], head["head.weight"])
    grads, j_grads = shared[0]["gradients"], _as_port(e["model"], _flat(j_shared[0]["gradients"]))
    scale = max(np.abs(g).max() for g in j_grads.values())
    for name, grad in grads.items():
        _close(grad, j_grads[name], scale=scale)
    # the server restored its model
    want = _as_port(e["model"], _flat(e["j_server"].model.params))
    for name, value in e["model"].named_parameters():
        np.testing.assert_array_equal(value.detach().numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("mode", ["one-shot", "recursive"])
def test_binary_attack_under_a_class_collision_matches_jax(mode):
    e = _cases(COLLISION + (RECURSIVE if mode == "recursive" else []))
    result = e["server"].run_protocol(e["user"])
    j_result = e["j_server"].run_protocol(e["j_user"])
    assert (result[2]["labels"] == result[2]["labels"][0]).all() and len(result[2]["labels"]) == 3
    assert e["user"].counted_queries > (3 if mode == "recursive" else 2)
    _compare_exchanges(e, result, j_result)


def test_class_attack_without_a_collision_matches_jax():
    e = _cases(FISHING + ["case.user.num_data_points=4", "seed=7"])
    result = e["server"].run_protocol(e["user"])
    j_result = e["j_server"].run_protocol(e["j_user"])
    assert e["user"].counted_queries == 2 and len(set(result[2]["labels"].tolist())) == 4
    _compare_exchanges(e, result, j_result)
    expanded = expand_class_attack(dict(data=torch.ones(1, 3, 16, 16), labels=torch.tensor([0])),
                                   e["server"].secrets["ClassAttack"])
    info = e["j_server"].secrets["ClassAttack"]
    want = jnp.zeros((info["true_num_data"], 16, 16, 3)).at[jnp.asarray(info["target_indx"]).reshape(-1)].set(
        jnp.ones((1, 16, 16, 3)))
    np.testing.assert_array_equal(expanded["data"].permute(0, 2, 3, 1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(expanded["labels"].numpy(), np.asarray(info["all_labels"]))


def _additional_users(make_user, cfg, model, server, setup):
    users = []
    for idx in (1, 2, 3):
        cfg.case.user.user_idx = idx
        users.append(make_user(model, server.loss, cfg.case, setup))
    cfg.case.user.user_idx = 0
    return users


def test_feature_estimation_protocol_matches_jax():
    e = _cases(FEATURE_ESTIMATION)
    users = _additional_users(breaching.cases.construct_user, e["cfg"], e["model"], e["server"], e["setup"])
    j_users = _additional_users(jax_breaching.cases.construct_user, e["j_cfg"], e["j_model"], e["j_server"],
                                e["j_setup"])
    shared, payloads, true = e["server"].run_protocol(e["user"], additional_users=users)
    j_shared, j_payloads, j_true = e["j_server"].run_protocol(e["j_user"], additional_users=j_users)
    weight = payloads[0]["parameters"]["head.weight"]
    j_weight = np.asarray(j_payloads[0]["parameters"]["head"]["dense"]["kernel"]).T
    assert torch.nonzero(weight).tolist() == np.argwhere(j_weight).tolist() and len(torch.nonzero(weight)) == 1
    _close(payloads[0]["parameters"]["head.bias"], j_payloads[0]["parameters"]["head"]["dense"]["bias"])
    _close(true["distribution"], j_true["distribution"])
    grads, j_grads = shared[0]["gradients"], _as_port(e["model"], _flat(j_shared[0]["gradients"]))
    scale = max(np.abs(g).max() for g in j_grads.values())
    for name, grad in grads.items():
        _close(grad, j_grads[name], scale=scale)


def test_classattack_utils_match_jax():
    e = _cases(FISHING + ["case.user.num_data_points=3", "seed=5"])
    _, true = e["user"].compute_local_updates(e["server"].distribute_payload())
    flat, losses = utils.cal_single_gradients(e["model"], e["loss"], true)
    j_flat, j_losses = jax_utils.cal_single_gradients(
        e["j_model"], e["j_server"].loss, dict(data=true["data"].permute(0, 2, 3, 1).numpy(),
                                               labels=true["labels"].numpy()))
    # each JAX row split at its leaves (in the JAX package's leaf order), in the port's names and layouts
    leaves = jax.tree_util.tree_flatten_with_path(e["j_model"].params)[0]
    keys = ["params/" + "/".join(k.key for k in path) for path, _ in leaves]
    bounds = np.cumsum([leaf.size for _, leaf in leaves])[:-1]
    for row, j_row in zip(flat, np.asarray(j_flat)):
        pieces = {key: piece.reshape(leaf.shape) for key, piece, (_, leaf) in zip(keys, np.split(j_row, bounds), leaves)}
        by_name = _as_port(e["model"], pieces)
        want = np.concatenate([by_name[name].ravel() for name, _ in e["model"].named_parameters()])
        _close(row, want, scale=np.abs(np.asarray(j_flat)).max())
    _close(losses, j_losses)
    # recovered gradients matched to the true ones: a permutation of the rows
    kinds, sizes = zip(*[(name, p.numel()) for name, p in e["model"].named_parameters()])
    recovered = [dict(zip(kinds, torch.split(flat[i], sizes))) for i in (2, 0, 1)]
    ordered = utils.order_gradients(recovered, flat)
    assert [torch.equal(torch.cat(list(o.values())), flat[i]) for i, o in enumerate(ordered)] == [True] * 3
    rng = np.random.default_rng(2)
    features, sizes = rng.normal(size=(6, 9)), rng.integers(1, 4, size=9)
    features[4] = rng.normal(size=9) * 0.01 + 1.0
    for method in ("kstest", "most-spread", "most-high-mean"):
        assert utils.find_best_feat(features, sizes, method) == jax_utils.find_best_feat(features, sizes, method)
    assert utils.estimate_gt_stats(features, sizes, 3) == jax_utils.estimate_gt_stats(features, sizes, 3)
    bias = rng.normal(size=10).astype(np.float32)
    np.testing.assert_array_equal(e["server"]._recover_labels(bias, 5), e["j_server"]._recover_labels(bias, 5))


def test_entry_point_runs_the_feature_estimation_users(tmp_path):
    cfg = breaching.get_config(FEATURE_ESTIMATION + ["case.server.feature_estimation_users=3", "dryrun=True"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    metrics = main_process(cfg, device="cpu")
    assert np.isfinite(metrics["mse"]) and metrics["label_acc"] == 1.0
