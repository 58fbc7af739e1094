"""Restarts and the fleet on the port's batched trial step, on a reduced ResNet
(ResNet-20, CIFAR stem, width 16) at 16x16, against the per-trial plain loop and
against the JAX package's ``reconstruct_fleet``; the ``bias-corrected`` label
recovery against the JAX package's; and the CPU dry run of the port's entry point.

Tolerances (float32 on both sides; agreement measured on these tests in brackets):
- batched step against the per-trial loop, 5 steps, unsigned Adam: every loss
  within 1e-5 relative [3.5e-7], no pixel of a reconstruction more than 1e-3 apart
  [7.7e-7; 3.4e-4 from other initial candidates: Adam divides each gradient entry
  by its own running size, so an entry near zero carries its rounding into a full
  step]; hard-signed Adam: losses within 1e-3 relative [2.2e-6] and no pixel more
  than 1e-3 apart [0];
- the port's fleet against the JAX package's, 3 hard-signed steps from the same
  candidates: losses within 1e-3 relative [1.6e-6], at most 1% of the pixels of a
  reconstruction more than 1e-3 apart [none; 1.2e-7 at most], the same trial
  selected per experiment, as ``tests/test_torch_attack.py`` holds the solo attack.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.regularizers import TotalVariation as JaxTotalVariation
from breaching_tpu.attacks.base_attack import _BaseAttacker as JaxBaseAttacker
from breaching_tpu.cases.models.model_preparation import JaxModel
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.regularizers import TotalVariation
from breaching_tpu_torch.attacks.base_attack import _BaseAttacker
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
OVERRIDES = ["case=1_single_image_small", "attack=invertinggradients", "case.model=resnet20",
             "case.data.shape=[3, 16, 16]", "case.data.batch_size=4", "case.user.provide_labels=True",
             "seed=3"]


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _experiments(package, overrides, users, weights=None, device=None):
    """One case (one server, one model) and ``users`` users' exchanges with it, as
    ``bench.py`` builds the fleet; the port's model takes ``weights`` if given."""
    cfg = package.get_config(OVERRIDES + overrides)
    setup = (package.utils.system_startup(cfg=cfg, device=device) if device
             else package.utils.system_startup(cfg=cfg))
    user, server, model, _ = package.cases.construct_case(cfg.case, setup)
    if weights is not None:
        load_flat_state(model, weights, strict=True)
    payload_lists, shared_lists, truths = [], [], []
    for idx in range(users):
        cfg.case.user.user_idx = idx
        user = package.cases.construct_user(model, server.loss, cfg.case, setup)
        shared, payloads, true = server.run_protocol(user)
        payload_lists.append(payloads)
        shared_lists.append(shared)
        truths.append(true)
    attacker = package.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    return dict(cfg=cfg, setup=setup, model=model, attacker=attacker, payloads=payload_lists,
                shared=shared_lists, truths=truths)


def _candidates(trials, seed=7):
    return np.random.default_rng(seed).normal(size=(trials, 1, 3, 16, 16)).astype(np.float32)


def _run_port(overrides, mode, batched, x0):
    run = _experiments(breaching, overrides, users=2 if mode == "fleet" else 1, device="cpu")
    attacker = run["attacker"]
    attacker.batched_trials = batched
    attacker._initialize_data = lambda shape: torch.from_numpy(x0.reshape(shape))
    if mode == "fleet":
        results, stats = attacker.reconstruct_fleet(run["payloads"], run["shared"])
    else:
        result, stats = attacker.reconstruct(run["payloads"][0], run["shared"][0])
        results = [result]
    return results, stats


@pytest.mark.parametrize("objective", ["cosine-similarity", "fused-cosine-similarity", "fused-euclidean"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("mode", ["restarts", "fleet"])
def test_batched_trials_match_the_per_trial_loop(mode, signed, objective):
    trials = 3 if mode == "restarts" else 2
    overrides = [f"attack.objective.type={objective}", f"attack.optim.signed={'hard' if signed else False}",
                 "attack.optim.max_iterations=5", "attack.optim.callback=5"]
    if mode == "restarts":
        overrides.append(f"attack.restarts.num_trials={trials}")
    x0 = _candidates(trials)
    got, got_stats = _run_port(overrides, mode, True, x0)
    want, want_stats = _run_port(overrides, mode, False, x0)
    for t in range(trials):
        losses, want_losses = got_stats[f"Trial_{t}_Val"], want_stats[f"Trial_{t}_Val"]
        assert len(losses) == len(want_losses) == 5
        np.testing.assert_allclose(losses, want_losses, rtol=1e-3 if signed else 1e-5)
    for result, expected in zip(got, want):
        assert torch.equal(result["labels"], expected["labels"])
        assert (result["data"] - expected["data"]).abs().max().item() <= 1e-3
    if mode == "fleet":
        np.testing.assert_allclose(got_stats["fleet_opt_values"], want_stats["fleet_opt_values"],
                                   rtol=1e-3 if signed else 1e-5)


@pytest.mark.parametrize("double_opponents", [False, True])
def test_tv_of_each_trial_matches_the_jax_packages_vmapped_regularizer(double_opponents):
    """The fleet's TV: the JAX package vmaps its regularizer over the trials, so each
    trial's value is the mean over that trial's own elements; 1e-5 relative on the
    values and 1e-5 of the largest gradient entry (sums in other orders)."""
    x = np.random.default_rng(2).normal(size=(4, 2, 3, 16, 16)).astype(np.float32)
    jax_tv = JaxTotalVariation(scale=0.2, double_opponents=double_opponents)
    values, grads = jax.vmap(jax.value_and_grad(jax_tv))(jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2))))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TotalVariation(scale=0.2, double_opponents=double_opponents).trials(xt)
    grad, = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(values), rtol=1e-5)
    want = np.transpose(np.asarray(grads), (0, 1, 4, 2, 3))
    np.testing.assert_allclose(grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def fleets():
    """The JAX package's reconstruct_fleet and the port's, 2 experiments x 2 restarts,
    3 hard-signed steps, on the same weights, data and initial candidates."""
    overrides = ["attack.restarts.num_trials=2", "attack.optim.max_iterations=3", "attack.optim.callback=3"]
    ref = _experiments(jax_breaching, overrides, users=2)
    weights = _flat(ref["model"].params, ref["model"].buffers)
    port = _experiments(breaching, overrides, users=2, weights=weights, device="cpu")
    x0 = _candidates(4, seed=11)

    # the JAX attacker draws each trial's candidate from its own key, inside a vmap:
    # map the key to its trial and return that trial's candidate (NHWC)
    _, key = jax.random.split(ref["setup"]["key"])
    init_keys = jax.random.split(key, 4)
    table = jnp.asarray(np.transpose(x0, (0, 1, 3, 4, 2)))

    def initialize(shape, key):
        return table[jnp.argmax(jnp.all(init_keys == key, axis=-1))]

    ref["attacker"]._initialize_data = initialize
    captured = {}
    run_all = ref["attacker"]._run_all_trials

    def spy(*args, **kwargs):
        captured["jax"] = run_all(*args, **kwargs)
        return captured["jax"]

    ref["attacker"]._run_all_trials = spy
    j_results, j_stats = ref["attacker"].reconstruct_fleet(ref["payloads"], ref["shared"])

    port["attacker"]._initialize_data = lambda shape: torch.from_numpy(x0.reshape(shape))
    run_port = port["attacker"]._run_all_trials

    def port_spy(*args, **kwargs):
        captured["port"] = run_port(*args, **kwargs)
        return captured["port"]

    port["attacker"]._run_all_trials = port_spy
    results, stats = port["attacker"].reconstruct_fleet(port["payloads"], port["shared"])
    return dict(ref=ref, port=port, j_results=j_results, j_stats=j_stats, results=results, stats=stats,
                j_best=np.transpose(np.asarray(captured["jax"][0]["data"]), (0, 1, 4, 2, 3)),
                best=captured["port"][0]["data"].numpy())


def test_fleet_matches_the_jax_package(fleets):
    for truth, j_truth in zip(fleets["port"]["truths"], fleets["ref"]["truths"]):
        np.testing.assert_allclose(truth["data"].numpy(), np.transpose(np.asarray(j_truth["data"]), (0, 3, 1, 2)),
                                   rtol=0, atol=1e-6)
    for t in range(4):
        np.testing.assert_allclose(fleets["stats"][f"Trial_{t}_Val"], fleets["j_stats"][f"Trial_{t}_Val"],
                                   rtol=1e-3)
    differing = np.abs(fleets["best"] - fleets["j_best"]) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
    for result, j_result, truth in zip(fleets["results"], fleets["j_results"], fleets["port"]["truths"]):
        # each experiment keeps its own labels
        np.testing.assert_array_equal(result["labels"].numpy(), np.asarray(j_result["labels"]))
        np.testing.assert_array_equal(result["labels"].numpy(), truth["labels"].numpy())
    assert not torch.equal(fleets["results"][0]["labels"], fleets["results"][1]["labels"])
    np.testing.assert_allclose(fleets["stats"]["fleet_opt_values"], fleets["j_stats"]["fleet_opt_values"],
                               rtol=1e-3)


def test_fleet_restarts_select_the_jax_packages_trial(fleets):
    for i, (result, j_result) in enumerate(zip(fleets["results"], fleets["j_results"])):
        block = slice(2 * i, 2 * i + 2)
        chosen = [j for j in range(2) if np.array_equal(fleets["best"][block][j], result["data"].numpy())]
        j_data = np.transpose(np.asarray(j_result["data"]), (0, 3, 1, 2))
        j_chosen = [j for j in range(2) if np.array_equal(fleets["j_best"][block][j], j_data)]
        assert len(chosen) == len(j_chosen) == 1 and chosen == j_chosen, (chosen, j_chosen)


def test_fleet_refuses_diverging_parameters_and_multi_query_payloads():
    run = _experiments(breaching, ["attack.optim.max_iterations=2"], users=2, device="cpu")
    payloads = [dict(run["payloads"][1][0], parameters={
        k: v + 1e-3 for k, v in run["payloads"][1][0]["parameters"].items()})]
    with pytest.raises(ValueError, match="identical model parameters"):
        run["attacker"].reconstruct_fleet([run["payloads"][0], payloads], run["shared"])
    with pytest.raises(ValueError, match="single-query"):
        run["attacker"].reconstruct_fleet([run["payloads"][0] * 2, run["payloads"][1] * 2],
                                          [run["shared"][0] * 2, run["shared"][1] * 2])


def test_batched_step_takes_batchnorm_in_train_mode():
    """Without buffers the attacker's ResNet runs BatchNorm in train mode: the batched
    step normalizes each trial by its own batch statistics, and its losses equal the
    per-trial loop's to 1e-5 relative (unsigned Adam, 3 steps); the model's running
    statistics stay as they were."""
    overrides = ["case.server.provide_public_buffers=False", "case.user.provide_buffers=False",
                 "attack.restarts.num_trials=2", "attack.optim.max_iterations=3", "attack.optim.callback=3",
                 "attack.optim.signed=False"]
    x0 = _candidates(2, seed=5)
    got, got_stats = _run_port(overrides, "restarts", True, x0)
    want, want_stats = _run_port(overrides, "restarts", False, x0)
    for t in range(2):
        assert len(got_stats[f"Trial_{t}_Val"]) == 3
        np.testing.assert_allclose(got_stats[f"Trial_{t}_Val"], want_stats[f"Trial_{t}_Val"], rtol=1e-5)
    assert got_stats["Trial_0_Val"] != got_stats["Trial_1_Val"]
    assert (got[0]["data"] - want[0]["data"]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("num_data_points,queries", [(1, 1), (4, 2), (8, 2)])
def test_bias_corrected_labels_match_the_jax_package(num_data_points, queries):
    """Both packages' recovery on the same head gradients: for each query the mean over
    its batch of softmax - one-hot, the bias gradient of the cross entropy, with
    labels drawn with repeats so that the correction loop runs."""
    rng = np.random.default_rng(num_data_points)
    classes, features = 10, 6
    port_data, jax_data = [], []
    for _ in range(queries):
        logits = rng.normal(size=(num_data_points, classes))
        probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        labels = rng.integers(0, classes // 2, num_data_points)
        bias = (probs - np.eye(classes)[labels]).mean(axis=0).astype(np.float32)
        weight = rng.normal(size=(features, classes)).astype(np.float32)
        metadata = dict(num_data_points=num_data_points, labels=None)
        jax_data.append(dict(gradients={"head": {"dense": {"kernel": jnp.asarray(weight), "bias": jnp.asarray(bias)}}},
                             metadata=metadata))
        port_data.append(dict(gradients={"head.weight": torch.from_numpy(weight.T.copy()),
                                         "head.bias": torch.from_numpy(bias)}, metadata=metadata))
    cfg = breaching.get_attack_config("invertinggradients")
    jax_cfg = jax_breaching.get_attack_config("invertinggradients")
    assert cfg.label_strategy == jax_cfg.label_strategy == "bias-corrected"
    got = _BaseAttacker(None, None, cfg, dict(device=torch.device("cpu")))._recover_label_information(port_data)
    jax_model = JaxModel(name="head", module=None, params={}, buffers={})
    want = JaxBaseAttacker(None, None, jax_cfg, {})._recover_label_information(jax_data, None, [jax_model])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(got) == num_data_points


def test_other_label_strategies_are_refused():
    # iDLG, analytic, yin, wainakh-simple and random are ported (tests/test_torch_presets.py),
    # wainakh-whitebox and exhaustive's refusal too (tests/test_torch_labels.py); bias-text
    # recovers a text payload's tokens (tests/test_torch_text_recovery.py) and is refused here
    cfg = breaching.get_attack_config("invertinggradients", ["attack.label_strategy=bias-text"])
    with pytest.raises(NotImplementedError, match="bias-text"):
        _BaseAttacker(None, None, cfg, dict(device=torch.device("cpu")))._recover_label_information(
            [dict(gradients={}, metadata=dict(num_data_points=1, labels=None))])


def test_entry_point_dry_run_on_the_cpu(caplog, tmp_path):
    """The slice-2 case at a reduced image size (ResNet-18 on the repo's checkpoint at
    32x32, labels left to the attack) through ``main_process``."""
    cfg = breaching.get_config(["case=2_single_imagenet", "attack=invertinggradients", "dryrun=True",
                                "case.data.shape=[3, 32, 32]", "case.data.batch_size=2", "seed=7"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    with caplog.at_level(logging.INFO):
        metrics = main_process(cfg, device="cpu")
    assert "METRICS: | MSE:" in caplog.text
    assert "Loaded 122 pretrained tensors for ResNet18" in caplog.text
    assert "through strategy bias-corrected" in caplog.text
    assert np.isfinite(metrics["mse"]) and metrics["parameters"] == 11_380_173


def test_entry_point_refuses_feature_estimation_users():
    cfg = breaching.get_config(["case=2_single_imagenet", "attack.optim.max_iterations=1"])
    cfg.case.server.feature_estimation_users = 2
    with pytest.raises(NotImplementedError, match="Feature-estimation"):
        main_process(cfg, device="cpu")
