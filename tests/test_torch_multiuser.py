"""The secure-aggregation silo (``MultiUserAggregate``, case 8) against the JAX package's,
on ``ConvNetSmall16`` at 3x16x16, the port's model on the JAX package's weights:

- the single-step silo of 3 users (sum over users, then one division) against the JAX
  package's ``_aggregate_singlestep_batched``, to 1e-6 of the largest entry, with the
  mean of the users' running statistics where BatchNorm trains;
- the multi-step silo (2 local steps of 2 images per user, the running mean of the
  users' deltas) against the JAX package's sequential loop, to 1e-5 of the largest entry,
  the fedAVG delta's tolerance (slice 3): a delta is a difference of parameters, rounded
  to their ulps (1.2e-9 apart on one entry of 4,608 where 1e-6 would ask for 4.8e-10);
- the metadata (``num_data_points`` per user times the users, the sorted labels,
  ``num_users``, the per-step label lists) and the true data and labels, exactly;
- the JAX package's ``test_multiuser_aggregate_hyperparam_and_singlestep_semantics``,
  mirrored: the single-step aggregate is the mean of the users' own ``UserSingleStep``
  gradients (to 1e-6 of the largest entry), and a multi-step silo shares steps x users
  label lists of the step's size;
- ``ConvNet8`` without the server's buffers, so that BatchNorm runs in train mode on each
  user's batch of two and the users share their statistics: the silo against the same
  silo in float64 (1e-6 of the largest entry single-step; multi-step 1e-5 plus one
  float32 ulp of the parameter, which rounds each delta: BatchNorm's unit scales move by
  1e-4, on a grid of 1.2e-7), and the
  single-step statistics against the JAX package's (1e-6). The JAX package's float32
  gradient is not held here: on user 0 (labels 8 and 0) it lies 6.7e-2 of its largest
  entry from the float64 one, where the port's lies 7.1e-7 (ROADMAP, mismatches).
"""

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state
from breaching_tpu_torch.cases.users import MultiUserAggregate, UserSingleStep

torch.set_num_threads(1)
SILO = ["case=8_industry_scale_fl", "attack=invertinggradients", "case/data=CIFAR10", "case.data.shape=[3, 16, 16]",
        "case.data.default_clients=16", "case.user.user_range=[0, 3]", "case.user.num_data_points=2",
        "case.user.provide_labels=True", "seed=3"]
MULTI_STEP = ["case.user.num_local_updates=2", "case.user.num_data_per_local_update_step=2",
              "case.user.provide_local_hyperparams=True"]


def _flat(params, buffers=None):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers or {})):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _as_port(model, flat, kind="params/"):
    names = {id(t): n for n, t in [*model.named_parameters(), *model.named_buffers()]}
    return {names[id(tensor)]: (transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model) if key.startswith(kind)}


def _silos(overrides):
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, _flat(j_model.params, j_model.buffers), strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    user = breaching.cases.construct_user(server.vet_model(model), loss, cfg.case, setup)
    return cfg, setup, user, server, model, j_user, j_server


def _close_trees(got, want, rel=1e-6, ulps=None):
    """Each tensor to ``rel`` of the largest entry of all, plus, with ``ulps`` (tensors by
    name), one float32 ulp of the largest entry of that tensor."""
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, value in got.items():
        slack = 0.0 if ulps is None else np.finfo(np.float32).eps * float(ulps[name].abs().max())
        np.testing.assert_allclose(value.numpy(), want[name], rtol=0, atol=rel * scale + slack, err_msg=name)


@pytest.mark.parametrize("steps", ["single-step", "multi-step"])
def test_silo_matches_jax(steps):
    overrides = SILO + ["case.model=ConvNetSmall16"] + (MULTI_STEP if steps == "multi-step" else [])
    cfg, setup, user, server, model, j_user, j_server = _silos(overrides)
    assert isinstance(user, MultiUserAggregate) and user.num_users == 3 and user.user_idx == "0-2"
    shared, payloads, true = server.run_protocol(user)
    j_shared, _, j_true = j_server.run_protocol(j_user)
    rel = 1e-6 if steps == "single-step" else 1e-5
    _close_trees(shared[0]["gradients"], _as_port(model, _flat(j_shared[0]["gradients"])), rel)
    assert shared[0]["buffers"] is None and j_shared[0]["buffers"] is None

    meta, j_meta = shared[0]["metadata"], j_shared[0]["metadata"]
    assert meta["num_data_points"] == j_meta["num_data_points"] == 6 and meta["num_users"] == j_meta["num_users"] == 3
    np.testing.assert_array_equal(meta["labels"].numpy(), np.asarray(j_meta["labels"]))
    assert (np.diff(meta["labels"].numpy()) >= 0).all()
    hyper, j_hyper = meta["local_hyperparams"], j_meta["local_hyperparams"]
    assert (hyper is None) == (j_hyper is None) == (steps == "single-step")
    if hyper is not None:
        assert hyper["steps"] == j_hyper["steps"] == 2 and len(hyper["labels"]) == len(j_hyper["labels"]) == 2 * 3
        for labels, j_labels in zip(hyper["labels"], j_hyper["labels"]):
            np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_array_equal(true["data"].numpy(), np.transpose(np.asarray(j_true["data"]), (0, 3, 1, 2)))
    np.testing.assert_array_equal(true["labels"].numpy(), np.asarray(j_true["labels"]))
    assert j_user.counted_queries == user.counted_queries == 1


def test_singlestep_semantics_and_hyperparams_as_the_jax_test():
    """The JAX package's ``test_multiuser_aggregate_hyperparam_and_singlestep_semantics``
    on the port: the single-step aggregate is the mean of the sub-users' own fedSGD
    gradients; a multi-step silo shares its aggregated per-step label lists."""
    overrides = SILO[:5] + ["case.model=ConvNetSmall16", "case.user.user_range=[0, 2]", "case.user.num_data_points=2",
                            "case.user.provide_labels=True", "seed=3"]
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, _ = server.run_protocol(user)
    subs = [UserSingleStep(user.model, user.loss, loader, setup, idx, cfg.case.user)
            for idx, loader in zip(user.user_indices, user.dataloaders)]
    grads = [sub.compute_local_updates(payloads[0])[0]["gradients"] for sub in subs]
    mean = {k: ((grads[0][k] + grads[1][k]) / 2).numpy() for k in grads[0]}
    _close_trees(shared[0]["gradients"], mean)

    cfg2 = breaching.get_config(overrides + MULTI_STEP)
    setup2 = breaching.utils.system_startup(cfg=cfg2, device="cpu")
    user2, server2, _, _ = breaching.cases.construct_case(cfg2.case, setup2)
    shared2, _, _ = server2.run_protocol(user2)
    hyper = shared2[0]["metadata"]["local_hyperparams"]
    assert hyper is not None and hyper["steps"] == 2 and len(hyper["labels"]) == 2 * 2
    assert all(tuple(labels.shape) == (2,) for labels in hyper["labels"])


@pytest.mark.parametrize("steps", ["single-step", "multi-step"])
def test_train_mode_silo_matches_float64(steps):
    overrides = SILO + ["case.model=ConvNet8", "case.server.provide_public_buffers=False",
                        "case.user.provide_buffers=True"] + (MULTI_STEP if steps == "multi-step" else [])
    cfg, setup, user, server, model, j_user, j_server = _silos(overrides)
    shared, payloads, _ = server.run_protocol(user)
    model.double()
    setup64 = dict(setup, dtype=torch.float64)
    user64 = breaching.cases.construct_user(model, user.loss, cfg.case, setup64)
    payload64 = dict(payloads[0], parameters={k: v.double() for k, v in payloads[0]["parameters"].items()})
    shared64, _ = user64.compute_local_updates(payload64)
    rel, ulps = (1e-6, None) if steps == "single-step" else (1e-5, payloads[0]["parameters"])
    _close_trees(shared[0]["gradients"], {k: v.numpy() for k, v in shared64["gradients"].items()}, rel, ulps)
    _close_trees(shared[0]["buffers"], {k: v.numpy() for k, v in shared64["buffers"].items()}, rel)
    if steps == "single-step":  # the users' statistics, averaged as the gradients are
        j_shared, _, _ = j_server.run_protocol(j_user)
        _close_trees(shared[0]["buffers"], _as_port(model, _flat({}, j_shared[0]["buffers"]), "buffers/"))
