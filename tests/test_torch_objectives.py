"""Every objective of the port's ``objective_lookup`` against the JAX package's, and
``fused_euclidean`` against the JAX package's, on the CPU.

Both packages build case 1 with ConvNet-8 on CIFAR-10 shapes cut to 16x16, the port's
model on the JAX model's weights (through ``from_jax_state``), and run the same FL
exchange; each objective then takes the same candidate (numpy seed 3), with task
regularization 0 and 1. The JAX side runs op by op (no jit); its fused objectives
reach their Pallas kernels in interpret mode, as the JAX package's own tests run
them.

Tolerances (float32 on both sides, convolutions and sums in other orders): the value
1e-5 relative, plus what its matching term keeps of absolute precision. The cosine
is near 1 here (0.9989), so 1 - cos is good to some float32 ulps of the cosine: 16
ulps (9.5e-7) for the objectives built on the cosine, carried through arccos for
``angular`` (16 ulps / (pi sin(angle))). ``fused-euclidean`` forms 0.5 (|r|^2 -
2<r, d> + |d|^2), a difference of sums far larger than itself: 1e-5 of (|r|^2 +
|d|^2) / 2, as chip_smoke.py holds B1's sums. The gradient with respect to the
candidate: 1e-4 of its largest entry, as tests/test_torch_attack.py holds the
cosine's. ``fused_euclidean`` alone over two vectors of 100,003 (numpy seed 0): its
value 1e-5 relative (sums of n terms in other orders); its gradient g rec - g data
up to one rounding of a product, 2^-23 of max |g| (|rec| + |data|) (XLA may fuse
a x + b y into a multiply-add); ``fused_euclidean_plain``'s, through autograd,
2^-22 of its largest entry beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.objectives import objective_lookup as jax_objective_lookup
from breaching_tpu.ops import fused_euclidean as jax_fused_euclidean
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.objectives import objective_lookup
from breaching_tpu_torch.ops import fused_euclidean
from breaching_tpu_torch.ops.matching import fused_euclidean_plain

torch.set_num_threads(1)
CASE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
        "case.data.shape=[3, 16, 16]", "seed=0"]
# the options of the objectives that have them, as their yaml sets or a test would
OPTIONS = {"tag-euclidean": dict(tag_scale=0.1, scale_scheme="linear"),
           "masked-cosine-similarity": dict(mask_value=1e-6), "angular": dict(fudge_factor=1e-7)}


@pytest.fixture(scope="module")
def exchange():
    cfg, jax_cfg = breaching.get_config(CASE), jax_breaching.get_config(CASE)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    shared, payloads, _ = server.run_protocol(user)
    j_models, j_labels, _ = j_attacker.prepare_attack(j_payloads, j_shared)
    models, labels, _ = attacker.prepare_attack(payloads, shared)
    x = np.random.default_rng(3).normal(size=(1, 3, 16, 16)).astype(np.float32)
    return dict(j_model=j_models[0], j_labels=j_labels, j_target=j_attacker._shared_data_cache[0]["gradients"],
                j_loss=j_loss, model=models[0], labels=labels, loss=loss_fn, impl=cfg.attack.impl,
                target=tuple(attacker._shared_data_cache[0]["gradients"][k] for k in models[0].params), x=x)


def _value_tolerance(name, want, matching, target):
    """The value's tolerance; ``matching``: its matching term (without the task loss)."""
    cosine_ulps = 16 * 2.0 ** -24  # absolute precision of a float32 cosine near 1
    tol = 1e-5 * abs(want)
    if name == "angular":
        return tol + cosine_ulps / (np.pi * np.sin(np.pi * matching))
    if "cosine" in name:
        return tol + cosine_ulps
    if name == "fused-euclidean":  # |r|^2 + |d|^2 ~ 2 |d|^2 near the target
        return tol + 1e-5 * sum(float((t * t).sum()) for t in target)
    return tol


def test_the_lookups_name_the_same_objectives():
    assert set(objective_lookup) == set(jax_objective_lookup)


@pytest.mark.parametrize("task_regularization", [0.0, 1.0])
@pytest.mark.parametrize("name", sorted(jax_objective_lookup))
def test_objective_value_and_attack_gradient_match_jax(exchange, name, task_regularization):
    e = exchange
    kwargs = dict(scale=1.0, task_regularization=task_regularization, **OPTIONS.get(name, {}))
    j_objective = jax_objective_lookup[name](**kwargs)
    j_objective.initialize(e["j_loss"], e["j_model"], None, e["impl"])
    m = e["j_model"]

    def j_value(candidate):
        value, task_loss, _ = j_objective(m.params, m.buffers, e["j_target"], candidate, e["j_labels"])
        return value, task_loss

    (want, task_loss), want_grad = jax.value_and_grad(j_value, has_aux=True)(
        jnp.asarray(np.transpose(e["x"], (0, 2, 3, 1))))
    matching = float(want) - task_regularization * float(task_loss)
    want_grad = np.transpose(np.asarray(want_grad), (0, 3, 1, 2))

    objective = objective_lookup[name](**kwargs)
    objective.initialize(e["loss"], e["model"].module, None, e["impl"])
    x = torch.from_numpy(e["x"]).requires_grad_(True)
    got, _ = objective(e["model"].params, e["model"].buffers, e["target"], x, e["labels"],
                       bn_train=e["model"].bn_train)
    got_grad, = torch.autograd.grad(got, x)

    tol = _value_tolerance(name, float(want), matching, e["target"])
    assert abs(got.item() - float(want)) <= tol, (got.item(), float(want), tol)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0, atol=1e-4 * np.abs(want_grad).max())


def test_fused_euclidean_matches_jax_and_its_plain_version():
    rng = np.random.default_rng(0)
    rec_np, data_np = (rng.normal(size=100_003).astype(np.float32) for _ in range(2))
    upstream = np.float32(0.37)
    want, vjp = jax.vjp(jax_fused_euclidean, jnp.asarray(rec_np), jnp.asarray(data_np))
    want_rec, want_data = (np.asarray(g) for g in vjp(jnp.float32(upstream)))

    rec, data = (torch.from_numpy(a).requires_grad_(True) for a in (rec_np, data_np))
    got = fused_euclidean(rec, data)
    got_rec, got_data = torch.autograd.grad(got, (rec, data), torch.tensor(upstream))
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    one_rounding = 2.0 ** -23 * abs(upstream) * np.max(np.abs(rec_np) + np.abs(data_np))
    np.testing.assert_allclose(got_rec.numpy(), want_rec, rtol=0, atol=one_rounding)
    np.testing.assert_allclose(got_data.numpy(), want_data, rtol=0, atol=one_rounding)

    plain = fused_euclidean_plain(rec, data)
    plain_rec, = torch.autograd.grad(plain, rec, torch.tensor(upstream))
    assert plain.item() == got.item()
    np.testing.assert_allclose(plain_rec.numpy(), want_rec, rtol=0, atol=2.0 ** -22 * np.abs(want_rec).max())
