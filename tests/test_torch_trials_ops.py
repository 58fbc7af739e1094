"""The trials forms of the fused kernels' plain versions against the JAX package, on the
CPU: ``fused_cosine_similarity_trials`` (B1 per trial into one (T, 3) tensor, then the
cosine backward of every row at once) against ``jax.vmap`` of ``jax.vjp`` of the JAX
package's ``fused_cosine_similarity``, whose Pallas kernels run in interpret mode as
tests/test_ops.py runs them; ``adam_box_step_trials`` against the JAX attack's step
tail applied to each trial; ``FusedEuclidean`` under the batched trial step; and the
wrappers' refusals on the CPU. The kernels themselves are held against these plain
versions on the card in tests/test_torch_kernels.py.

Inputs come from numpy seeds and reach both sides as the same float32 arrays.
Tolerances, each with its reason:
- the cosine's value and gradients: 1e-5 of the largest |value| (sums over n float32
  terms in two orders, then the same arithmetic), as
  ``test_fused_cosine_value_and_gradients_match_pallas``;
- the Adam step tail: the same float32 operations in the same order on both sides,
  but XLA fuses the jitted tail and may round one operation otherwise, so 2^-22 of each
  tensor's largest entry; NaN positions and the best values exactly, as
  ``test_adam_box_step_plain_matches_jax_step_tail``;
- a row of a trials form against its own single call, and ``FusedEuclidean``'s trials
  against its per-trial route: the same operations on the same numbers, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.optimizers import optimizer_lookup as jax_optimizer_lookup
from breaching_tpu.ops import fused_cosine_similarity as jax_fused_cosine
from breaching_tpu_torch import ops
from breaching_tpu_torch.attacks.auxiliaries.objectives import GradientLoss, objective_lookup
from breaching_tpu_torch.attacks.auxiliaries.optimizers import optimizer_lookup
from breaching_tpu_torch.ops import matching

torch.set_num_threads(1)
ONE_ROUNDING = 2.0 ** -22
LO = np.asarray([-1.9, -2.0, -1.7], np.float32)
HI = np.asarray([2.1, 2.1, 2.0], np.float32)


def _rows(trials, n, seed):
    return np.random.default_rng(seed).normal(size=(trials, n)).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("n", [5000, 7001])
def test_fused_cosine_similarity_trials_match_vmapped_pallas(n):
    r, d = _rows(3, n, 20), _rows(3, n, 21)
    g = np.asarray([0.37, -1.2, 2.5], np.float32)

    def value_and_vjp(rec, data, upstream):
        value, vjp = jax.vjp(jax_fused_cosine, rec, data)
        return (value, *vjp(upstream))

    want, want_r, want_d = jax.vmap(value_and_vjp)(jnp.asarray(r), jnp.asarray(d), jnp.asarray(g))
    rt, dt = torch.from_numpy(r).requires_grad_(True), torch.from_numpy(d).requires_grad_(True)
    values = ops.fused_cosine_similarity_trials(rt, dt)
    got_r, got_d = torch.autograd.grad(values, (rt, dt), torch.from_numpy(g))
    assert values.shape == (3,)
    _close(values.detach(), want, 1e-5)
    _close(got_r, want_r, 1e-5)
    _close(got_d, want_d, 1e-5)


def test_fused_cosine_similarity_trials_rows_equal_single_calls():
    r, d = torch.from_numpy(_rows(3, 1001, 22)), torch.from_numpy(_rows(3, 1001, 23))
    rec = r.clone().requires_grad_(True)
    values = ops.fused_cosine_similarity_trials(rec, d)
    grad, = torch.autograd.grad(values.sum(), rec)
    for t in range(3):
        row = r[t].clone().requires_grad_(True)
        value = ops.fused_cosine_similarity(row, d[t])
        want, = torch.autograd.grad(value, row)
        assert torch.equal(values[t].detach(), value.detach()) and torch.equal(grad[t], want), t


@pytest.mark.parametrize("data_requires_grad", [False, True])
def test_fused_cosine_similarity_trials_compute_the_data_gradient_only_when_needed(monkeypatch,
                                                                                   data_requires_grad):
    calls = []
    monkeypatch.setattr(matching, "cosine_backward",
                        lambda *args, **kwargs: calls.append(1) or matching.cosine_backward_plain(*args, **kwargs))
    r = torch.from_numpy(_rows(3, 100, 24)).requires_grad_(True)
    d = torch.from_numpy(_rows(3, 100, 25)).requires_grad_(data_requires_grad)
    torch.autograd.grad(ops.fused_cosine_similarity_trials(r, d).sum(), (r, d) if data_requires_grad else (r,))
    assert len(calls) == (2 if data_requires_grad else 1)


def _jax_tail(optimizer, signed):
    """The JAX attack's step tail for one candidate (NHWC), as the attack writes it."""

    @jax.jit
    def tail(candidate, grad, opt_state, best, best_val, value):
        if signed:
            grad = jnp.sign(grad)
        updates, opt_state = optimizer.update(grad, opt_state, candidate)
        new = optax.apply_updates(candidate, updates)
        new = jnp.clip(new, jnp.asarray(LO), jnp.asarray(HI))
        finite = jnp.isfinite(value)
        new = jnp.where(finite, new, candidate)
        improved = jnp.logical_and(finite, value < best_val)
        best = jnp.where(improved, candidate, best)
        best_val = jnp.where(improved, value, best_val)
        return new, opt_state, best, best_val

    return tail


def _nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.mark.parametrize("signed", [True, False])
def test_adam_box_step_trials_plain_matches_jax_step_tail(signed):
    # three trials of a (3, 1, 3, 8, 8) stack over 6 steps, which cross the step-lr
    # boundaries; each trial has its own losses: NaN and infinite ones (the candidate
    # stays), rising and falling ones (the best iterate taken at some steps, kept at others)
    trials, steps, shape = 3, 6, (3, 1, 3, 8, 8)
    rng = np.random.default_rng(26)
    x0 = (rng.normal(size=shape) * 1.5).astype(np.float32)
    grads = [rng.normal(size=shape).astype(np.float32) for _ in range(steps)]
    grads[1][0, 0, 1, 2, 3] = np.nan
    values = np.asarray([[0.9, np.nan, 0.7, np.inf, 0.5, 0.6],
                         [0.5, 0.6, 0.4, 0.45, 0.3, 0.2],
                         [np.inf, 0.8, np.nan, 0.2, 0.25, 0.1]], np.float32)

    optimizer, _ = jax_optimizer_lookup("adam", 0.1, "step-lr", 0, steps)
    tail = _jax_tail(optimizer, signed)
    jax_trials = [dict(x=_nhwc(x0[t]), best=_nhwc(x0[t]), best_val=jnp.float32(np.inf),
                       state=optimizer.init(_nhwc(x0[t]))) for t in range(trials)]

    adam = optimizer_lookup("adam", 0.1, "step-lr", 0, steps)
    x = torch.from_numpy(x0.copy())
    state, best = adam.init(x), x.clone()
    best_vals = [torch.full((trials,), np.inf), torch.empty(trials)]
    lo, hi = torch.from_numpy(LO), torch.from_numpy(HI)
    for k in range(steps):
        ops.adam_box_step_trials(x, torch.from_numpy(grads[k]), state["mu"], state["nu"], best, lo, hi,
                                 torch.from_numpy(values[:, k]), *best_vals, adam.advance(state), signed=signed)
        best_vals.reverse()
        for t, j in enumerate(jax_trials):
            j["x"], j["state"], j["best"], j["best_val"] = tail(j["x"], _nhwc(grads[k][t]), j["state"], j["best"],
                                                                j["best_val"], jnp.float32(values[t, k]))
            got = dict(x=x[t].numpy(), mu=state["mu"][t].numpy(), nu=state["nu"][t].numpy(), best=best[t].numpy())
            want = dict(x=_nchw(j["x"]), mu=_nchw(j["state"][0].mu), nu=_nchw(j["state"][0].nu),
                        best=_nchw(j["best"]))
            for key in got:
                g, w = got[key], want[key]
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{key} NaN, step {k} trial {t}")
                scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 0.0
                np.testing.assert_allclose(g, w, rtol=0, atol=ONE_ROUNDING * scale, err_msg=f"{key} step {k} trial {t}")
            assert best_vals[0][t].item() == float(j["best_val"]), (k, t)
    assert best_vals[0].tolist() == [np.float32(0.5), np.float32(0.2), np.float32(0.1)]


def test_adam_box_step_trials_equal_single_calls_on_the_cpu():
    rng = np.random.default_rng(27)
    start = {k: torch.from_numpy(rng.normal(size=(3, 2, 3, 5, 7)).astype(np.float32))
             for k in ("x", "grad", "mu", "nu", "best")}
    start["nu"] = start["nu"] ** 2
    values, best_vals = torch.tensor([0.4, float("nan"), 0.7]), torch.tensor([0.5, 0.5, 0.5])
    lo, hi = torch.from_numpy(LO), torch.from_numpy(HI)
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=0.1, bias2=0.001)
    got = {k: v.clone() for k, v in start.items()}
    got_best = torch.empty(3)
    ops.adam_box_step_trials(got["x"], got["grad"], got["mu"], got["nu"], got["best"], lo, hi, values, best_vals,
                             got_best, step, signed="soft", soft_scale=ops.soft_sign_scalars(3, 10))
    for t in range(3):
        single = {k: v[t].clone() for k, v in start.items()}
        single_best = torch.empty(())
        ops.adam_box_step(single["x"], single["grad"], single["mu"], single["nu"], single["best"], lo, hi,
                          values[t], best_vals[t], single_best, step, signed="soft",
                          soft_scale=ops.soft_sign_scalars(3, 10))
        for key in ("x", "mu", "nu", "best"):
            assert torch.equal(got[key][t], single[key]), (t, key)
        assert torch.equal(got_best[t], single_best)
    assert torch.equal(got_best, torch.tensor([0.4, 0.5, 0.5]))


def _fused_euclidean(trials):
    objective = objective_lookup["fused-euclidean"](scale=0.5)
    rng = np.random.default_rng(28)
    shapes = [(trials, 4, 3), (trials, 5), (trials, 2, 2, 3)]
    targets = tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes)
    steps = [tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes) for _ in range(3)]
    return objective, targets, steps


def test_fused_euclidean_flattens_its_target_once_under_trials():
    # three steps of the batched trial step against one target: the flattened target is
    # built at the first step and kept; each step's values equal the per-trial route's
    objective, targets, steps = _fused_euclidean(3)
    got, flats = [], []
    for grads in steps:
        got.append(objective.trial_distances(grads, targets))
        flats.append(objective._flat)
    assert all(flat is flats[0] for flat in flats[1:])
    assert flats[0].shape == (3, 12 + 5 + 12)
    for grads, values in zip(steps, got):
        assert values.shape == (3,)
        assert torch.equal(values, GradientLoss.trial_distances(objective, grads, targets))


def test_fused_euclidean_trials_take_their_gradient_through_each_row():
    objective, targets, steps = _fused_euclidean(2)
    grads = tuple(g.clone().requires_grad_(True) for g in steps[0])
    got = torch.autograd.grad(objective.trial_distances(grads, targets).sum(), grads)
    plain = tuple(g.clone().requires_grad_(True) for g in steps[0])
    want = torch.autograd.grad(sum(0.5 * 0.5 * ((g - t) ** 2).sum() for g, t in zip(plain, targets)), plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=ONE_ROUNDING * w.abs().max().item())


def _refusals():
    """(call, what it gets wrong) of every wrapper on the CPU."""
    x, meta = torch.zeros(2, 1, 3, 4, 4), torch.zeros(2, 1, 3, 4, 4, device="meta")
    lo, hi = torch.zeros(3), torch.ones(3)
    vals = [torch.zeros(2), torch.ones(2), torch.empty(2)]
    step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
    r = torch.zeros(2, 8)
    sums = torch.zeros(2, 3)

    def adam(*tensors):
        return lambda: ops.adam_box_step_trials(*tensors, step)

    return {
        "adam trials on two devices": adam(x, meta, x.clone(), x.clone(), x.clone(), lo, hi, *vals),
        "adam trials of too few values": adam(x, x.clone(), x.clone(), x.clone(), x.clone(), lo, hi, vals[0][:1],
                                             *vals[1:]),
        "adam trials of a 4-D candidate": adam(x[0], x[0].clone(), x[0].clone(), x[0].clone(), x[0].clone(), lo, hi,
                                               *vals),
        "adam trials of one best-value buffer": adam(x, x.clone(), x.clone(), x.clone(), x.clone(), lo, hi, vals[0],
                                                     vals[1], vals[1]),
        "adam of a gradient of another shape": lambda: ops.adam_box_step(
            x[0], x[0, :, :2].clone(), x[0].clone(), x[0].clone(), x[0].clone(), lo, hi, *(v[0] for v in vals), step),
        "adam with a soft sign and no scalars": lambda: ops.adam_box_step(
            x[0], *(x[0].clone() for _ in range(4)), lo, hi, *(v[0] for v in vals), step, signed="soft"),
        "cosine rows on two devices": lambda: matching.cosine_backward(sums, torch.zeros(2), r,
                                                                       torch.zeros(2, 8, device="meta")),
        "cosine rows with g of the wrong length": lambda: matching.cosine_backward(sums, torch.zeros(3), r, r.clone()),
        "cosine rows with flat sums": lambda: matching.cosine_backward(sums[0], torch.zeros(2), r, r.clone()),
        "cosine trials of flat vectors": lambda: ops.fused_cosine_similarity_trials(r[0], r[1]),
        "matching sums into an out of 4": lambda: ops.matching_sums(r[0], r[1], out=torch.empty(4)),
        "matching sums into an out on another device": lambda: ops.matching_sums(
            r[0], r[1], out=torch.empty(3, device="meta")),
        "box into an out on another device": lambda: ops.box_project(x[0], lo, hi, out=meta[0]),
        "tv forward of a meta batch": lambda: ops.tv_forward(meta[0]),
    }


@pytest.mark.parametrize("name", list(_refusals()))
def test_cpu_wrappers_refuse_mixed_devices_and_wrong_shapes(name):
    with pytest.raises(ValueError):
        _refusals()[name]()
