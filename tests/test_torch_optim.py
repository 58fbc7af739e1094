"""The port's sign, step-lr schedule and attack step tail against the JAX package's,
on the CPU.

The step tail is what the JAX attack does with a candidate's gradient
(breaching_tpu/attacks/optimization_based_attack.py:401-466): ``jnp.sign`` for
hard-signed attacks, ``optax.adam`` with the package's schedule,
``optax.apply_updates``, ``jnp.clip`` to the per-channel box and the ``jnp.where``
guards, jitted as the attack jits it. The port's counterpart is
``adam_box_step_plain``, the plain version of kernel ``b4_adam_box_step``. Inputs
come from numpy seeds. Tolerance: the same float32 operations in the same order on
both sides, but XLA fuses the jitted tail and may round one operation otherwise
(measured: one float32 ulp, 1.2e-7 on candidates of order 2), so the candidate,
moments and best iterate agree to 2^-22 of their largest entry; NaN positions and
the best value are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.optimizers import make_schedule as jax_make_schedule
from breaching_tpu.attacks.auxiliaries.optimizers import optimizer_lookup as jax_optimizer_lookup
from breaching_tpu_torch import ops
from breaching_tpu_torch.attacks.auxiliaries.optimizers import make_schedule, optimizer_lookup
from breaching_tpu_torch.ops.image import adam_box_step_plain

torch.set_num_threads(1)
ONE_ROUNDING = 2.0 ** -22
SHAPE = (2, 3, 8, 8)  # NCHW
LO = np.asarray([-1.9, -2.0, -1.7], np.float32)
HI = np.asarray([2.1, 2.1, 2.0], np.float32)


def test_sign_matches_jnp_sign():
    x = np.asarray([np.nan, -0.0, 0.0, 2.0, -3.0, np.inf], np.float32)
    want = np.asarray(jnp.sign(jnp.asarray(x)))
    got = ops.sign(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 24_000])
def test_step_lr_schedule_matches_jax(n):
    steps = np.arange(n)
    want = np.asarray(jax_make_schedule(0.1, "step-lr", 0, n)(jnp.asarray(steps)), np.float32)
    schedule = make_schedule(0.1, "step-lr", 0, n)
    got = np.asarray([schedule(int(step)) for step in steps], np.float32)
    np.testing.assert_array_equal(got, want)


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


def _run_both(signed, grads, values, x0, max_iterations):
    """Both step tails over the given gradients (NCHW) and loss values; the states
    after every step as numpy NCHW arrays."""
    optimizer, _ = jax_optimizer_lookup("adam", 0.1, "step-lr", 0, max_iterations)
    tail = _jax_tail(optimizer, signed)
    j_x, j_best, j_best_val = _nhwc(x0), _nhwc(x0), jnp.float32(np.inf)
    j_state = optimizer.init(j_x)

    adam = optimizer_lookup("adam", 0.1, "step-lr", 0, max_iterations)
    x = torch.from_numpy(x0.copy())
    state, best = adam.init(x), x.clone()
    best_vals = [torch.tensor(np.inf), torch.empty(())]
    lo, hi = torch.from_numpy(LO), torch.from_numpy(HI)
    for grad, value in zip(grads, values):
        j_x, j_state, j_best, j_best_val = tail(j_x, _nhwc(grad), j_state, j_best, j_best_val,
                                                jnp.float32(value))
        adam_box_step_plain(x, torch.from_numpy(grad), state["mu"], state["nu"], best, lo, hi,
                            torch.tensor(value), *best_vals, adam.advance(state), signed=signed)
        best_vals.reverse()
        mu, nu = j_state[0].mu, j_state[0].nu
        yield (dict(x=x.numpy().copy(), mu=state["mu"].numpy().copy(), nu=state["nu"].numpy().copy(),
                    best=best.numpy().copy(), best_val=best_vals[0].item()),
               dict(x=_nchw(j_x), mu=_nchw(mu), nu=_nchw(nu), best=_nchw(j_best), best_val=float(j_best_val)))


def _assert_states_agree(got, want, where):
    for key in ("x", "mu", "nu", "best"):
        g, w = got[key], want[key]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{key} NaN positions {where}")
        scale = np.nanmax(np.abs(w)) if np.isfinite(w).any() else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=ONE_ROUNDING * scale, err_msg=f"{key} {where}")
    assert got["best_val"] == want["best_val"], where


def test_hard_signed_step_with_a_nan_gradient_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    grad = rng.normal(size=SHAPE).astype(np.float32)
    grad[0, 1, 2, 3] = grad[1, 2, 7, 0] = np.nan
    grad[0, 0, 0, 0] = -0.0
    (got, want), = _run_both(True, [grad], [0.5], x0, 10)
    assert np.isnan(want["x"]).sum() == 2
    _assert_states_agree(got, want, "after one step")


@pytest.mark.parametrize("signed", [True, False])
def test_adam_box_step_plain_matches_jax_step_tail(signed):
    # 10 steps cross all three step-lr boundaries (3, 6 and 8); step 4's loss is NaN
    # (the candidate stays) and step 7's is infinite; the others rise and fall, so
    # the best iterate is taken at some steps and kept at others
    rng = np.random.default_rng(1)
    x0 = (rng.normal(size=SHAPE) * 1.5).astype(np.float32)
    grads = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(10)]
    values = [0.9, 0.7, 0.8, 0.5, np.nan, 0.6, 0.4, np.inf, 0.45, 0.3]
    states = list(_run_both(signed, grads, values, x0, 10))
    for step, (got, want) in enumerate(states):
        _assert_states_agree(got, want, f"after step {step}")
    for step in (4, 7):  # a non-finite loss leaves the candidate where it was
        np.testing.assert_array_equal(states[step][0]["x"], states[step - 1][0]["x"])
    assert states[-1][0]["best_val"] == np.float32(0.3)
