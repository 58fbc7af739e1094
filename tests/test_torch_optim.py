"""The port's sign, schedules, optimizers, gradient transforms and attack step tail
against the JAX package's, on the CPU.

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
from breaching_tpu_torch.attacks.auxiliaries.optimizers import Adam, LBFGS, make_schedule, optimizer_lookup
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


# ---------------------------------------------------------------- schedules and optimizers
#
# Every schedule, with and without a warmup, against the JAX package's make_schedule at
# every step, evaluated eagerly and jitted (as the attack runs it). Tolerance: bit for
# bit against the eager evaluation, whose float32 operations the port repeats, except
# the cosine (numpy's and XLA's own): 2 float32 ulps of the step size; and 2 ulps of
# the jitted one, which XLA's compiler rearranges (its divisions and products round
# otherwise in the last place for linear, cosine and the warmup ramp).

@pytest.mark.parametrize("warmup", [0, 2, 50])
@pytest.mark.parametrize("decay", [None, "step-lr", "cosine-decay", "linear"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 300, 24_000])
def test_every_schedule_matches_jax(n, decay, warmup):
    steps = jnp.asarray(np.arange(n + warmup))
    jax_schedule = jax_make_schedule(0.1, decay, warmup, n)
    eager, jitted = (np.broadcast_to(np.asarray(f(steps), np.float32), steps.shape)
                     for f in (jax_schedule, jax.jit(jax_schedule)))
    schedule = make_schedule(0.1, decay, warmup, n)
    got = np.asarray([schedule(int(step)) for step in steps], np.float32)
    two_ulps = 2 * np.spacing(np.float32(0.1))
    if decay == "cosine-decay":
        np.testing.assert_allclose(got, eager, rtol=0, atol=two_ulps)
    else:
        np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=two_ulps)


def test_warmup_evaluates_the_main_schedule_at_the_shifted_step():
    # optax.join_schedules hands the main schedule step - warmup (JAX package finding)
    schedule = make_schedule(0.1, "cosine-decay", 50, 300)
    plain = make_schedule(0.1, "cosine-decay", 0, 300)
    assert schedule(0) == 0.0 and schedule(25) == pytest.approx(0.05)
    assert [schedule(50 + k) for k in (0, 100, 250)] == [plain(k) for k in (0, 100, 250)]


# Each first-order optimizer against optax over 10 steps of numpy-seeded gradients,
# with a cosine-decay schedule and a warmup of 3; Adam and adam-safe through the plain
# version of the kernel's step (unsigned, unboxed), the others through
# FirstOrder.update. Tolerance as the step tail above: 2^-22 of the largest entry.

def _optax_steps(name, grads, x0, max_iterations=10):
    optimizer, _ = jax_optimizer_lookup(name, 0.1, "cosine-decay", 3, max_iterations)
    x = jnp.asarray(x0)
    state = optimizer.init(x)
    for grad in grads:
        updates, state = optimizer.update(jnp.asarray(grad), state, x)
        x = optax.apply_updates(x, updates)
        yield np.asarray(x)


def _port_steps(name, grads, x0, max_iterations=10):
    optimizer = optimizer_lookup(name, 0.1, "cosine-decay", 3, max_iterations)
    x = torch.from_numpy(x0.copy())
    state = optimizer.init(x)
    if isinstance(optimizer, Adam):
        best, vals = x.clone(), [torch.tensor(np.inf), torch.empty(())]
        lo, hi = torch.zeros(x.shape[1]), torch.zeros(x.shape[1])
    for grad in grads:
        grad = torch.from_numpy(grad)
        if isinstance(optimizer, Adam):
            adam_box_step_plain(x, grad, state["mu"], state["nu"], best, lo, hi, torch.tensor(0.5), *vals,
                                optimizer.advance(state), signed=False, boxed=False)
            vals.reverse()
        else:
            x = optimizer.update(grad, state, x)
        yield x.numpy().copy()


@pytest.mark.parametrize("name", ["adam", "adam-safe", "bert-adam", "momgd", "gd"])
def test_each_optimizer_matches_optax_over_10_steps(name):
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    grads = [rng.normal(size=SHAPE).astype(np.float32) for _ in range(10)]
    steps = zip(_port_steps(name, grads, x0), _optax_steps(name, [_nhwc(g) for g in grads], _nhwc(x0)))
    for step, (got, want) in enumerate(steps):
        want = _nchw(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=ONE_ROUNDING * np.abs(want).max(),
                                   err_msg=f"{name} step {step}")
    assert not np.array_equal(got, x0)


def test_lbfgs_and_unknown_optimizers_are_routed():
    assert isinstance(optimizer_lookup("L-BFGS", 1.0), LBFGS)
    assert isinstance(optimizer_lookup("adam-safe", 1.0), Adam)
    with pytest.raises(NotImplementedError):
        optimizer_lookup("rmsprop", 1.0)


# ---------------------------------------------------------------- gradient transforms
#
# The JAX package's transform_grads lives inside its attack loop. Both packages build
# case 1 with ConvNet-8 at 16x16 on the same weights and attack from the same
# candidate with `gd` at step size 0, so the candidate stays where it is and every
# step sees the same raw gradient. The JAX attack's optimizer is wrapped to hand the
# gradient it receives, the transformed one, to the host (jax.debug.callback) with
# its step count. One run without transforms gives the raw gradient, and the port's
# transform_grads is applied to it. Langevin noise needs a step size: its run takes
# 1e-3, its step 0 sees the same raw gradient, and the noise is injected into both
# packages (jax.random.normal in the JAX attack, the port attacker's _noise).
# Tolerance: tanh and the clip's square root of a sum are each package's own: 4
# float32 ulps of the largest entry.

TRANSFORM_CASE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
                  "case.data.shape=[3, 16, 16]", "attack.optim.optimizer=gd", "attack.optim.step_size=0.0",
                  "attack.optim.signed=False", "attack.optim.max_iterations=3", "attack.optim.callback=3", "seed=0"]


def _jax_received_gradients(overrides, monkeypatch, noise=None):
    import breaching_tpu as jax_breaching
    import breaching_tpu.attacks.optimization_based_attack as jax_attack_module

    cfg = jax_breaching.get_config(TRANSFORM_CASE + overrides)
    setup = jax_breaching.utils.system_startup(cfg=cfg)
    user, server, model, _ = jax_breaching.cases.construct_case(cfg.case, setup)
    received = {}
    real_lookup = jax_attack_module.optimizer_lookup

    def lookup(*args, **kwargs):
        optimizer, needs_value_fn = real_lookup(*args, **kwargs)

        def update(updates, state, params=None, **extra):
            count = [leaf for leaf in jax.tree_util.tree_leaves(state) if leaf.dtype == jnp.int32][0]
            jax.debug.callback(lambda g, k: received.setdefault(int(k), np.asarray(g)), updates["data"], count)
            return optimizer.update(updates, state, params, **extra)

        return optax.GradientTransformation(optimizer.init, update), needs_value_fn

    monkeypatch.setattr(jax_attack_module, "optimizer_lookup", lookup)
    if noise is not None:
        real_normal = jax.random.normal
        monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                            jnp.asarray(noise, dtype) if tuple(shape) == noise.shape else real_normal(key, shape, dtype))
    attacker = jax_breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    x = (0.5 * np.random.default_rng(3).normal(size=(1, 16, 16, 3))).astype(np.float32)
    attacker.reconstruct(payloads, shared, initial_data=x)
    monkeypatch.undo()
    return {k: _nchw(g[None])[0] if g.ndim == 3 else _nchw(g) for k, g in received.items()}


def _port_attacker(overrides):
    import breaching_tpu_torch as breaching

    cfg = breaching.get_config(TRANSFORM_CASE + overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    _, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    return breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)


@pytest.fixture(scope="module")
def raw_gradient():
    mp = pytest.MonkeyPatch()
    received = _jax_received_gradients([], mp)
    assert sorted(received) == [0, 1, 2]
    assert all(np.array_equal(received[0], g) for g in received.values())  # the candidate stays
    return received[0]


@pytest.mark.parametrize("overrides", [["attack.optim.signed=soft"], ["attack.optim.grad_clip=1e-3"],
                                       ["attack.optim.grad_clip=1e-3", "attack.optim.signed=soft"],
                                       ["attack.optim.grad_clip=10.0", "attack.optim.signed=hard"]],
                         ids=["soft", "clip", "clip-soft", "no-clip-hard"])
def test_transforms_match_jax(raw_gradient, overrides, monkeypatch):
    received = _jax_received_gradients(overrides, monkeypatch)
    attacker = _port_attacker(overrides)
    for iteration in range(3):
        want = received[iteration]
        got = attacker.transform_grads(torch.from_numpy(raw_gradient.copy()), iteration, 3).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.abs(want).max()),
                                   err_msg=f"iteration {iteration}")
    if overrides == ["attack.optim.grad_clip=1e-3"]:  # clipped to 1e-3 |g| / (|g| + 1e-6)
        norm = np.linalg.norm(raw_gradient)
        assert norm > 1e-3 and np.linalg.norm(got) == pytest.approx(1e-3 * norm / (norm + 1e-6), rel=1e-5)


def test_langevin_noise_matches_jax_with_the_noise_injected(raw_gradient, monkeypatch):
    overrides = ["attack.optim.langevin_noise=0.5", "attack.optim.step_size=1e-3"]
    noise = np.random.default_rng(9).normal(size=(1, 16, 16, 3)).astype(np.float32)
    received = _jax_received_gradients(overrides, monkeypatch, noise=noise)
    attacker = _port_attacker(overrides)
    attacker._noise = lambda like: torch.from_numpy(_nchw(noise).copy())
    got = attacker.transform_grads(torch.from_numpy(raw_gradient.copy()), 0, 3).numpy()
    np.testing.assert_allclose(got, received[0], rtol=0, atol=4 * np.spacing(np.abs(received[0]).max()))
    assert not np.allclose(got, raw_gradient)


def test_langevin_noise_statistics():
    """The port's own noise: langevin x step size times a standard normal draw, fresh at
    every step. Over 300,000 entries the mean lies within 5 standard errors of 0 and
    the standard deviation within 1% of langevin x step size."""
    attacker = _port_attacker(["attack.optim.langevin_noise=0.5", "attack.optim.step_size=0.1"])
    zeros = torch.zeros(100, 3, 32, 32)
    first, second = (attacker.transform_grads(zeros, 0, 3) for _ in range(2))
    scale = 0.5 * 0.1
    for draw in (first, second):
        assert abs(draw.mean().item()) <= 5 * scale / np.sqrt(draw.numel())
        assert draw.std().item() == pytest.approx(scale, rel=1e-2)
    assert not torch.equal(first, second)
