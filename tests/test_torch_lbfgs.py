"""The port's L-BFGS (``optimizers.LBFGS``) against the JAX package's
``_torch_like_lbfgs``, on the CPU.

Three problems, each from a numpy seed:
- a convex quadratic 0.5 (x - c)^T A (x - c) of 50 variables (eigenvalues of A from
  0.01 to 1), 4 outer steps at step size 1: every trial step is accepted, the history
  of curvature pairs fills, and the run converges within the third outer step;
- the same quadratic with an infinite loss outside a ball that holds the start but
  not the minimum, 4 outer steps: trial steps past the ball are rejected and the
  step scale is quartered, then doubled after each accepted step (the backtracking
  branch);
- 2 and 3 outer steps of the ``wei`` preset (boxed L-BFGS, euclidean matching with
  task regularization, ``patterned-16`` init) on ConvNet-8 at 16x16 through both
  packages' ``reconstruct``, from the JAX package's initial candidate.

The JAX package masks the inner iterations after a break where the port stops; both
count the steps taken (``n_iter``) and the step scale. Tolerances: the parameters
after each outer step 1e-4 of their largest entry on the quadratics (float32 sums of
50 terms in other orders, carried through up to 20 inner steps) [measured 1.8e-5];
the steps taken equal after each outer step of the unconstrained run, and the steps
and step scale equal after the first outer step of the constrained one. Once the
iterate rests on the ball's edge, whether a trial step falls a rounding inside it
decides the backtracking, so from there the two runs' step counts and scales part
(by one or two steps; the parameters stay within the tolerance). On ConvNet-8,
whose matching gradient passes a double backward: every loss of the trajectory
1e-3 relative [1.0e-4]; after 2 outer steps the reconstruction (the best iterate,
the candidate after the first outer step) with at most 1% of its pixels 1e-3 apart,
as tests/test_torch_attack.py holds hard-signed Adam [none; 5.8e-5 at most]. After 3,
the best iterate is the candidate after 40 unit-size inner steps across a loss that
barely moves (2.3339 to 2.3327, mostly the task loss), and the two packages'
rounding, carried through them, parts the candidates by up to 0.45 (median 0.04) while
the losses stay within 1.0e-4: there the losses alone are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.optimizers import optimizer_lookup as jax_optimizer_lookup
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.optimizers import LBFGS, optimizer_lookup

torch.set_num_threads(1)
N, CONDITION, RADIUS = 50, 100.0, 3.0


def _quadratic(radius=None):
    """0.5 (x - c)^T A (x - c), which falls to 0 at its minimum c; infinite outside the
    ball of ``radius`` about 0 if given."""
    rng = np.random.default_rng(4)
    q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    a = (q * np.geomspace(1.0 / CONDITION, 1.0, N)) @ q.T
    a = ((a + a.T) / 2).astype(np.float32)
    c = rng.normal(size=N).astype(np.float32)
    x0 = (0.1 * rng.normal(size=N)).astype(np.float32)

    def jax_f(x):
        r = x - jnp.asarray(c)
        value = 0.5 * r @ (jnp.asarray(a) @ r)
        return value if radius is None else jnp.where(x @ x < radius ** 2, value, jnp.inf)

    def torch_f(x):
        r = x - torch.from_numpy(c)
        value = 0.5 * r @ (torch.from_numpy(a) @ r)
        return value if radius is None else torch.where(x @ x < radius ** 2, value, torch.tensor(float("inf")))

    return jax_f, torch_f, x0, c


def _run_both(jax_f, torch_f, x0, outer_steps):
    optimizer, needs_value_fn = jax_optimizer_lookup("l-bfgs", 1.0, None, 0, outer_steps)
    assert needs_value_fn
    x, state = jnp.asarray(x0), None
    state = optimizer.init(x)
    port = optimizer_lookup("l-bfgs", 1.0, None, 0, outer_steps)
    assert isinstance(port, LBFGS)
    xt = torch.from_numpy(x0.copy())
    port_state = port.init(xt)
    evaluations = [0]

    def closure(p):
        p = p.detach().requires_grad_(True)
        value = torch_f(p)
        grad, = torch.autograd.grad(value, p)
        evaluations[0] += 1
        return value.detach(), grad

    for _ in range(outer_steps):
        value, grad = jax.value_and_grad(jax_f)(x)
        updates, state = optimizer.update(grad, state, x, value=value, grad=grad, value_fn=jax_f)
        x = x + updates
        t_value, t_grad = closure(xt)
        final = port.update(xt, t_grad, t_value, closure, port_state)
        xt = xt + (final - xt)
        yield (np.asarray(x), int(state["n_iter"]), float(state["t_scale"]),
               xt.numpy().copy(), port_state["n_iter"], float(port_state["t_scale"]), evaluations[0])


@pytest.mark.parametrize("radius", [None, RADIUS], ids=["quadratic", "infinite-past-a-radius"])
def test_lbfgs_matches_jax_on_a_quadratic(radius):
    jax_f, torch_f, x0, minimum = _quadratic(radius)
    if radius is not None:
        assert np.linalg.norm(x0) < radius < np.linalg.norm(minimum)
    for step, (want, want_iters, want_scale, got, got_iters, got_scale, evals) in enumerate(
            _run_both(jax_f, torch_f, x0, 4)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=f"step {step}")
        if radius is None or step == 0:
            assert (got_iters, got_scale) == (want_iters, want_scale), step
        assert evals <= (step + 1) * 21  # one evaluation per outer step and at most 20 trial steps
        if step == 0:
            first_scale = got_scale
    if radius is None:
        assert first_scale == 1.0
        np.testing.assert_allclose(got, minimum, rtol=0, atol=1e-3 * np.abs(minimum).max())
    else:  # backtracked, and stopped inside the ball, at its edge
        assert first_scale < 1.0 and radius * (1 - 1e-3) < np.linalg.norm(got) < radius


@pytest.mark.parametrize("outer_steps", [2, 3])
def test_lbfgs_attack_steps_match_jax_on_convnet(outer_steps):
    overrides = ["case=1_single_image_small", "attack=wei", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]",
                 f"attack.optim.max_iterations={outer_steps}", "attack.optim.callback=1", "seed=0"]
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    shared, payloads, _ = server.run_protocol(user)
    # the JAX package's patterned-16 initial candidate, given to both
    j_attacker.prepare_attack(j_payloads, j_shared)
    x_nhwc = np.asarray(j_attacker._init_candidate_tree(1, jax.random.PRNGKey(5), None)["data"])
    j_rec, j_stats = j_attacker.reconstruct(j_payloads, j_shared, initial_data=x_nhwc)
    rec, stats = attacker.reconstruct(payloads, shared, initial_data=torch.from_numpy(
        np.transpose(x_nhwc, (0, 3, 1, 2)).copy()))
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == outer_steps and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert outer_steps < stats["objective_evaluations"] <= outer_steps * 21
    if outer_steps == 3:
        return
    differing = np.abs(rec["data"].numpy() - np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
