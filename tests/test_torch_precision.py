"""The attack's precision knobs in the port against the JAX package, on the CPU, with
ConvNet-8 at 3x16x16 on both packages' same weights (through the bridge) and data:

- ``attack.impl.dtype`` bfloat16 and float16 cast the simulated user pass (parameters,
  buffers, candidate) to that type; the logits go to float32 before the loss and every
  distance accumulates in float32. The loss and its gradient at one candidate are held
  to the JAX package's in the same type, and to the port's own float32 run: bfloat16
  [measured: value 1.5e-3 relative and gradient 1.2e-3 of its largest entry from the JAX
  package, 5.3e-4 and 1.0e-3 from float32] within 1e-2 of each; float16 [1e-6 and 1.1e-4
  from the JAX package, 4.2e-7 and 1.3e-4 from float32] within 1e-3 of each. bfloat16
  rounds each sum and product at 2^-8 relative, float16 at 2^-11, and the two packages
  round at other places (XLA fuses; PyTorch rounds after every operation). The fused
  cosine (B1 on a bfloat16 gradient beside a float32 target, and B2's cosine backward
  writing the cotangent in bfloat16) is held to the JAX package's plain cosine in
  bfloat16, since the JAX package's own fused cosine fails there (ROADMAP Queue C).
- ``attack.impl.dtype=float64`` casts nothing: the run equals the float32 one bit for bit.
- ``case.impl.dtype=float64`` on LeNet (no BatchNorm, whose JAX statistics stay float32):
  model, exchange, targets and candidate in float64. The port's loss and gradient are held
  to the JAX package's attack objective within 1e-6 [2.4e-8 and 4.4e-7]: under x64 the JAX
  objective rounds the logits to float32 before the loss (objectives.py:159) and LeNet's
  JAX parameters stay float32; and to a float64 evaluation of the same objective written
  here in JAX (the model's apply on float64 parameters, ``jax.grad``, the cosine and the
  JAX package's TV, all in float64, on the JAX package's exchange, which the port's
  objective takes too) within 1e-12 relative [2.1e-15 and 1.5e-14]. The JAX package's
  x64 flag is restored after each test (a fixture).
- ``case.impl.dtype=bfloat16``: a bfloat16 candidate and targets beside the float32
  model, whose gradients stay float32 (JAX's promotion of a bfloat16 candidate through
  float32 parameters), and a bfloat16 candidate gradient; held to the JAX package's loss
  and gradient at the same bfloat16 candidate within 1e-2 [4.6e-3 and 3.6e-3].
- the bfloat16 attack's first 3 unsigned steps against the JAX package's, losses within
  1e-2 relative; its candidate and best iterate stay float32 (as
  tests/test_bf16_attack.py pins for the JAX package).
- ``attack.impl.mixed_precision``: XLA on the CPU ignores the matmul precision, so the
  JAX package cannot be the yardstick (ROADMAP Queue C). The port's run is held to its
  own float32 run: its step-0 loss and gradient within 1e-2 [3.5e-6 and 4.2e-4]
  (bfloat16 rounding of each convolution's operands), and the mode rounds every
  convolution, forward, backward and double backward, while the run's losses differ
  from float32's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries import precision
from breaching_tpu_torch.attacks.auxiliaries.objectives import objective_lookup
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

torch.set_num_threads(1)
SLICE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
         "case.data.shape=[3, 16, 16]", "seed=0"]
X = np.random.default_rng(3).normal(size=(1, 3, 16, 16)).astype(np.float32)


@pytest.fixture(autouse=True)
def x64_restored():
    """``case.impl.dtype=float64`` switches the JAX package's x64 flag on for the process:
    it goes back off after each test, so that no later test in this worker inherits it."""
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _both(overrides):
    cfg, jax_cfg = breaching.get_config(SLICE + overrides), jax_breaching.get_config(SLICE + overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    load_flat_state(model, {prefix + "/".join(k.key for k in path): np.asarray(leaf)
                            for prefix, tree in (("params/", j_model.params), ("buffers/", j_model.buffers))
                            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}, strict=True)
    port = dict(setup=setup, server=server, loss_fn=loss_fn,
                attacker=breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup))
    ref = dict(setup=jax_setup, server=j_server, loss_fn=j_loss,
               attacker=jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack,
                                                             jax_setup))
    port["shared"], port["payloads"], _ = server.run_protocol(user)
    ref["shared"], ref["payloads"], _ = j_server.run_protocol(j_user)
    return port, ref


def _port_value_and_grad(port, x=X, targets=None):
    """The port's loss (objective and regularizers) at candidate ``x`` in the setup's
    dtype and its gradient, with the dtypes met on the way; against ``targets`` (the
    user's gradient in the port's names) where given."""
    attacker = port["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(port["payloads"], port["shared"])
    if targets is not None:
        attacker._shared_data_cache[0]["gradients"] = targets
    attacker.objective.initialize(port["loss_fn"], rec_models[0].module, None, attacker.cfg.impl)
    targets = [tuple(attacker._shared_data_cache[0]["gradients"][k] for k in rec_models[0].params)]
    xt = torch.from_numpy(x).to(port["setup"]["dtype"]).requires_grad_(True)
    grads, _ = attacker.objective.grad_fn(rec_models[0].params, rec_models[0].buffers, xt, labels)
    value, _ = attacker._loss(xt, rec_models, targets, labels)
    grad, = torch.autograd.grad(value, xt)
    dtypes = dict(params=rec_models[0].params[next(iter(rec_models[0].params))].dtype, targets=targets[0][0].dtype,
                  candidate=xt.dtype, user_grads=grads[0].dtype, value=value.dtype, grad=grad.dtype)
    return value.item(), grad.double().numpy(), dtypes


def _jax_value_and_grad(ref, x=X):
    attacker = ref["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(ref["payloads"], ref["shared"])
    attacker.objective.initialize(ref["loss_fn"], rec_models[0], None, attacker.cfg.impl)
    loss = attacker._build_loss_fn(rec_models, attacker._shared_data_cache, labels, include_outer_regs=True)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1))).astype(ref["setup"]["dtype"])
    value, grad = jax.value_and_grad(lambda c: loss(dict(data=c), jax.random.PRNGKey(0))[0])(xj)
    return float(value), np.transpose(np.asarray(grad.astype(jnp.float64)), (0, 3, 1, 2))


def _assert_close(got, want, rel):
    (value, grad), (want_value, want_grad) = got, want
    assert abs(value - want_value) <= rel * abs(want_value), (value, want_value)
    err = np.abs(grad - want_grad).max() / np.abs(want_grad).max()
    assert err <= rel, err


@pytest.fixture(scope="module")
def float32_run():
    port, _ = _both([])
    runs = {}
    for objective in ("cosine-similarity", "fused-cosine-similarity"):
        port["attacker"].objective = objective_lookup[objective]()
        runs[objective] = _port_value_and_grad(port)[:2]
    return runs


@pytest.mark.parametrize("dtype,objective,tolerance", [
    ("bfloat16", "cosine-similarity", 1e-2), ("float16", "cosine-similarity", 1e-3),
    ("bfloat16", "fused-cosine-similarity", 1e-2)])
def test_compute_dtype_matches_jax_and_its_own_float32(dtype, objective, tolerance, float32_run):
    # the JAX package's fused cosine raises in bfloat16 (Queue C): its plain cosine is the yardstick
    port, ref = _both([f"attack.impl.dtype={dtype}"])
    port["attacker"].objective = objective_lookup[objective]()
    value, grad, dtypes = _port_value_and_grad(port)
    assert port["attacker"].objective.compute_dtype == getattr(torch, dtype)
    assert dtypes["user_grads"] == getattr(torch, dtype)  # the simulated user pass ran in it
    assert dtypes["candidate"] == dtypes["grad"] == dtypes["value"] == torch.float32
    _assert_close((value, grad), _jax_value_and_grad(ref), tolerance)
    _assert_close((value, grad), float32_run[objective], tolerance)


def test_float64_attack_dtype_casts_nothing(float32_run):
    port, _ = _both(["attack.impl.dtype=float64"])
    value, grad, dtypes = _port_value_and_grad(port)
    assert port["attacker"].objective.compute_dtype is None and dtypes["user_grads"] == torch.float32
    assert value == float32_run["cosine-similarity"][0]
    np.testing.assert_array_equal(grad, float32_run["cosine-similarity"][1])


def test_case_float64_matches_a_float64_evaluation_and_the_jax_objective():
    port, ref = _both(["case.impl.dtype=float64", "case.model=LeNetZhu"])
    value, grad, dtypes = _port_value_and_grad(port)
    assert set(dtypes.values()) == {torch.float64}
    _assert_close((value, grad), _jax_value_and_grad(ref), 1e-6)

    # the same objective in float64 throughout, written here on the JAX model, against
    # the JAX package's exchange, which the port's objective takes too (the JAX package
    # normalizes the user's images in float64 under x64, the port in float32, and the two
    # exchanges differ in their last bits)
    attacker = ref["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(ref["payloads"], ref["shared"])
    jax_model, target = rec_models[0], attacker._shared_data_cache[0]["gradients"]
    params = jax.tree_util.tree_map(lambda leaf: leaf.astype(jnp.float64), jax_model.params)  # float32 in JAX
    twin = copy.deepcopy(port["server"].model)
    load_flat_state(twin, {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
                           for path, leaf in jax.tree_util.tree_flatten_with_path(target)[0]})
    value, grad, _ = _port_value_and_grad(port, targets={k: v.detach() for k, v in twin.named_parameters()})

    def loss(c):
        def task(p):
            outputs, _ = jax_model.apply(p, jax_model.buffers, c, train=False, capture=False)
            return ref["loss_fn"](outputs, labels)

        g, t = jax.tree_util.tree_leaves(jax.grad(task)(params)), jax.tree_util.tree_leaves(target)
        dot = sum(jnp.vdot(a, b) for a, b in zip(g, t))
        norms = jnp.sqrt(sum(jnp.vdot(a, a) for a in g)) * jnp.sqrt(sum(jnp.vdot(b, b) for b in t))
        return (1.0 - dot / (norms + 1e-12)) + sum(reg(c, None) for reg in attacker.regularizers)

    want_value, want_grad = jax.value_and_grad(loss)(jnp.asarray(np.transpose(X, (0, 2, 3, 1)), jnp.float64))
    _assert_close((value, grad), (float(want_value), np.transpose(np.asarray(want_grad), (0, 3, 1, 2))), 1e-12)


def test_case_bfloat16_lands_as_jax_promotes_it():
    port, ref = _both(["case.impl.dtype=bfloat16"])
    value, grad, dtypes = _port_value_and_grad(port)
    assert dtypes == dict(params=torch.float32, targets=torch.bfloat16, candidate=torch.bfloat16,
                          user_grads=torch.float32, value=torch.float32, grad=torch.bfloat16)
    _assert_close((value, grad), _jax_value_and_grad(ref), 1e-2)


def test_bf16_attack_first_steps_match_jax_and_stay_float32():
    overrides = ["attack.impl.dtype=bfloat16", "attack.optim.signed=False", "attack.optim.max_iterations=3",
                 "attack.optim.callback=3"]
    port, ref = _both(overrides)
    rec, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                              initial_data=torch.from_numpy(X))
    _, j_stats = ref["attacker"].reconstruct(ref["payloads"], ref["shared"], ref["server"].secrets,
                                             initial_data=np.transpose(X, (0, 2, 3, 1)))
    assert len(stats["Trial_0_Val"]) == 3
    np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-2)
    assert rec["data"].dtype == torch.float32  # the best iterate, as the candidate, stays float32
    objective = port["attacker"].objective
    cast = objective._cast(dict(x=torch.zeros(2), i=torch.zeros(2, dtype=torch.int32)), objective.compute_dtype)
    assert cast["x"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32  # integers never cast


def test_mixed_precision_rounds_every_product_and_stays_near_float32(float32_run, monkeypatch):
    port, _ = _both(["attack.impl.mixed_precision=True"])
    modes = []
    real = precision.bfloat16_operands

    def recorded():
        modes.append(real())
        return modes[-1]

    with real() as mode:
        value, grad, _ = _port_value_and_grad(port)
    # the forward's convolutions and head, their backward, and the double backward's
    assert mode.rounded >= 3 * 5
    _assert_close((value, grad), float32_run["cosine-similarity"], 1e-2)
    assert value != float32_run["cosine-similarity"][0]
    import breaching_tpu_torch.attacks.optimization_based_attack as attack_module
    monkeypatch.setattr(attack_module, "bfloat16_operands", recorded)
    _, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                            initial_data=torch.from_numpy(X), dryrun=True)
    assert len(modes) == 1 and modes[0].rounded >= 3 * 5  # one step, under the mode
    assert abs(stats["Trial_0_Val"][0] - value) <= 1e-6 * abs(value)
