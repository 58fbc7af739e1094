"""``attack.impl.grad_accum`` in the port: a fedSGD user's gradient and task loss as
the means over micro-batches of the candidate (the JAX package's
``breaching_tpu/attacks/auxiliaries/objectives.py:98-154``), against the full batch in
the port and against the JAX package's ``grad_accum`` path, on case 1's ConvNet-8 at
16x16 with 8 candidate images (BatchNorm on the server's buffers, as in case 6).

Tolerances: the micro-batched gradient sums the same terms as the full batch in
another grouping, so it is held to 1e-6 of the largest entry, in float32. The attack
gradient through it (the cosine objective's, by the candidate, through a double
backward) is held to 1e-5 of its largest entry against grad_accum=1 and against the
port's float64 evaluation [measured: 2.3e-6 apart, 1.3e-6 and 1.9e-6 from float64],
its value 1 - cos to 16 float32 ulps of the cosine (9.5e-7), as
tests/test_torch_objectives.py holds a cosine near 1 [measured: 1 ulp]. Against the
JAX package, float32 on both sides with convolutions summed in other orders: 1e-5 of
the largest entry, as tests/test_torch_objectives.py holds the objectives. The rules the JAX package keeps
are held by their warnings: a divisor fallback, and the knob ignored under capture,
BatchNorm in train mode and for a fedAVG user.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.objectives import CosineSimilarity as JaxCosine
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.objectives import CosineSimilarity

torch.set_num_threads(1)
CASE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
        "case.data.shape=[3, 16, 16]", "case.user.num_data_points=8", "case.data.batch_size=8", "seed=0"]
N = 8


@pytest.fixture(scope="module")
def models():
    cfg, jax_cfg = breaching.get_config(CASE), jax_breaching.get_config(CASE)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_model, j_loss = jax_breaching.cases.construct_model(jax_cfg.case.model, jax_cfg.case.data)
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, N)
    del jax_setup
    return dict(j_model=j_model, j_loss=j_loss, model=model, loss=loss, x=x, y=y)


def _port_objective(m, accum, local_hyperparams=None):
    obj = CosineSimilarity()
    obj.initialize(m["loss"], m["model"], local_hyperparams, {"grad_accum": accum})
    params = {k: v.detach().requires_grad_(True) for k, v in m["model"].named_parameters()}
    return obj, params, dict(m["model"].named_buffers())


def _port_user_gradient(m, accum, x=None):
    obj, params, buffers = _port_objective(m, accum)
    x = torch.from_numpy(m["x"]) if x is None else x
    grads, loss = obj.grad_fn(params, buffers, x, torch.from_numpy(m["y"]))
    return [g.detach() for g in grads], loss.detach()


def _close(got, want, rel):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=rel * scale)


@pytest.mark.parametrize("accum", [2, 4, 8])
def test_micro_batched_user_gradient_equals_the_full_batch(models, accum):
    full, full_loss = _port_user_gradient(models, 1)
    got, loss = _port_user_gradient(models, accum)
    _close(got, full, 1e-6)
    assert abs(loss.item() - full_loss.item()) <= 1e-6 * abs(full_loss.item())


@pytest.mark.parametrize("accum", [1, 4])
def test_micro_batched_user_gradient_matches_the_jax_package(models, accum):
    m = models
    j_obj = JaxCosine()
    j_obj.initialize(m["j_loss"], m["j_model"], None, {"grad_accum": accum})
    j_grads, j_loss, _ = j_obj.grad_fn(m["j_model"].params, m["j_model"].buffers,
                                       jnp.asarray(np.transpose(m["x"], (0, 2, 3, 1))), jnp.asarray(m["y"]))
    got, loss = _port_user_gradient(m, accum)
    twin = breaching.cases.construct_model(CASE[2].split("=")[1], breaching.get_config(CASE).case.data)[0]
    twin.from_jax_state(jax.tree_util.tree_map(np.array, j_grads), jax.tree_util.tree_map(np.array,
                                                                                          m["j_model"].buffers))
    want = [p.detach() for p in twin.parameters()]
    _close(got, want, 1e-5)
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_attack_gradient_through_grad_accum_equals_the_full_batch(models):
    """The cosine objective's value and its gradient by the candidate, against a target
    gradient of other images, through grad_accum=4 and grad_accum=1."""
    target, _ = _port_user_gradient(models, 1, torch.from_numpy(
        np.random.default_rng(8).normal(size=(N, 3, 16, 16)).astype(np.float32)))
    results = []
    for accum, dtype in ((1, torch.float64), (1, torch.float32), (4, torch.float32)):
        m = dict(models, model=copy.deepcopy(models["model"]).to(dtype))
        obj, params, buffers = _port_objective(m, accum)
        x = torch.from_numpy(models["x"]).to(dtype).requires_grad_(True)
        value, _ = obj(params, buffers, tuple(t.to(dtype) for t in target), x, torch.from_numpy(models["y"]))
        grad, = torch.autograd.grad(value, x)
        results.append((value.item(), grad.double()))
    (exact_value, exact), (want_value, want), (value, grad) = results
    assert abs(value - want_value) <= 16 * np.finfo(np.float32).eps / 2
    assert abs(value - exact_value) <= 16 * np.finfo(np.float32).eps / 2
    _close([grad], [want], 1e-5)
    _close([grad], [exact], 1e-5)


def test_grad_accum_falls_back_to_a_divisor_and_warns(models, caplog):
    with caplog.at_level(logging.WARNING):
        got, _ = _port_user_gradient(models, 3)
        _port_user_gradient(models, 3)
    assert [r.getMessage() for r in caplog.records].count(
        "grad_accum=3 does not divide the batch of 8; using grad_accum=2.") == 2  # once per objective
    want, _ = _port_user_gradient(models, 2)
    _close(got, want, 0.0)


def test_grad_accum_is_ignored_under_capture_and_batchnorm_train_mode(models, caplog):
    full, _ = _port_user_gradient(models, 1)
    obj, params, buffers = _port_objective(models, 4)
    x, y = torch.from_numpy(models["x"]), torch.from_numpy(models["y"])
    with caplog.at_level(logging.WARNING):
        captured = {}
        got, _ = obj.grad_fn(params, buffers, x, y, capture=captured)
        obj.grad_fn(params, buffers, x, y, bn_train=True)
    _close([g.detach() for g in got], full, 0.0)  # one pass over the full batch
    assert "features" in captured
    assert [r.getMessage() for r in caplog.records] == [
        "grad_accum ignored: capture-intermediates regularizers and bn-train mode need the full batch "
        "in one pass."]


def test_grad_accum_is_ignored_for_a_fedavg_user(models, caplog):
    hyper = dict(lr=0.1, steps=2, data_per_step=4, labels=torch.from_numpy(models["y"]).reshape(2, 4))
    results = []
    with caplog.at_level(logging.WARNING):
        for accum in (1, 4):
            obj, params, buffers = _port_objective(models, accum, hyper)
            delta, _ = obj.grad_fn(params, buffers, torch.from_numpy(models["x"]), None)
            results.append([d.detach() for d in delta])
    _close(results[1], results[0], 0.0)
    assert [r.getMessage() for r in caplog.records] == [
        "grad_accum ignored: the multi-step (fedavg) simulated update unrolls full local batches per step."]


def test_grad_accum_under_the_batched_trial_step_matches_each_trial(models):
    """The trials form takes the same micro-batches (one ``_MicroBatchGradient`` over
    all trials each): two trials' values equal their single evaluations with
    grad_accum=4 to 1e-6, and their attack gradients to 1e-5 of the largest entry."""
    obj, params, buffers = _port_objective(models, 4)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(models["x"])[None] + torch.from_numpy(rng.normal(size=(2, *models["x"].shape))
                                                               .astype(np.float32))
    y = torch.from_numpy(models["y"])[None].repeat(2, 1)
    targets = tuple(p.detach()[None].repeat(2, *[1] * p.dim()) + 0.01 for p in params.values())
    xt = x.clone().requires_grad_(True)
    values, _ = obj.trials(params, buffers, targets, xt, y)
    grads, = torch.autograd.grad(values.sum(), xt)
    for t in range(2):
        xs = x[t].clone().requires_grad_(True)
        value, _ = obj(params, buffers, tuple(d[t] for d in targets), xs, y[t])
        grad, = torch.autograd.grad(value, xs)
        assert abs(values[t].item() - value.item()) <= 1e-6
        np.testing.assert_allclose(grads[t].numpy(), grad.numpy(), rtol=0, atol=1e-5 * grad.abs().max().item())
