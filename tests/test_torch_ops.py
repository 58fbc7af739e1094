"""The plain PyTorch versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU as tests/test_ops.py runs them. The
kernels themselves are held against the plain versions in tests/test_torch_kernels.py.

Inputs come from numpy seeds and reach both sides as the same float32 arrays.
Tolerances, each with its reason:
- sums over n float32 terms in two orders: 1e-5 of the sum of |terms|;
- elementwise arithmetic done the same way on both sides: 2^-22 of the largest
  |value| (one rounding, should a compiler fuse a multiply-add);
- the TV gradient at (p, q) = (2, 0.5), where sqrt and pow(., -0.5) come from two
  libraries: 1e-6 of the largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.regularizers import TotalVariation as JaxTotalVariation
from breaching_tpu.attacks.auxiliaries.regularizers import _make_tv_general, _tv_p1q1
from breaching_tpu.ops import box_project as jax_box_project
from breaching_tpu.ops import fused_cosine_similarity as jax_fused_cosine
from breaching_tpu.ops import fused_total_variation as jax_fused_tv
from breaching_tpu.ops.matching import _axpby as jax_axpby
from breaching_tpu.ops.matching import _matching_sums as jax_matching_sums
from breaching_tpu_torch import ops
from breaching_tpu_torch.ops import matching

torch.set_num_threads(1)
ONE_ROUNDING = 2.0 ** -22


def _vec(n, seed):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _images(shape_nchw, seed):
    return np.random.default_rng(seed).normal(size=shape_nchw).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _close(got, want, rel, scale=None):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("n", [5000, 70_001])
def test_matching_sums_plain_matches_pallas(n):
    r, d = _vec(n, 0), _vec(n, 1)
    want = np.asarray(jax_matching_sums(jnp.asarray(r), jnp.asarray(d)))
    got = ops.matching_sums(torch.from_numpy(r), torch.from_numpy(d)).numpy()
    terms = np.asarray([np.abs(r * d).sum(), (r * r).sum(), (d * d).sum()], np.float64)
    np.testing.assert_array_less(np.abs(got - want), 1e-5 * terms)


@pytest.mark.parametrize("n", [5000, 70_001])
def test_axpby_plain_matches_pallas(n):
    x, y = _vec(n, 2), _vec(n, 3)
    want = jax_axpby(jnp.float32(-0.7), jnp.asarray(x), jnp.float32(1.3), jnp.asarray(y))
    got = ops.axpby(torch.tensor([-0.7]), torch.from_numpy(x), torch.tensor([1.3]), torch.from_numpy(y))
    _close(got, want, ONE_ROUNDING)


def test_fused_cosine_value_and_gradients_match_pallas():
    r, d = _vec(7001, 4), _vec(7001, 5)
    value, (g_r, g_d) = jax.value_and_grad(jax_fused_cosine, argnums=(0, 1))(jnp.asarray(r), jnp.asarray(d))
    rt, dt = torch.from_numpy(r).requires_grad_(True), torch.from_numpy(d).requires_grad_(True)
    got = ops.fused_cosine_similarity(rt, dt)
    got_r, got_d = torch.autograd.grad(got, (rt, dt))
    _close(got.detach(), value, 1e-5, scale=1.0)
    _close(got_r, g_r, 1e-5)
    _close(got_d, g_d, 1e-5)


@pytest.mark.parametrize("data_requires_grad", [False, True])
def test_fused_cosine_computes_the_data_gradient_only_when_needed(monkeypatch, data_requires_grad):
    calls = []
    monkeypatch.setattr(matching, "axpby", lambda *args: calls.append(1) or matching.axpby_plain(*args))
    r = torch.from_numpy(_vec(100, 6)).requires_grad_(True)
    d = torch.from_numpy(_vec(100, 7)).requires_grad_(data_requires_grad)
    torch.autograd.grad(ops.fused_cosine_similarity(r, d), (r, d) if data_requires_grad else (r,))
    assert len(calls) == (2 if data_requires_grad else 1)


@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 17, 23)])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_tv_forward_plain_matches_pallas(shape, p, q):
    x = _images(shape, 8)
    want = float(jax_fused_tv(_nhwc(x), p, q, 1e-8))
    got = float(ops.tv_forward(torch.from_numpy(x), p, q, 1e-8))
    assert abs(got - want) <= 1e-5 * abs(want)
    reg = float(JaxTotalVariation(scale=1.0, inner_exp=p, outer_exp=q)(_nhwc(x)))
    assert abs(got - reg) <= 1e-5 * abs(reg)


@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 17, 23)])
def test_tv_backward_matches_jax_p1q1(shape):
    x = _images(shape, 9)
    want = _nchw(jax.grad(_tv_p1q1)(_nhwc(x), 1e-8)) * 0.37
    got = ops.tv_backward(torch.from_numpy(x), torch.tensor([0.37]), 1.0, 1.0, 1e-8)
    _close(got, want, ONE_ROUNDING)


@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 17, 23)])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_tv_backward_matches_jax_general(shape, p, q):
    x = _images(shape, 10)
    want = _nchw(jax.grad(_make_tv_general(p, q, 1e-8))(_nhwc(x))) * 0.37
    got = ops.tv_backward(torch.from_numpy(x), torch.tensor([0.37]), p, q, 1e-8)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_total_variation_autograd_matches_jax(p, q):
    x = _images((1, 3, 32, 32), 11)
    reg = JaxTotalVariation(scale=0.2, inner_exp=p, outer_exp=q)
    value, grad = jax.value_and_grad(reg)(_nhwc(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ops.total_variation(xt, p, q, 1e-8) * 0.2
    got_grad, = torch.autograd.grad(got, xt)
    got = got.detach()
    assert abs(got.item() - float(value)) <= 1e-5 * abs(float(value))
    _close(got_grad, _nchw(grad), 1e-6)


def test_box_project_plain_matches_pallas():
    x = _images((2, 3, 8, 8), 12) * 3
    lo, hi = np.asarray([-1.0, -2.0, 0.0], np.float32), np.asarray([1.0, 0.5, 2.0], np.float32)
    want = _nchw(jax_box_project(_nhwc(x), jnp.asarray(lo), jnp.asarray(hi)))
    got = ops.box_project(torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_shapes_and_devices_they_do_not_take():
    x = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError):
        ops.box_project(x, torch.zeros(2), torch.zeros(3))
    with pytest.raises(ValueError):
        ops.matching_sums(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError):
        ops.tv_forward(torch.zeros(3, 4, 4))
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device: no plain fallback
        ops.axpby(*(torch.zeros(n, device="meta") for n in (1, 4, 1, 4)))


def test_launch_counts_reset():
    ops.matching_sums.launches = 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
