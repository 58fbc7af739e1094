"""Total variation's value and gradient in one call (``ops.tv_value_and_grad``, through
its plain version on the CPU) and the TV regularizer built on it, against the JAX
package's ``TotalVariation``, ``_tv_p1q1`` and ``_make_tv_general``. The kernel itself
is held against the plain version in tests/test_torch_kernels.py. The text cuts by which
``breaching_tpu_torch.tv_profile`` gives the kernel a mode must still find the kernel.

Inputs come from numpy seeds and reach both sides as the same float32 arrays.
Tolerances, as tests/test_torch_ops.py states them: the value, a mean of n terms
summed in two orders, 1e-5 relative; the gradient, where sqrt and pow(., -0.5) come
from two libraries, 1e-6 of the largest |value|. Non-finite values must be
non-finite in the same places.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.regularizers import TotalVariation as JaxTotalVariation
from breaching_tpu.attacks.auxiliaries.regularizers import _make_tv_general, _tv_p1q1
from breaching_tpu_torch import ops, tv_profile
from breaching_tpu_torch.attacks.auxiliaries.regularizers import TotalVariation
from breaching_tpu_torch.ops import image

torch.set_num_threads(1)
SHAPES = [(1, 3, 32, 32), (2, 3, 17, 23), (1, 6, 9, 1), (1, 3, 1, 7)]
EXPONENTS = [(1.0, 1.0), (2.0, 0.5)]


def _images(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _opponents(x):
    """The double-opponent channels the port's TotalVariation appends (NCHW)."""
    return torch.cat([x, x[:, 0:1] - x[:, 1:2], x[:, 0:1] - x[:, 2:3], x[:, 1:2] - x[:, 2:3]], dim=1)


def _assert_value(got, want):
    got, want = float(got), float(want)
    if np.isfinite(want):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    else:
        assert str(got) == str(want), (got, want)  # nan with nan, inf with inf


def _assert_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p,q", EXPONENTS)
@pytest.mark.parametrize("double_opponents", [False, True])
def test_tv_value_and_grad_plain_matches_jax(shape, p, q, double_opponents):
    x = _images(shape, 20)
    reg = JaxTotalVariation(scale=0.2, inner_exp=p, outer_exp=q, double_opponents=double_opponents)
    value, grad = jax.value_and_grad(reg)(_nhwc(x))
    xt = torch.from_numpy(x).requires_grad_(double_opponents)
    z = _opponents(xt) if double_opponents else xt
    got, got_grad = image.tv_value_and_grad_plain(z.detach(), torch.tensor([0.2]), p, q, 1e-8)
    if double_opponents:  # the gradient with respect to the opponent channels, pulled back to x
        got_grad, = torch.autograd.grad(z, xt, got_grad)
    _assert_value(got, value)
    _assert_grad(got_grad, _nchw(grad))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p,q", EXPONENTS)
@pytest.mark.parametrize("double_opponents", [False, True])
def test_total_variation_regularizer_matches_jax(shape, p, q, double_opponents):
    x = _images(shape, 21)
    kwargs = dict(scale=0.2, inner_exp=p, outer_exp=q, double_opponents=double_opponents)
    value, grad = jax.value_and_grad(JaxTotalVariation(**kwargs))(_nhwc(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TotalVariation(**kwargs)(xt)
    got_grad, = torch.autograd.grad(got, xt)
    assert got.shape == ()
    _assert_value(got.detach(), value)
    _assert_grad(got_grad, _nchw(grad))


PLACES = {  # (h, w) of the one planted value in an H x W plane
    "last column": lambda H, W: (H // 2, W - 1),
    "last row": lambda H, W: (H - 1, W // 2),
    "column 0": lambda H, W: (H // 2, 0),
    "row 0": lambda H, W: (0, W // 2),
    "corner": lambda H, W: (H - 1, W - 1),
}


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("planted", [float("nan"), float("inf"), float("-inf")])
@pytest.mark.parametrize("p,q", EXPONENTS)
def test_tv_non_finite_pixels_at_the_boundary_match_jax(place, planted, p, q):
    # the JAX VJPs carry a NaN at the wrapped boundary through their rolls, and the
    # general form turns an infinite wrapped difference into NaN (inf * 0); NaN must
    # land in the same places in the port, in value and gradient
    x = _images((2, 3, 17, 23), 22)
    h, w = PLACES[place](17, 23)
    x[1, 2, h, w] = planted
    xt = torch.from_numpy(x)
    got, got_grad = image.tv_value_and_grad_plain(xt, torch.tensor([0.2]), p, q, 1e-8)
    value, grad = jax.value_and_grad(JaxTotalVariation(scale=0.2, inner_exp=p, outer_exp=q))(_nhwc(x))
    _assert_value(got, value)
    _assert_grad(got_grad, _nchw(grad))
    vjp = (lambda z: _tv_p1q1(z, 1e-8)) if (p, q) == (1.0, 1.0) else _make_tv_general(p, q, 1e-8)
    want = _nchw(jax.grad(vjp)(_nhwc(x))) * np.float32(0.2)
    _assert_grad(got_grad, want)
    _assert_grad(ops.tv_backward(xt, torch.tensor([0.2]), p, q, 1e-8), want)
    assert bool(torch.isnan(got_grad).any()) == (planted != planted or (p, q) != (1.0, 1.0))


def test_total_variation_computes_value_and_gradient_in_one_call(monkeypatch):
    calls = []
    monkeypatch.setattr(image, "tv_value_and_grad",
                        lambda *args: calls.append(1) or image.tv_value_and_grad_plain(*args))
    x = torch.from_numpy(_images((1, 3, 8, 8), 23)).requires_grad_(True)
    reg = TotalVariation(scale=0.2)
    torch.autograd.grad(reg(x) * 3.0, x)
    torch.autograd.grad(reg(x), x)
    assert len(calls) == 2
    assert list(reg._scales) == [x.device]  # the scale tensor is made once per device


def test_tv_backward_of_the_scaled_value_is_the_saved_gradient_times_upstream():
    x = torch.from_numpy(_images((1, 3, 8, 8), 24)).requires_grad_(True)
    scale = torch.tensor([0.2])
    value = ops.total_variation(x, scale=scale)
    got, = torch.autograd.grad(value * 3.0, x)
    _, want = image.tv_value_and_grad_plain(x.detach(), scale)
    torch.testing.assert_close(got, want * 3.0, rtol=0, atol=0)


def test_tv_value_and_grad_refuses_what_it_does_not_take():
    x = torch.zeros(1, 3, 4, 4)
    with pytest.raises(ValueError):
        ops.tv_value_and_grad(torch.zeros(3, 4, 4), torch.ones(1))
    with pytest.raises(ValueError):  # a scale of two elements
        ops.tv_value_and_grad(x, torch.ones(2))
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device: no plain fallback
        ops.tv_value_and_grad(x.to("meta"), torch.ones(1, device="meta"))


def test_tv_profile_cuts_still_find_the_fused_kernel():
    """Every anchor of ``tv_profile.CUTS`` is still in csrc/image.cu, and after the cuts every
    instantiation of the fused kernel, the profile's harness's too, takes the mode."""
    source = tv_profile.cut_source()
    assert "bool kGrad, int kMode>" in source and "(kMode & 2)" in source and "(kMode & 1)" in source
    found = re.findall(r"tv_value_and_grad_kernel<([^<>]*)>", source + tv_profile.HARNESS)
    assert len(found) >= 5 and all(len(args.split(",")) == 3 for args in found), found
