"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA device.

These tests need the card (the kernels have no CPU mode) and skip without one.
They import neither JAX nor the JAX package, so they run on a machine with the
card but without JAX, with the JAX-side conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances, each with its reason:
- sums over n float32 terms in two orders: 1e-5 of the sum of |terms|;
- elementwise arithmetic done the same way by kernel and plain version: 2^-22 of
  the largest |value| (one rounding);
- the box clamp does no arithmetic: exact.
"""

import numpy as np
import pytest
import torch

from breaching_tpu_torch import ops
from breaching_tpu_torch.ops import image, matching

ONE_ROUNDING = 2.0 ** -22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(2_904_970, 0), (1_000_003, 0), (1_000_003, 1)])
def test_b1_b2_match_plain(cuda, n, offset):
    # offset 1 starts both vectors 4 bytes into their buffers: the unaligned path
    r, d = _randn(n + offset, 1, cuda)[offset:], _randn(n + offset, 2, cuda)[offset:]
    terms = torch.stack([(r * d).abs().sum(), (r * r).sum(), (d * d).sum()])
    before = ops.matching_sums.launches
    got = ops.matching_sums(r, d)
    assert ops.matching_sums.launches == before + 1
    assert bool(((got - matching.matching_sums_plain(r, d)).abs() <= 1e-5 * terms).all())
    a, b = torch.tensor([-0.7], device=cuda), torch.tensor([1.3], device=cuda)
    want = matching.axpby_plain(a, r, b, d)
    assert (ops.axpby(a, r, b, d) - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 331, 1007)])
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (2.0, 0.5)])
def test_b3_matches_plain(cuda, shape, p, q):
    x = _randn(shape, 3, cuda)
    want = image.tv_forward_plain(x, p, q).item()
    assert abs(ops.tv_forward(x, p, q).item() - want) <= 1e-5 * want
    g = torch.tensor([0.37], device=cuda)
    want = image.tv_backward_plain(x, g, p, q)
    assert (ops.tv_backward(x, g, p, q) - want).abs().max().item() <= ONE_ROUNDING * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 32, 32), (2, 3, 331, 1007)])
def test_b4_matches_plain(cuda, shape):
    x = _randn(shape, 4, cuda) * 3
    lo, hi = torch.tensor([-1.0, -2.0, 0.0], device=cuda), torch.tensor([1.0, 0.5, 2.0], device=cuda)
    assert torch.equal(ops.box_project(x, lo, hi), image.box_project_plain(x, lo, hi))


@pytest.mark.cuda
def test_kernels_refuse_non_contiguous_input(cuda):
    x = _randn((1, 3, 32, 32), 5, cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.tv_forward(x)
