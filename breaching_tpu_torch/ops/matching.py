"""Gradient-matching kernels B1 and B2 and the fused cosine objective built on them.

Counterpart of ``breaching_tpu/ops/matching.py``. Kernels (``csrc/matching.cu``):

- B1 ``matching_sums`` replaces ``_matching_sums`` / Pallas ``_reduction_kernel``:
  (<rec, data>, |rec|^2, |data|^2) in one pass, float32 accumulation. Bound: 8 bytes
  per element over 3.35 TB/s.
- B2 ``axpby`` replaces ``_axpby`` / Pallas ``_axpby_kernel``: a x + b y with
  scalars a, b held on the device. Bound: 12 bytes per element over 3.35 TB/s.

Each wrapper runs its kernel on contiguous float32 CUDA tensors and counts the
launch in its ``launches`` attribute; it runs the plain PyTorch version (``*_plain``)
only for CPU tensors, and raises for anything else.
"""

from __future__ import annotations

import torch

from . import _build


def matching_sums_plain(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return torch.stack([(rec * data).sum(), (rec * rec).sum(), (data * data).sum()])


def matching_sums(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(<rec, data>, |rec|^2, |data|^2) of two flat vectors, as a float32 tensor of 3."""
    if rec.dim() != 1 or rec.shape != data.shape:
        raise ValueError(f"matching_sums takes two flat vectors of one length, got "
                         f"{tuple(rec.shape)} and {tuple(data.shape)}.")
    if _build.on_cpu("matching_sums", rec, data):
        return matching_sums_plain(rec, data)
    n = rec.numel()
    blocks = _build.reduce_blocks(n)
    partials = torch.empty(3 * blocks, device=rec.device, dtype=torch.float32)
    sums = torch.empty(3, device=rec.device, dtype=torch.float32)
    _build.check(_build.load_library().b1_matching_sums(
        rec.data_ptr(), data.data_ptr(), n, partials.data_ptr(), blocks, sums.data_ptr(),
        _build.stream_of(rec)), "b1_matching_sums")
    matching_sums.launches += 1
    return sums


matching_sums.launches = 0


def axpby_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return a * x + b * y


def axpby(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a x + b y for one-element tensors a, b and flat vectors x, y of one length."""
    if x.dim() != 1 or x.shape != y.shape or a.numel() != 1 or b.numel() != 1:
        raise ValueError(f"axpby takes scalars a, b and flat x, y of one length, got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}, {tuple(b.shape)}, {tuple(y.shape)}.")
    if _build.on_cpu("axpby", a, x, b, y):
        return axpby_plain(a, x, b, y)
    out = torch.empty_like(x)
    _build.check(_build.load_library().b2_axpby(
        a.data_ptr(), x.data_ptr(), b.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        _build.stream_of(x)), "b2_axpby")
    axpby.launches += 1
    return out


axpby.launches = 0


class _FusedCosine(torch.autograd.Function):
    """1 - <rec, data> / (|rec| |data| + 1e-12): B1 forward, B2 backward
    (``fused_cosine_similarity`` and ``_cos_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, rec, data):
        sums = matching_sums(rec, data)
        dot, rec_sq, data_sq = sums.unbind()
        ctx.save_for_backward(rec, data, sums)
        return 1.0 - dot / (torch.sqrt(rec_sq) * torch.sqrt(data_sq) + 1e-12)

    @staticmethod
    def backward(ctx, g):
        rec, data, sums = ctx.saved_tensors
        dot, rec_sq, data_sq = sums.unbind()
        rec_n, data_n = torch.sqrt(rec_sq), torch.sqrt(data_sq)
        a = (-g / (rec_n * data_n + 1e-12)).reshape(1)
        d_rec = d_data = None
        if ctx.needs_input_grad[0]:
            b = (g * dot / (rec_n ** 3 * data_n + 1e-12)).reshape(1)
            d_rec = axpby(a, data, b, rec)
        if ctx.needs_input_grad[1]:
            b = (g * dot / (data_n ** 3 * rec_n + 1e-12)).reshape(1)
            d_data = axpby(a, rec, b, data)
        return d_rec, d_data


def fused_cosine_similarity(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Cosine distance of two flat float32 vectors through kernels B1 and B2."""
    return _FusedCosine.apply(rec, data)
