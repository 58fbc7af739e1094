"""Gradient-matching kernels B1 and B2 and the fused cosine objective built on them.

Counterpart of ``breaching_tpu/ops/matching.py``. Kernels (``csrc/matching.cu``):

- B1 ``matching_sums`` replaces ``_matching_sums`` / Pallas ``_reduction_kernel``:
  (<rec, data>, |rec|^2, |data|^2) in one pass, float32 accumulation. Bound: 8 bytes
  per element over 3.35 TB/s.
- B2 ``axpby`` replaces ``_axpby`` / Pallas ``_axpby_kernel``: a x + b y with
  scalars a, b held on the device. Bound: 12 bytes per element over 3.35 TB/s.
- ``cosine_backward`` is B2 rebuilt for the cosine's VJP (``_cos_bwd``, which calls
  ``_axpby``): each thread forms a and b from B1's sums and the upstream gradient in
  registers, in ``_cos_bwd``'s order, then streams a x + b y. One launch in place of
  the eleven scalar launches and ``axpby``. Bound: 12 bytes per element.

``fused_euclidean`` (B5, the JAX package's ``fused_euclidean``) is built on them:
B1 gives 0.5 (|r|^2 - 2 <r, d> + |d|^2) and ``axpby(g, rec, -g, data)`` its gradient
with respect to rec, one launch of each per evaluation.

Each wrapper runs its kernel on contiguous float32 CUDA tensors and counts the
launch in its ``launches`` attribute; it runs the plain PyTorch version (``*_plain``)
only for CPU tensors, and raises for anything else. ``axpby`` reaches its kernel
through PyTorch's dispatcher (``torch.ops.breaching.axpby``), the others through ctypes.
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
    stream = _build.launch_stream("matching_sums", rec, data)
    if stream is None:
        return matching_sums_plain(rec, data)
    n = rec.numel()
    blocks = _build.reduce_blocks(n)
    partials = torch.empty(3 * blocks, device=rec.device, dtype=torch.float32)
    sums = torch.empty(3, device=rec.device, dtype=torch.float32)
    _build.check(_build.load_library().b1_matching_sums(
        rec.data_ptr(), data.data_ptr(), n, partials.data_ptr(), blocks, sums.data_ptr(),
        stream), "b1_matching_sums")
    matching_sums.launches += 1
    return sums


matching_sums.launches = 0


def axpby_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return a * x + b * y


_axpby_op = None  # torch.ops.breaching.axpby, bound at the first launch


def axpby(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a x + b y for one-element tensors a, b and flat vectors x, y of one length.

    For a CUDA x the dispatcher's op (csrc/bindings.cpp) checks shapes, devices, dtypes
    and contiguity in C++ and raises for what the kernel does not take; for CPU tensors
    the plain version runs."""
    global _axpby_op
    if x.is_cuda:
        if _axpby_op is None:
            _axpby_op = _build.op("axpby")
        out = _axpby_op(a, x, b, y)
        axpby.launches += 1
        return out
    if x.dim() != 1 or x.shape != y.shape or a.numel() != 1 or b.numel() != 1:
        raise ValueError(f"axpby takes scalars a, b and flat x, y of one length, got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}, {tuple(b.shape)}, {tuple(y.shape)}.")
    _build.require_cpu("axpby", a, x, b, y)
    return axpby_plain(a, x, b, y)


axpby.launches = 0


def cosine_backward_plain(sums, g, rec, data, wrt_data=False):
    """d/d rec of g (1 - <rec, data> / (|rec| |data| + 1e-12)), or d/d data if
    ``wrt_data``, from sums = (<rec, data>, |rec|^2, |data|^2): ``_cos_bwd``'s scalar
    arithmetic, then ``axpby_plain``."""
    dot, rec_sq, data_sq = sums.unbind()
    rec_n, data_n = torch.sqrt(rec_sq), torch.sqrt(data_sq)
    a = (-g / (rec_n * data_n + 1e-12)).reshape(1)
    if wrt_data:
        b = (g * dot / (data_n ** 3 * rec_n + 1e-12)).reshape(1)
        return axpby_plain(a, rec, b, data)
    b = (g * dot / (rec_n ** 3 * data_n + 1e-12)).reshape(1)
    return axpby_plain(a, data, b, rec)


def cosine_backward(sums, g, rec, data, wrt_data=False):
    """The cosine distance's gradient with respect to rec (or data, if ``wrt_data``),
    times the one-element upstream gradient g, from the three sums of ``matching_sums``."""
    if rec.dim() != 1 or rec.shape != data.shape or sums.shape != (3,) or g.numel() != 1:
        raise ValueError(f"cosine_backward takes sums of shape (3,), a one-element g and flat rec, "
                         f"data of one length, got {tuple(sums.shape)}, {tuple(g.shape)}, "
                         f"{tuple(rec.shape)}, {tuple(data.shape)}.")
    stream = _build.launch_stream("cosine_backward", sums, g, rec, data)
    if stream is None:
        return cosine_backward_plain(sums, g, rec, data, wrt_data)
    out = torch.empty_like(rec)
    _build.check(_build.load_library().b2_cosine_backward(
        sums.data_ptr(), g.data_ptr(), rec.data_ptr(), data.data_ptr(), out.data_ptr(), rec.numel(),
        int(wrt_data), stream), "b2_cosine_backward")
    cosine_backward.launches += 1
    return out


cosine_backward.launches = 0


class _FusedCosine(torch.autograd.Function):
    """1 - <rec, data> / (|rec| |data| + 1e-12): B1 forward, B2's cosine backward
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
        g = g.contiguous()
        d_rec = cosine_backward(sums, g, rec, data) if ctx.needs_input_grad[0] else None
        d_data = cosine_backward(sums, g, rec, data, wrt_data=True) if ctx.needs_input_grad[1] else None
        return d_rec, d_data


def fused_cosine_similarity(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Cosine distance of two flat float32 vectors through kernels B1 and B2."""
    return _FusedCosine.apply(rec, data)


class _FusedEuclidean(torch.autograd.Function):
    """0.5 |rec - data|^2 from B1's sums; the backward is ``axpby(g, rec, -g, data)``
    (``_euc_bwd`` of the JAX package), with a and b the upstream gradient and its
    negation kept on the device. The target ``data`` takes no gradient in the
    attack, so one ``axpby`` launch gives the backward; the other is formed only if
    asked for."""

    @staticmethod
    def forward(ctx, rec, data):
        dot, rec_sq, data_sq = matching_sums(rec, data).unbind()
        ctx.save_for_backward(rec, data)
        return 0.5 * (rec_sq - 2 * dot + data_sq)

    @staticmethod
    def backward(ctx, g):
        rec, data = ctx.saved_tensors
        g = g.reshape(1)
        d_rec = axpby(g, rec, -g, data) if ctx.needs_input_grad[0] else None
        d_data = axpby(-g, rec, g, data) if ctx.needs_input_grad[1] else None
        return d_rec, d_data


def fused_euclidean(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """0.5 |rec - data|^2 of two flat float32 vectors through kernels B1 and B2."""
    return _FusedEuclidean.apply(rec, data)


def fused_euclidean_plain(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fused_euclidean``'s plain version: the same formula over the plain sums,
    differentiated by autograd."""
    dot, rec_sq, data_sq = matching_sums_plain(rec, data).unbind()
    return 0.5 * (rec_sq - 2 * dot + data_sq)
