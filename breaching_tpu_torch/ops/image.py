"""Image-space kernels B3 (total variation, forward and backward) and B4 (box clamp).

Counterpart of ``breaching_tpu/ops/image.py``, on NCHW batches (the JAX package
is NHWC, so the TV stencil runs along dims 3 and 2 here). Kernels
(``csrc/image.cu``):

- B3 ``tv_forward`` replaces ``fused_total_variation`` / Pallas ``_tv_kernel``;
  bound 4 bytes per element over 3.35 TB/s. ``tv_backward`` is the gradient the
  TPU kernel lacks, the sign-divergence formula of ``regularizers._tv_p1q1_bwd``
  and ``_make_tv_general``; bound 8 bytes per element.
- B4 ``box_project`` replaces ``box_project`` / Pallas ``_box_kernel``; bound 8 bytes
  per element.

Each wrapper runs its kernel on contiguous float32 CUDA tensors and counts the
launch in its ``launches`` attribute; it runs the plain PyTorch version (``*_plain``)
only for CPU tensors, and raises for anything else.
"""

from __future__ import annotations

import torch

from . import _build


def cheap_pow(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """x ** exponent, exact for the exponents the configs use (as the kernel computes it)."""
    if exponent == 0.0:
        return torch.ones_like(x)
    if exponent == 1.0:
        return x
    if exponent == 2.0:
        return x * x
    if exponent == 0.5:
        return torch.sqrt(x)
    if exponent == 1.5:
        return x * torch.sqrt(x)
    return torch.pow(x, exponent)


def _check_images(name: str, images: torch.Tensor) -> None:
    if images.dim() != 4 or images.numel() == 0:
        raise ValueError(f"{name} takes a non-empty NCHW batch, got shape {tuple(images.shape)}.")


def tv_forward_plain(images, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    dx = torch.diff(images, dim=3, append=images[..., -1:])
    dy = torch.diff(images, dim=2, append=images[..., -1:, :])
    px = cheap_pow(dx.abs() + eps, inner_exp)
    py = cheap_pow(dy.abs() + eps, inner_exp)
    return cheap_pow(px + py, outer_exp).sum() / images.numel()


def tv_forward(images, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """Mean of ((|dx|+eps)^p + (|dy|+eps)^p)^q over an NCHW batch, as a 0-dim tensor."""
    _check_images("tv_forward", images)
    if _build.on_cpu("tv_forward", images):
        return tv_forward_plain(images, inner_exp, outer_exp, eps)
    n, (h, w) = images.numel(), images.shape[-2:]
    blocks = _build.reduce_blocks(n)
    partials = torch.empty(blocks, device=images.device, dtype=torch.float32)
    out = torch.empty((), device=images.device, dtype=torch.float32)
    _build.check(_build.load_library().b3_tv_forward(
        images.data_ptr(), n, h, w, inner_exp, outer_exp, eps, partials.data_ptr(), blocks,
        out.data_ptr(), _build.stream_of(images)), "b3_tv_forward")
    tv_forward.launches += 1
    return out


tv_forward.launches = 0


def tv_backward_plain(images, upstream, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    H, W = images.shape[-2:]
    col = torch.arange(W, device=images.device) < (W - 1)
    row = (torch.arange(H, device=images.device) < (H - 1)).reshape(H, 1)
    dx = (torch.roll(images, -1, dims=3) - images) * col
    dy = (torch.roll(images, -1, dims=2) - images) * row
    px = cheap_pow(dx.abs() + eps, inner_exp)
    py = cheap_pow(dy.abs() + eps, inner_exp)
    outer = outer_exp * cheap_pow(px + py, outer_exp - 1.0)
    gx = outer * inner_exp * cheap_pow(dx.abs() + eps, inner_exp - 1.0) * torch.sign(dx) * col
    gy = outer * inner_exp * cheap_pow(dy.abs() + eps, inner_exp - 1.0) * torch.sign(dy) * row
    grad = (torch.roll(gx, 1, dims=3) - gx) + (torch.roll(gy, 1, dims=2) - gy)
    return grad * (upstream.reshape(()) / images.numel())


def tv_backward(images, upstream, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """d tv_forward / d images times the one-element tensor ``upstream``."""
    _check_images("tv_backward", images)
    if upstream.numel() != 1:
        raise ValueError(f"tv_backward takes a one-element upstream gradient, got {tuple(upstream.shape)}.")
    if _build.on_cpu("tv_backward", images, upstream):
        return tv_backward_plain(images, upstream, inner_exp, outer_exp, eps)
    out = torch.empty_like(images)
    h, w = images.shape[-2:]
    _build.check(_build.load_library().b3_tv_backward(
        images.data_ptr(), upstream.data_ptr(), images.numel(), h, w, inner_exp, outer_exp, eps,
        out.data_ptr(), _build.stream_of(images)), "b3_tv_backward")
    tv_backward.launches += 1
    return out


tv_backward.launches = 0


class _TotalVariation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, inner_exp, outer_exp, eps):
        ctx.save_for_backward(images)
        ctx.exps = (inner_exp, outer_exp, eps)
        return tv_forward(images, inner_exp, outer_exp, eps)

    @staticmethod
    def backward(ctx, g):
        images, = ctx.saved_tensors
        return tv_backward(images, g.reshape(1).contiguous(), *ctx.exps), None, None, None


def total_variation(images, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """Differentiable TV of an NCHW batch through kernel B3 (forward and backward)."""
    return _TotalVariation.apply(images, float(inner_exp), float(outer_exp), float(eps))


def box_project_plain(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo.reshape(1, -1, 1, 1)), hi.reshape(1, -1, 1, 1))


def box_project(x, lo, hi):
    """Clamp an NCHW batch to the per-channel bounds lo[c] <= x <= hi[c]."""
    if x.dim() != 4 or lo.shape != (x.shape[1],) or hi.shape != (x.shape[1],):
        raise ValueError(f"box_project takes an NCHW batch and bounds of shape (C,), got "
                         f"{tuple(x.shape)}, {tuple(lo.shape)}, {tuple(hi.shape)}.")
    if _build.on_cpu("box_project", x, lo, hi):
        return box_project_plain(x, lo, hi)
    out = torch.empty_like(x)
    _build.check(_build.load_library().b4_box_project(
        x.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), x.numel(),
        x.shape[2] * x.shape[3], x.shape[1], _build.stream_of(x)), "b4_box_project")
    box_project.launches += 1
    return out


box_project.launches = 0
