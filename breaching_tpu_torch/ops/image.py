"""Image-space kernels B3 (total variation) and B4 (box clamp).

Counterpart of ``breaching_tpu/ops/image.py``, on NCHW batches (the JAX package
is NHWC, so the TV stencil runs along dims 3 and 2 here). Kernels
(``csrc/image.cu``):

- B3 ``tv_forward`` replaces ``fused_total_variation`` / Pallas ``_tv_kernel``;
  bound 4 bytes per element over 3.35 TB/s. Off the attack step since
  ``tv_value_and_grad``.
- ``tv_value_and_grad`` is B3 rebuilt for the attack step: the TV's value times a
  scale and its gradient, the sign-divergence formula of ``regularizers._tv_p1q1_bwd``
  and ``_make_tv_general`` that the TPU kernel lacks, in one launch; bound 8 bytes
  per element. ``tv_backward`` is its gradient alone.
- B4 ``box_project`` replaces ``box_project`` / Pallas ``_box_kernel``; bound 8 bytes
  per element.
- ``adam_box_step`` is B4 rebuilt as the attack's whole step tail: the hard sign,
  optax's Adam, the box clamp, the finite guard and the best-iterate update, which
  the JAX package runs as one XLA fusion with ``jnp.clip`` in place of the box
  kernel (``breaching_tpu/attacks/optimization_based_attack.py:206-217, 401-466``).
  One launch in place of about 23; bound at most 32 bytes per element.

Each wrapper runs its kernel on contiguous float32 CUDA tensors and counts the
launch in its ``launches`` attribute; it runs the plain PyTorch version (``*_plain``)
only for CPU tensors, and raises for anything else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build


def sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1 or 1 by the sign of x, with NaN and both zeros kept as they are
    (``torch.sign`` maps NaN and -0.0 to 0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


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
    stream = _build.launch_stream("tv_forward", images)
    if stream is None:
        return tv_forward_plain(images, inner_exp, outer_exp, eps)
    n, (h, w) = images.numel(), images.shape[-2:]
    blocks = _build.reduce_blocks(n)
    partials = torch.empty(blocks, device=images.device, dtype=torch.float32)
    out = torch.empty((), device=images.device, dtype=torch.float32)
    _build.check(_build.load_library().b3_tv_forward(
        images.data_ptr(), n, h, w, inner_exp, outer_exp, eps, partials.data_ptr(), blocks,
        out.data_ptr(), stream), "b3_tv_forward")
    tv_forward.launches += 1
    return out


tv_forward.launches = 0


def tv_backward_plain(images, upstream, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    H, W = images.shape[-2:]
    col = torch.arange(W, device=images.device) < (W - 1)
    row = (torch.arange(H, device=images.device) < (H - 1)).reshape(H, 1)
    dx = torch.roll(images, -1, dims=3) - images
    dy = torch.roll(images, -1, dims=2) - images
    if inner_exp == 1.0 and outer_exp == 1.0:
        # regularizers._tv_p1q1_bwd: the sign of the unmasked difference, masked (an
        # infinite wrapped difference gives 0 there, where the general form gives NaN)
        gx, gy = sign(dx) * col, sign(dy) * row
    else:  # regularizers._make_tv_general
        dx, dy = dx * col, dy * row
        px = cheap_pow(dx.abs() + eps, inner_exp)
        py = cheap_pow(dy.abs() + eps, inner_exp)
        outer = outer_exp * cheap_pow(px + py, outer_exp - 1.0)
        gx = outer * inner_exp * cheap_pow(dx.abs() + eps, inner_exp - 1.0) * sign(dx) * col
        gy = outer * inner_exp * cheap_pow(dy.abs() + eps, inner_exp - 1.0) * sign(dy) * row
    grad = (torch.roll(gx, 1, dims=3) - gx) + (torch.roll(gy, 1, dims=2) - gy)
    # divide by a tensor: CUDA divides by a host scalar as a product with its reciprocal
    n = torch.full((), images.numel(), dtype=images.dtype, device=images.device)
    return grad * (upstream.reshape(()) / n)


def tv_backward(images, upstream, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """d tv_forward / d images times the one-element tensor ``upstream``: the gradient
    of ``tv_value_and_grad``."""
    return tv_value_and_grad(images, upstream, inner_exp, outer_exp, eps)[1]


def tv_value_and_grad_plain(images, scale, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    return (tv_forward_plain(images, inner_exp, outer_exp, eps) * scale.reshape(()),
            tv_backward_plain(images, scale, inner_exp, outer_exp, eps))


# The kernel's workspace: its ticket counter and up to 1024 block partials
# (csrc/image.cu TVWorkspace), zeroed once and left zeroed by every launch. One per
# device and stream, since launches on two streams may overlap; kept for good, since
# a captured CUDA graph holds its address.
_TV_WORKSPACE_WORDS = 1 + 1024
_tv_workspaces = {}  # (device index, stream handle) -> workspace
_tv_spares = {}  # device index -> workspaces zeroed outside graph capture, not yet taken


def _tv_workspace(device, stream):
    key = (device.index, stream)
    workspace = _tv_workspaces.get(key)
    if workspace is None:
        # a stream first seen while it is being captured takes a workspace zeroed before:
        # a zeroing captured into the graph would run only when the graph is replayed
        spares = _tv_spares.setdefault(device.index, [])
        if not spares:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("tv_value_and_grad: run it once on this device before capturing a "
                                   "CUDA graph, so that its workspace is zeroed outside the capture.")
            spares.extend(torch.zeros(8, _TV_WORKSPACE_WORDS, dtype=torch.int32, device=device).unbind())
            torch.cuda.current_stream(device).synchronize()  # zeroed before any stream takes one
        workspace = _tv_workspaces[key] = spares.pop()
    return workspace


def tv_value_and_grad(images, scale, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """(scale * tv_forward(images), scale * d tv_forward / d images) of an NCHW batch,
    for a one-element tensor ``scale``: a 0-dim value and a gradient of the images' shape."""
    _check_images("tv_value_and_grad", images)
    if scale.numel() != 1:
        raise ValueError(f"tv_value_and_grad takes a one-element scale, got {tuple(scale.shape)}.")
    stream = _build.launch_stream("tv_value_and_grad", images, scale)
    if stream is None:
        return tv_value_and_grad_plain(images, scale, inner_exp, outer_exp, eps)
    value = torch.empty((), device=images.device, dtype=torch.float32)
    grad = torch.empty_like(images)
    h, w = images.shape[-2:]
    _build.check(_build.load_library().b3_tv_value_and_grad(
        images.data_ptr(), scale.data_ptr(), images.numel(), h, w, inner_exp, outer_exp, eps,
        _tv_workspace(images.device, stream).data_ptr(), value.data_ptr(), grad.data_ptr(), stream),
        "b3_tv_value_and_grad")
    tv_value_and_grad.launches += 1
    return value, grad


tv_value_and_grad.launches = 0


class _TotalVariation(torch.autograd.Function):
    """scale * TV: value and gradient from one ``tv_value_and_grad`` call in the forward;
    the backward scales the saved gradient."""

    @staticmethod
    def forward(ctx, images, scale, inner_exp, outer_exp, eps):
        value, grad = tv_value_and_grad(images, scale, inner_exp, outer_exp, eps)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return grad * g, None, None, None, None


def total_variation(images, inner_exp=1.0, outer_exp=1.0, eps=1e-8, scale=None):
    """Differentiable ``scale`` * TV of an NCHW batch through ``tv_value_and_grad``;
    ``scale`` is a one-element tensor on the images' device, 1 if None."""
    if scale is None:
        scale = torch.ones(1, dtype=images.dtype, device=images.device)
    return _TotalVariation.apply(images, scale, float(inner_exp), float(outer_exp), float(eps))


def box_project_plain(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo.reshape(1, -1, 1, 1)), hi.reshape(1, -1, 1, 1))


def _check_box(name, x, lo, hi):
    if x.dim() != 4 or lo.shape != (x.shape[1],) or hi.shape != (x.shape[1],):
        raise ValueError(f"{name} takes an NCHW batch and bounds of shape (C,), got "
                         f"{tuple(x.shape)}, {tuple(lo.shape)}, {tuple(hi.shape)}.")


def box_project(x, lo, hi):
    """Clamp an NCHW batch to the per-channel bounds lo[c] <= x <= hi[c]."""
    _check_box("box_project", x, lo, hi)
    stream = _build.launch_stream("box_project", x, lo, hi)
    if stream is None:
        return box_project_plain(x, lo, hi)
    out = torch.empty_like(x)
    _build.check(_build.load_library().b4_box_project(
        x.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), x.numel(),
        x.shape[2] * x.shape[3], x.shape[1], stream), "b4_box_project")
    box_project.launches += 1
    return out


box_project.launches = 0


class AdamStep(NamedTuple):
    """The host scalars of one optax Adam step: the step size and the bias corrections
    1 - b1^t and 1 - b2^t, float32 values as optax computes them, the decay rates and eps."""
    lr: float
    b1: float
    b2: float
    eps: float
    bias1: float
    bias2: float


def adam_box_step_plain(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step,
                        signed=True, boxed=True):
    sign_grad = sign(grad) if signed else grad
    mu.copy_((1 - step.b1) * sign_grad + step.b1 * mu)
    nu.copy_((1 - step.b2) * (sign_grad * sign_grad) + step.b2 * nu)
    # divide by tensors: CUDA divides by a host scalar as a product with its reciprocal
    bias1 = torch.full((), step.bias1, dtype=x.dtype, device=x.device)
    bias2 = torch.full((), step.bias2, dtype=x.dtype, device=x.device)
    new = x + (-step.lr) * ((mu / bias1) / (torch.sqrt(nu / bias2) + step.eps))
    if boxed:
        new = box_project_plain(new, lo, hi)
    finite = torch.isfinite(value)
    improved = finite & (value < best_val)
    best.copy_(torch.where(improved, x, best))
    new_best_val.copy_(torch.where(improved, value, best_val))
    x.copy_(torch.where(finite, new, x))


def adam_box_step(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step,
                  signed=True, boxed=True):
    """One step of the optimization attack from the candidate's gradient on, in place.

    With ``signed`` the gradient's sign (``sign``) replaces it; Adam with the scalars
    ``step`` (an ``AdamStep``) advances the moments ``mu`` and ``nu`` in place and moves
    the NCHW candidate ``x``; with ``boxed`` the result is clamped to lo[c] <= x <= hi[c].
    If the step's loss ``value`` is finite, ``x`` takes the result, else it stays. If
    ``value`` is finite and below ``best_val``, ``best`` takes the candidate from before
    the step. ``new_best_val`` receives the lesser of the two: it is a second buffer,
    never ``best_val`` itself, so that the caller swaps the two after every step."""
    _check_box("adam_box_step", x, lo, hi)
    shape = x.shape
    if grad.shape != shape or mu.shape != shape or nu.shape != shape or best.shape != shape \
            or value.numel() != 1 or best_val.numel() != 1 or new_best_val.numel() != 1:
        raise ValueError("adam_box_step takes x, grad, mu, nu and best of one shape and "
                         "one-element value, best_val and new_best_val.")
    if new_best_val.data_ptr() == best_val.data_ptr():
        raise ValueError("adam_box_step writes new_best_val while it reads best_val: pass two buffers.")
    tensors = (x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val)
    stream = _build.launch_stream("adam_box_step", *tensors)
    if stream is None:
        return adam_box_step_plain(*tensors, step, signed, boxed)
    _build.check(_build.load_library().b4_adam_box_step(
        *(t.data_ptr() for t in tensors), x.numel(), x.shape[2] * x.shape[3], x.shape[1],
        step.lr, 1 - step.b1, step.b1, 1 - step.b2, step.b2, step.eps, step.bias1, step.bias2,
        int(signed) | int(boxed) << 1, stream), "b4_adam_box_step")
    adam_box_step.launches += 1


adam_box_step.launches = 0
