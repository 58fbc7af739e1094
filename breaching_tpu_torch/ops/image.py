"""Image-space kernels B3 (total variation) and B4 (box clamp).

Counterpart of ``breaching_tpu/ops/image.py``, on NCHW batches (the JAX package
is NHWC, so the TV stencil runs along dims 3 and 2 here). Kernels
(``csrc/image.cu``):

- B3 ``tv_forward`` replaces ``fused_total_variation`` / Pallas ``_tv_kernel``;
  bound 4 bytes per element over 3.35 TB/s. Off the attack step since
  ``tv_value_and_grad``, whose kernel it runs in its value-only form (one launch).
- ``tv_value_and_grad`` is B3 rebuilt for the attack step: the TV's value times a
  scale and its gradient, the sign-divergence formula of ``regularizers._tv_p1q1_bwd``
  and ``_make_tv_general`` that the TPU kernel lacks, in one launch; bound 8 bytes
  per element. ``tv_value_and_grad_trials`` gives T trials' values and gradients in
  the same one launch. ``tv_backward`` is its gradient alone.
- B4 ``box_project`` replaces ``box_project`` / Pallas ``_box_kernel``; bound 8 bytes
  per element. At the attack's 12 KB its cost is the host's and the launch's, so its
  wrapper's path is lean and takes an ``out`` that may be its input (in place).
- ``adam_box_step`` is B4 rebuilt as the attack's whole step tail: the hard or soft
  sign, optax's Adam, the box clamp, the finite guard and the best-iterate update, which
  the JAX package runs as one XLA fusion with ``jnp.clip`` in place of the box
  kernel (``breaching_tpu/attacks/optimization_based_attack.py:206-217, 401-466``).
  One launch in place of about 23; bound at most 32 bytes per element.
  ``adam_box_step_trials`` takes T trials stacked (T, N, C, H, W), each with its own
  loss and best value, in the same one launch. Its soft sign takes ``tanhf``, which
  need not round as PyTorch's tanh does; on the H100 it gave the plain version's bits
  at every shape ``chip_smoke.py`` checks.

``tv_value_and_grad`` (and its trials form), ``box_project`` and ``adam_box_step`` (and
its trials form) also take float64 and bfloat16 candidates (``case.impl.dtype``), in forms
of csrc/precision.cu: float64 is summed and multiplied in float64; bfloat16 is widened
to float32, computed and summed there, and rounded back on store (Adam's moments too,
which stay in the candidate's type as optax keeps them). The plain versions do the same
(``matching.acc_dtype``). ``adam_box_step``'s loss and best values are then in the candidate's
accumulation type, float64 or float32. ``tv_forward`` stays float32 only.

Each wrapper sends CUDA tensors to its kernel's op in PyTorch's dispatcher
(``torch.ops.breaching.*``, csrc/bindings.cpp), which checks shapes, devices, dtypes
and contiguity in C++ and raises for what the kernel does not take, and counts the
launch in its ``launches`` attribute (and by the element types in ``launches_by_type``);
it runs the plain PyTorch version (``*_plain``) only for CPU tensors, and raises for
anything else.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .matching import acc_dtype


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
    if images.is_cuda:
        out = _build.op("tv_forward")(images, inner_exp, outer_exp, eps, _tv_workspace(images.get_device()))
        _build.count_launch(tv_forward, images)
        return out
    _check_images("tv_forward", images)
    _build.require_cpu("tv_forward", images)
    return tv_forward_plain(images, inner_exp, outer_exp, eps)


tv_forward.launches = 0
tv_forward.launches_by_type = {}


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
    wide = acc_dtype(images)
    x, s = images.to(wide), scale.to(wide)
    return ((tv_forward_plain(x, inner_exp, outer_exp, eps) * s.reshape(())).to(images.dtype),
            tv_backward_plain(x, s, inner_exp, outer_exp, eps).to(images.dtype))


def tv_value_and_grad_trials_plain(images, scale, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """``tv_value_and_grad_plain`` applied to each trial of a (T, N, C, H, W) stack: (T,)
    values and the (T, N, C, H, W) gradient."""
    values, grads = zip(*(tv_value_and_grad_plain(trial, scale, inner_exp, outer_exp, eps)
                          for trial in images.unbind()))
    return torch.stack(values), torch.stack(grads)


# The kernel's workspace: a 64-bit slot per tile for its partial sum (csrc/image.cu
# TVWorkspace, 2 * 16384 4-byte words), zeroed once and left zeroed by every launch. One
# per device and stream, since launches on two streams may overlap; kept for good, since
# a captured CUDA graph holds its address.
_TV_WORKSPACE_WORDS = 2 * 16384
_tv_workspaces = {}  # (device index, stream handle) -> workspace
_tv_spares = {}  # device index -> workspaces zeroed outside graph capture, not yet taken


def _tv_workspace(device_index):
    key = (device_index, torch._C._cuda_getCurrentRawStream(device_index))
    workspace = _tv_workspaces.get(key)
    if workspace is None:
        # a stream first seen while it is being captured takes a workspace zeroed before:
        # a zeroing captured into the graph would run only when the graph is replayed
        spares = _tv_spares.setdefault(device_index, [])
        if not spares:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("tv_value_and_grad / tv_forward: run one on this device before capturing a "
                                   "CUDA graph, so that its workspace is zeroed outside the capture.")
            device = torch.device("cuda", device_index)
            spares.extend(torch.zeros(8, _TV_WORKSPACE_WORDS, dtype=torch.int32, device=device).unbind())
            torch.cuda.current_stream(device).synchronize()  # zeroed before any stream takes one
        workspace = _tv_workspaces[key] = spares.pop()
    return workspace


def _tv_launch(images, scale, inner_exp, outer_exp, eps, segments):
    """The kernel through the dispatcher's op: (segments,) values (a 0-dim value for
    segments = 0, the whole batch) and the gradient."""
    out = _build.op("tv_value_and_grad")(images, scale, inner_exp, outer_exp, eps, segments,
                                         _tv_workspace(images.get_device()))
    _build.count_launch(tv_value_and_grad, images)
    return out


def tv_value_and_grad(images, scale, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """(scale * tv_forward(images), scale * d tv_forward / d images) of an NCHW batch,
    for a one-element tensor ``scale``: a 0-dim value and a gradient of the images' shape.

    For CUDA images the dispatcher's op (csrc/bindings.cpp) checks shapes, devices,
    dtypes and contiguity in C++ and raises for what the kernel does not take; for CPU
    tensors the plain version runs."""
    if images.is_cuda:
        return _tv_launch(images, scale, inner_exp, outer_exp, eps, 0)
    _check_images("tv_value_and_grad", images)
    if scale.numel() != 1:
        raise ValueError(f"tv_value_and_grad takes a one-element scale, got {tuple(scale.shape)}.")
    _build.require_cpu("tv_value_and_grad", images, scale)
    return tv_value_and_grad_plain(images, scale, inner_exp, outer_exp, eps)


tv_value_and_grad.launches = 0
tv_value_and_grad.launches_by_type = {}


def tv_value_and_grad_trials(images, scale, inner_exp=1.0, outer_exp=1.0, eps=1e-8):
    """``tv_value_and_grad`` of each trial of a contiguous (T, N, C, H, W) stack, each the
    mean over that trial's own elements: (T,) values and the (T, N, C, H, W) gradient. On
    the card one launch of the kernel takes every trial, as one segment each."""
    if images.dim() != 5 or not images.is_contiguous():
        raise ValueError(f"tv_value_and_grad_trials takes a contiguous (T, N, C, H, W) stack, got "
                         f"{tuple(images.shape)}.")
    if images.is_cuda:
        values, grad = _tv_launch(images.view(-1, *images.shape[2:]), scale, inner_exp, outer_exp, eps,
                                  images.shape[0])
        return values, grad.view(images.shape)
    if images.numel() == 0 or scale.numel() != 1:
        raise ValueError(f"tv_value_and_grad_trials takes a non-empty stack and a one-element scale, got "
                         f"{tuple(images.shape)} and {tuple(scale.shape)}.")
    _build.require_cpu("tv_value_and_grad_trials", images, scale)
    return tv_value_and_grad_trials_plain(images, scale, inner_exp, outer_exp, eps)


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


class _TotalVariationTrials(torch.autograd.Function):
    """scale * TV of each trial of a (T, N, C, H, W) stack, the mean over that trial's
    own elements: one ``tv_value_and_grad_trials`` call for every trial."""

    @staticmethod
    def forward(ctx, images, scale, inner_exp, outer_exp, eps):
        values, grad = tv_value_and_grad_trials(images, scale, inner_exp, outer_exp, eps)
        ctx.save_for_backward(grad)
        return values

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return grad * g.reshape(-1, *(1,) * (grad.dim() - 1)), None, None, None, None


def total_variation_trials(images, inner_exp=1.0, outer_exp=1.0, eps=1e-8, scale=None):
    """``total_variation`` of each trial of a contiguous (T, N, C, H, W) stack: a (T,)
    vector, differentiable."""
    if scale is None:
        scale = torch.ones(1, dtype=images.dtype, device=images.device)
    return _TotalVariationTrials.apply(images, scale, float(inner_exp), float(outer_exp), float(eps))


def box_project_plain(x, lo, hi, out=None):
    lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
    if out is None:
        return torch.minimum(torch.maximum(x, lo4), hi4)
    return torch.minimum(torch.maximum(x, lo4, out=out), hi4, out=out)


def _check_box(name, x, lo, hi):
    if x.dim() != 4 or lo.shape != (x.shape[1],) or hi.shape != (x.shape[1],):
        raise ValueError(f"{name} takes an NCHW batch and bounds of shape (C,), got "
                         f"{tuple(x.shape)}, {tuple(lo.shape)}, {tuple(hi.shape)}.")


def box_project(x, lo, hi, out=None):
    """Clamp an NCHW batch to the per-channel bounds lo[c] <= x <= hi[c], into a new
    tensor, or into ``out`` of x's shape, which may be ``x`` itself (in place)."""
    if x.is_cuda:
        if out is None:
            out = _build.op("box_project")(x, lo, hi)
        else:
            _build.op("box_project_out")(x, lo, hi, out)
        _build.count_launch(box_project, x)
        return out
    _check_box("box_project", x, lo, hi)
    if out is not None and out.shape != x.shape:
        raise ValueError(f"box_project writes into an out of x's shape {tuple(x.shape)}, got {tuple(out.shape)}.")
    _build.require_cpu("box_project", x, lo, hi, *(() if out is None else (out,)))
    return box_project_plain(x, lo, hi, out)


box_project.launches = 0
box_project.launches_by_type = {}


class AdamStep(NamedTuple):
    """The host scalars of one optax Adam step: the step size and the bias corrections
    1 - b1^t and 1 - b2^t, float32 values as optax computes them, the decay rates and eps."""
    lr: float
    b1: float
    b2: float
    eps: float
    bias1: float
    bias2: float


def soft_sign_scalars(iteration: int, max_iterations: int) -> tuple[float, float]:
    """(s, max(s, 1e-3)) of the soft sign at ``iteration``, s = 1 - iteration /
    max_iterations, in float32 as the JAX package's ``transform_grads`` forms them."""
    s = np.float32(1.0) - np.float32(iteration) / np.float32(max_iterations)
    return float(s), float(np.maximum(s, np.float32(1e-3)))


def soft_sign_plain(grad, soft_scale):
    """tanh(grad s) / max(s, 1e-3) for ``soft_scale`` = (s, max(s, 1e-3))."""
    s, div = (torch.full((), v, dtype=grad.dtype, device=grad.device) for v in soft_scale)
    return torch.tanh(grad * s) / div


def _sign_mode(signed, soft_scale):
    """0 (none), 1 (hard) or 4 (soft) from ``signed`` (False/None, True/"hard" or "soft")."""
    if signed == "soft":
        if soft_scale is None:
            raise ValueError("The soft sign takes soft_scale = (s, max(s, 1e-3)).")
        return 4
    if signed in (True, "hard"):
        return 1
    if signed in (False, None):
        return 0
    raise ValueError(f"signed must be False, True, 'hard' or 'soft', got {signed!r}.")


def adam_box_step_plain(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step,
                        signed=True, boxed=True, soft_scale=None):
    mode = _sign_mode(signed, soft_scale)
    wide = acc_dtype(x)  # a half-precision candidate is computed in float32, stored rounded
    grad = grad.to(wide)
    sign_grad = sign(grad) if mode == 1 else soft_sign_plain(grad, soft_scale) if mode == 4 else grad
    mu.copy_((1 - step.b1) * sign_grad + step.b1 * mu.to(wide))
    nu.copy_((1 - step.b2) * (sign_grad * sign_grad) + step.b2 * nu.to(wide))
    # divide by tensors: CUDA divides by a host scalar as a product with its reciprocal
    bias1 = torch.full((), step.bias1, dtype=wide, device=x.device)
    bias2 = torch.full((), step.bias2, dtype=wide, device=x.device)
    new = (x.to(wide) + (-step.lr) * ((mu.to(wide) / bias1) / (torch.sqrt(nu.to(wide) / bias2) + step.eps))).to(x.dtype)
    if boxed:
        new = box_project_plain(new, lo, hi)
    finite = torch.isfinite(value)
    improved = finite & (value < best_val)
    best.copy_(torch.where(improved, x, best))
    new_best_val.copy_(torch.where(improved, value, best_val))
    x.copy_(torch.where(finite, new, x))


def adam_box_step_trials_plain(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, step,
                               signed=True, boxed=True, soft_scale=None):
    """``adam_box_step_plain`` on each trial of a (T, N, C, H, W) stack in turn, with the
    trial's own loss, best value and new best value."""
    for t in range(x.shape[0]):
        adam_box_step_plain(x[t], grad[t], mu[t], nu[t], best[t], lo, hi, values[t], best_vals[t],
                            new_best_vals[t], step, signed, boxed, soft_scale)


def _adam_launch(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, step, signed, boxed,
                 soft_scale):
    """The kernel through the dispatcher's op, one launch for a candidate or a stack."""
    mode = _sign_mode(signed, soft_scale)
    s, div = soft_scale if mode == 4 else (1.0, 1.0)
    _build.op("adam_box_step")(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, *step, s, div,
                               mode | int(boxed) << 1)
    _build.count_launch(adam_box_step, x)


def _check_adam(name, x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, stacked):
    """The plain route's checks: a non-empty NCHW candidate (a (T, N, C, H, W) stack if
    ``stacked``), grad, mu, nu and best of its shape, bounds of shape (C,), one element
    each in values, best_vals and new_best_vals (T each for a stack), the last two in two
    buffers, all on the CPU."""
    shape = x.shape
    if x.dim() != (5 if stacked else 4) or x.numel() == 0 or any(t.shape != shape for t in (grad, mu, nu, best)) \
            or lo.shape != (shape[-3],) or hi.shape != (shape[-3],):
        raise ValueError(f"{name} takes a non-empty {'(T, N, C, H, W) stack' if stacked else 'NCHW candidate'} x "
                         f"with grad, mu, nu and best of its shape and bounds of shape (C,), got "
                         f"{[tuple(t.shape) for t in (x, grad, mu, nu, best, lo, hi)]}.")
    per_trial = (values, best_vals, new_best_vals)
    if not all(t.shape == (shape[0],) if stacked else t.numel() == 1 for t in per_trial):
        raise ValueError(f"{name} takes {f'({shape[0]},)' if stacked else 'one-element'} values, best_vals "
                         f"and new_best_vals, got {[tuple(t.shape) for t in per_trial]}.")
    if new_best_vals.data_ptr() == best_vals.data_ptr():
        raise ValueError(f"{name} writes new_best_vals while it reads best_vals: pass two buffers.")
    _build.require_cpu(name, x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals)


def adam_box_step(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step,
                  signed=True, boxed=True, soft_scale=None):
    """One step of the optimization attack from the candidate's gradient on, in place.

    With ``signed`` True (or "hard") the gradient's sign (``sign``) replaces it; with
    "soft", tanh(g s) / max(s, 1e-3) for ``soft_scale`` = (s, max(s, 1e-3))
    (``soft_sign_scalars``); Adam with the scalars
    ``step`` (an ``AdamStep``) advances the moments ``mu`` and ``nu`` in place and moves
    the NCHW candidate ``x``; with ``boxed`` the result is clamped to lo[c] <= x <= hi[c].
    If the step's loss ``value`` is finite, ``x`` takes the result, else it stays. If
    ``value`` is finite and below ``best_val``, ``best`` takes the candidate from before
    the step. ``new_best_val`` receives the lesser of the two: it is a second buffer,
    never ``best_val`` itself, so that the caller swaps the two after every step."""
    if x.is_cuda:
        return _adam_launch(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step, signed, boxed,
                            soft_scale)
    _check_adam("adam_box_step", x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, False)
    adam_box_step_plain(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step, signed, boxed,
                        soft_scale)


adam_box_step.launches = 0
adam_box_step.launches_by_type = {}


def adam_box_step_trials(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, step,
                         signed=True, boxed=True, soft_scale=None):
    """``adam_box_step`` for T trials stacked on a leading axis, (T, N, C, H, W), each with
    its own loss, best value and best iterate: ``values``, ``best_vals`` and
    ``new_best_vals`` hold one entry per trial; the step's scalars are shared. On the
    card one launch takes every trial, each trial's result equal to its own call's bits."""
    if x.is_cuda:
        return _adam_launch(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, step, signed, boxed,
                            soft_scale)
    _check_adam("adam_box_step_trials", x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, True)
    adam_box_step_trials_plain(x, grad, mu, nu, best, lo, hi, values, best_vals, new_best_vals, step, signed,
                               boxed, soft_scale)
