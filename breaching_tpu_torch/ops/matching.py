"""Gradient-matching kernels B1 and B2 and the fused cosine objective built on them.

Counterpart of ``breaching_tpu/ops/matching.py``. Kernels (``csrc/matching.cu``):

- B1 ``matching_sums`` replaces ``_matching_sums`` / Pallas ``_reduction_kernel``:
  (<rec, data>, |rec|^2, |data|^2) in one pass, float32 accumulation. Bound: 8 bytes
  per element over 3.35 TB/s. It writes into ``out`` where given, a row of the (T, 3)
  sums of the trials form.
- B2 ``axpby`` replaces ``_axpby`` / Pallas ``_axpby_kernel``: a x + b y with
  scalars a, b held on the device. Bound: 12 bytes per element over 3.35 TB/s.
- ``cosine_backward`` is B2 rebuilt for the cosine's VJP (``_cos_bwd``, which calls
  ``_axpby``): each thread forms a and b from B1's sums and the upstream gradient in
  registers, in ``_cos_bwd``'s order, then streams a x + b y. One launch in place of
  the eleven scalar launches and ``axpby``, and one launch for T rows (the trials form
  of ``fused_cosine_similarity_trials``). Bound: 12 bytes per element.

``fused_euclidean`` (B5, the JAX package's ``fused_euclidean``) is built on them:
B1 gives 0.5 (|r|^2 - 2 <r, d> + |d|^2) and ``axpby(g, rec, -g, data)`` its gradient
with respect to rec, one launch of each per evaluation.

Each kernel also has forms in other element types (csrc/precision.cu), for the
attack's precision knobs: B1, ``axpby`` and the cosine backward take a bfloat16 or
float16 gradient beside a float32 or bfloat16 target (``attack.impl.dtype``), summed in
float32, or float64 throughout (``case.impl.dtype=float64``), summed in float64. The
sums, the cosine's value and the scalars a, b, g are in the accumulation type
(``acc_dtype``); a gradient comes out in its vector's own type. The plain versions widen
half-precision operands to float32 the same way.

Each wrapper sends CUDA tensors to its kernel's op in PyTorch's dispatcher
(``torch.ops.breaching.*``, csrc/bindings.cpp), which checks shapes, devices, dtypes
and contiguity in C++ and raises for what the kernel does not take, and counts the
launch in its ``launches`` attribute (and by the element types in ``launches_by_type``);
it runs the plain PyTorch version (``*_plain``) only for CPU tensors, and raises for
anything else.
"""

from __future__ import annotations

import torch

from . import _build


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the kernels sum and scale ``x``'s elements in: float64 for float64, else
    float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def matching_sums_plain(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(rec)
    rec, data = rec.to(acc), data.to(acc)
    return torch.stack([(rec * data).sum(), (rec * rec).sum(), (data * data).sum()])


def matching_sums(rec: torch.Tensor, data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """(<rec, data>, |rec|^2, |data|^2) of two flat vectors, as a tensor of 3 in
    ``acc_dtype(rec)``, or written into ``out``, a contiguous tensor of 3 (a row of the
    trials' (T, 3) sums)."""
    if rec.is_cuda:
        if out is None:
            out = _build.op("matching_sums")(rec, data)
        else:
            _build.op("matching_sums_into")(rec, data, out)
        _build.count_launch(matching_sums, rec, data)
        return out
    if rec.dim() != 1 or rec.shape != data.shape or (out is not None and out.shape != (3,)):
        raise ValueError(f"matching_sums takes two flat vectors of one length and an out of 3, got "
                         f"{tuple(rec.shape)}, {tuple(data.shape)} and "
                         f"{None if out is None else tuple(out.shape)}.")
    _build.require_cpu("matching_sums", rec, data, *(() if out is None else (out,)))
    sums = matching_sums_plain(rec, data)
    return sums if out is None else out.copy_(sums)


matching_sums.launches = 0
matching_sums.launches_by_type = {}


def axpby_plain(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(x)
    return (a * x.to(acc) + b * y.to(acc)).to(x.dtype)


def axpby(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a x + b y for one-element tensors a, b (in ``acc_dtype(x)``) and flat vectors x, y of
    one length, in x's type."""
    if x.is_cuda:
        out = _build.op("axpby")(a, x, b, y)
        _build.count_launch(axpby, x, y)
        return out
    if x.dim() != 1 or x.shape != y.shape or a.numel() != 1 or b.numel() != 1:
        raise ValueError(f"axpby takes scalars a, b and flat x, y of one length, got "
                         f"{tuple(a.shape)}, {tuple(x.shape)}, {tuple(b.shape)}, {tuple(y.shape)}.")
    _build.require_cpu("axpby", a, x, b, y)
    return axpby_plain(a, x, b, y)


axpby.launches = 0
axpby.launches_by_type = {}


def cosine_backward_plain(sums, g, rec, data, wrt_data=False):
    """d/d rec of g (1 - <rec, data> / (|rec| |data| + 1e-12)), or d/d data if
    ``wrt_data``, from sums = (<rec, data>, |rec|^2, |data|^2): ``_cos_bwd``'s scalar
    arithmetic, then ``axpby_plain``. Flat rec and data with sums (3,) and a one-element
    g, or T rows (T, n) with sums (T, 3) and g (T,), each row from its own sums and g."""
    dot, rec_sq, data_sq = sums.unbind(-1)
    rec_n, data_n = torch.sqrt(rec_sq), torch.sqrt(data_sq)
    shape = (-1, 1) if rec.dim() == 2 else (1,)
    a = (-g / (rec_n * data_n + 1e-12)).reshape(shape)
    acc = sums.dtype
    if wrt_data:
        b = (g * dot / (data_n ** 3 * rec_n + 1e-12)).reshape(shape)
        return (a * rec.to(acc) + b * data.to(acc)).to(data.dtype)
    b = (g * dot / (rec_n ** 3 * data_n + 1e-12)).reshape(shape)
    return (a * data.to(acc) + b * rec.to(acc)).to(rec.dtype)


def cosine_backward(sums, g, rec, data, wrt_data=False):
    """The cosine distance's gradient with respect to rec (or data, if ``wrt_data``),
    times the upstream gradient g, from the sums of ``matching_sums``: for flat rec and
    data, sums (3,) and a one-element g; for T rows (T, n), sums (T, 3) and g (T,), in
    one launch."""
    if rec.is_cuda:
        out = _build.op("cosine_backward")(sums, g, rec, data, wrt_data)
        _build.count_launch(cosine_backward, rec, data)
        return out
    rows = rec.shape[0] if rec.dim() == 2 else None
    flat = rec.dim() == 1 and sums.shape == (3,) and g.numel() == 1
    stacked = rows is not None and sums.shape == (rows, 3) and g.shape == (rows,)
    if rec.shape != data.shape or not (flat or stacked):
        raise ValueError(f"cosine_backward takes flat rec, data of one length with sums (3,) and a one-element g, "
                         f"or rows (T, n) with sums (T, 3) and g (T,), got {tuple(sums.shape)}, {tuple(g.shape)}, "
                         f"{tuple(rec.shape)}, {tuple(data.shape)}.")
    _build.require_cpu("cosine_backward", sums, g, rec, data)
    return cosine_backward_plain(sums, g, rec, data, wrt_data)


cosine_backward.launches = 0
cosine_backward.launches_by_type = {}


def _cosine_value(sums):
    dot, rec_sq, data_sq = sums.unbind(-1)
    return 1.0 - dot / (torch.sqrt(rec_sq) * torch.sqrt(data_sq) + 1e-12)


class _FusedCosine(torch.autograd.Function):
    """1 - <rec, data> / (|rec| |data| + 1e-12): B1 forward, B2's cosine backward
    (``fused_cosine_similarity`` and ``_cos_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, rec, data):
        sums = matching_sums(rec, data)
        ctx.save_for_backward(rec, data, sums)
        return _cosine_value(sums)

    @staticmethod
    def backward(ctx, g):
        rec, data, sums = ctx.saved_tensors
        g = g.contiguous()
        d_rec = cosine_backward(sums, g, rec, data) if ctx.needs_input_grad[0] else None
        d_data = cosine_backward(sums, g, rec, data, wrt_data=True) if ctx.needs_input_grad[1] else None
        return d_rec, d_data


def fused_cosine_similarity(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Cosine distance of two flat vectors through kernels B1 and B2, in
    ``acc_dtype(rec)``; its gradients come in the vectors' own types."""
    return _FusedCosine.apply(rec, data)


class _FusedCosineTrials(_FusedCosine):
    """``_FusedCosine`` of each row of (T, n) stacks (the JAX package vmaps
    ``fused_cosine_similarity`` over the trials): one B1 launch a row into the rows of
    one (T, 3) tensor, one value per row; its backward, ``_FusedCosine``'s, launches the
    cosine backward once for every row."""

    @staticmethod
    def forward(ctx, rec, data):
        if rec.dim() != 2 or rec.shape != data.shape:
            raise ValueError(f"fused_cosine_similarity_trials takes two (T, n) stacks of one shape, got "
                             f"{tuple(rec.shape)} and {tuple(data.shape)}.")
        sums = torch.empty(rec.shape[0], 3, dtype=acc_dtype(rec), device=rec.device)
        for r, d, row in zip(rec.unbind(), data.unbind(), sums.unbind()):
            matching_sums(r, d, out=row)
        ctx.save_for_backward(rec, data, sums)
        return _cosine_value(sums)


def fused_cosine_similarity_trials(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fused_cosine_similarity`` of each row of two contiguous (T, n) stacks: a
    (T,) vector, each entry equal to the row's own call, differentiable."""
    return _FusedCosineTrials.apply(rec, data)


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
    """0.5 |rec - data|^2 of two flat vectors through kernels B1 and B2, in
    ``acc_dtype(rec)``."""
    return _FusedEuclidean.apply(rec, data)


def fused_euclidean_plain(rec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``fused_euclidean``'s plain version: the same formula over the plain sums,
    differentiated by autograd."""
    dot, rec_sq, data_sq = matching_sums_plain(rec, data).unbind()
    return 0.5 * (rec_sq - 2 * dot + data_sq)
