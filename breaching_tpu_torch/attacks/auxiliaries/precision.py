"""``attack.impl.mixed_precision``: bfloat16 operands for every convolution and matrix
product of the attack's step.

The JAX package runs its attack chunk under ``jax.default_matmul_precision("bfloat16")``
(``breaching_tpu/attacks/optimization_based_attack.py:475-530``): XLA then rounds both
operands of each convolution and dot, forward and backward alike, to bfloat16 and
accumulates their products in float32. PyTorch has no switch that does this for
convolutions (TF32, ``allow_tf32``, keeps a 10-bit mantissa: another rounding, and the
port keeps it off), so ``bfloat16_operands`` is a ``TorchDispatchMode`` below autograd:
each ``aten`` convolution, its backward (the double backward's convolutions are
``aten`` convolutions again) and each matrix product (``mm``, ``addmm``, ``bmm``,
``baddbmm``) gets its float32 operands rounded to bfloat16 and back, then runs in
float32, which accumulates the exact products of bfloat16 values in float32. Biases and
additive terms are not operands of the product and stay as they are. It rounds; it
does not make the step faster.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
# op -> the positions of its product operands
_OPERANDS = {
    _aten.convolution.default: (0, 1),
    _aten.convolution_backward.default: (0, 1, 2),
    _aten.mm.default: (0, 1),
    _aten.bmm.default: (0, 1),
    _aten.addmm.default: (1, 2),
    _aten.baddbmm.default: (1, 2),
}


def round_to_bfloat16(x):
    """A float32 tensor's values rounded to bfloat16 and kept in float32; anything else
    as it is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class bfloat16_operands(TorchDispatchMode):
    """Inside, every convolution and matrix product takes bfloat16-rounded operands and
    accumulates in float32 (module docstring); ``rounded`` counts the ops it rounded."""

    def __init__(self):
        super().__init__()
        self.rounded = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        positions = _OPERANDS.get(func)
        if positions is not None:
            args = tuple(round_to_bfloat16(a) if i in positions else a for i, a in enumerate(args))
            self.rounded += 1
        return func(*args, **(kwargs or {}))
