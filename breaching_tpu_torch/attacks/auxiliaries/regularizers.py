"""Input-space regularizers (counterpart of ``breaching_tpu/attacks/auxiliaries/regularizers.py``).

Total variation runs through ``ops.total_variation``: one launch of the fused B3
kernel gives the scaled value and its gradient, the closed-form sign-divergence
gradient of the JAX package's ``_tv_p1q1`` and ``_make_tv_general``. Images are NCHW.
"""

from __future__ import annotations

import torch

from ...ops import total_variation


class TotalVariation:
    """Anisotropic TV with optional double-opponent color terms: per-pixel
    (|dx|+eps)^p and (|dy|+eps)^p, combined as (dx_p + dy_p)^q, mean-reduced
    (reference regularizers.py:103-153)."""

    def __init__(self, setup=None, scale=0.1, inner_exp=1, outer_exp=1,
                 double_opponents=False, eps=1e-8, **kwargs):
        self.scale = float(scale)
        self.inner_exp = float(inner_exp)
        self.outer_exp = float(outer_exp)
        self.eps = float(eps)
        self.double_opponents = bool(double_opponents)
        self._scales = {}  # device -> the scale as a one-element tensor, read by the kernel

    def initialize(self, models, shared_data=None, labels=None):
        pass

    def __call__(self, tensor, intermediates=None):
        x = tensor
        if self.double_opponents:
            x = torch.cat([x, x[:, 0:1] - x[:, 1:2], x[:, 0:1] - x[:, 2:3], x[:, 1:2] - x[:, 2:3]],
                          dim=1)
        scale = self._scales.get(x.device)
        if scale is None:
            scale = self._scales[x.device] = torch.full((1,), self.scale, dtype=x.dtype, device=x.device)
        return total_variation(x, self.inner_exp, self.outer_exp, self.eps, scale)

    def __repr__(self):
        return (f"Total Variation, scale={self.scale}. p={self.inner_exp} q={self.outer_exp}. "
                f"{'Color TV: double opponents' if self.double_opponents else ''}")


regularizer_lookup = dict(total_variation=TotalVariation)
