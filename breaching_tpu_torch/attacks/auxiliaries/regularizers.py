"""Input-space regularizers (counterpart of ``breaching_tpu/attacks/auxiliaries/regularizers.py``).

Total variation runs through ``ops.total_variation``: one launch of the fused B3
kernel gives the scaled value and its gradient, the closed-form sign-divergence
gradient of the JAX package's ``_tv_p1q1`` and ``_make_tv_general``. Images are NCHW.
``trials`` gives the value of each trial of a (T, N, C, H, W) stack, as the JAX
package's vmapped fleet does: each the mean over that trial's own elements.

``NormRegularization`` and ``OrthogonalityRegularization`` read the candidate
alone, as TV does. ``DeepInversion`` and ``FeatureRegularization`` read what the
objective's forward pass captured (``capture``, the counterpart of the JAX models'
``sow``), one dict per query: the BatchNorm batch statistics, which exist only in
train mode (so ``DeepInversion`` is 0 on a model whose BatchNorm runs on the
server's buffers, as in the JAX package), and the pre-head features. Both pair
layers in the JAX package's natural order of layer names (``_natural_key``).
"""

from __future__ import annotations

import re

import torch

from ...ops import total_variation, total_variation_trials
from ...cases.models.model_preparation import head_grads


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
        x = self._opponents(tensor)
        return total_variation(x, self.inner_exp, self.outer_exp, self.eps, self._scale(x))

    def trials(self, tensor):
        """(T,) values for a (T, N, C, H, W) stack of trials."""
        x = self._opponents(tensor)
        return total_variation_trials(x, self.inner_exp, self.outer_exp, self.eps, self._scale(x))

    def _opponents(self, x):
        if not self.double_opponents:
            return x
        c0, c1, c2 = x[..., 0:1, :, :], x[..., 1:2, :, :], x[..., 2:3, :, :]
        return torch.cat([x, c0 - c1, c0 - c2, c1 - c2], dim=-3)

    def _scale(self, x):
        scale = self._scales.get(x.device)
        if scale is None:
            scale = self._scales[x.device] = torch.full((1,), self.scale, dtype=x.dtype, device=x.device)
        return scale

    def __repr__(self):
        return (f"Total Variation, scale={self.scale}. p={self.inner_exp} q={self.outer_exp}. "
                f"{'Color TV: double opponents' if self.double_opponents else ''}")


class _CandidateRegularizer:
    """A regularizer of the candidate alone: nothing to initialize; ``trials`` takes
    each trial of a (T, N, C, H, W) stack in turn."""

    def initialize(self, models, shared_data=None, labels=None):
        pass

    def trials(self, tensor):
        return torch.stack([self(trial) for trial in tensor.unbind()])


class NormRegularization(_CandidateRegularizer):
    """L^p norm penalty on the candidate: mean(|x|^p) / p, scaled."""

    def __init__(self, setup=None, scale=0.1, pnorm=2.0, **kwargs):
        self.scale = float(scale)
        self.pnorm = float(pnorm)

    def __call__(self, tensor, intermediates=None):
        return 1.0 / self.pnorm * torch.pow(tensor.abs(), self.pnorm).mean() * self.scale

    def __repr__(self):
        return f"Input L^p norm regularization, scale={self.scale}, p={self.pnorm}"


class OrthogonalityRegularization(_CandidateRegularizer):
    """Pairwise orthogonality of the batch's images: the squared off-diagonal inner
    products over the number of pixels, summed and scaled; 0 for one image."""

    def __init__(self, setup=None, scale=0.1, **kwargs):
        self.scale = float(scale)

    def __call__(self, tensor, intermediates=None):
        if tensor.shape[0] == 1:
            return torch.zeros((), dtype=tensor.dtype, device=tensor.device)
        flat = tensor.reshape(tensor.shape[0], -1)
        products = torch.square(flat @ flat.T) / flat.shape[-1]
        return (products - torch.diag(torch.diag(products))).sum() * self.scale

    def __repr__(self):
        return f"Input Orthogonality, scale={self.scale}"


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _layer_order(names):
    """Layer names sorted as the JAX package sorts its paths (``/`` between levels)."""
    return sorted(names, key=lambda name: _natural_key(name.replace(".", "/")))


class DeepInversion:
    """BatchNorm statistics matching (Yin et al.): for each BN layer, in natural order,
    |var - running var| + |mean - running mean| (L2 norms), the first layer's times
    ``first_bn_multiplier``, summed and scaled. The running statistics are the
    buffers the attack's models carry; the batch statistics exist only in train mode."""

    def __init__(self, setup=None, scale=0.1, first_bn_multiplier=10, **kwargs):
        self.scale = float(scale)
        self.first_bn_multiplier = float(first_bn_multiplier)
        self._targets = None

    def initialize(self, models, shared_data=None, labels=None):
        self._targets = []
        for model in models:
            layers = {name[:-len(".running_mean")] for name in model.buffers if name.endswith(".running_mean")}
            self._targets.append([(model.buffers[f"{layer}.running_mean"], model.buffers[f"{layer}.running_var"])
                                  for layer in _layer_order(layers) if f"{layer}.running_var" in model.buffers])

    def __call__(self, tensor, intermediates=None):
        total = torch.zeros((), dtype=tensor.dtype, device=tensor.device)
        for captured, targets in zip(intermediates or [], self._targets or []):
            stats = captured.get("bn_stats", {})
            for i, (layer, (t_mean, t_var)) in enumerate(zip(_layer_order(stats), targets)):
                mean, var = stats[layer]
                mult = self.first_bn_multiplier if i == 0 else 1.0
                total = total + mult * (torch.linalg.vector_norm(var - t_var)
                                        + torch.linalg.vector_norm(mean - t_mean))
        return self.scale * total

    def __repr__(self):
        return (f"Deep Inversion Regularization (BN matching), scale={self.scale}, "
                f"first-bn-mult={self.first_bn_multiplier}")


class FeatureRegularization:
    """Match the pre-head features to those the head's gradients imply: row y of the
    weight gradient over entry y of the bias gradient, for each label y (rows whose
    bias gradient is within 1e-10 of 0 divide by infinity)."""

    def __init__(self, setup=None, scale=0.1, **kwargs):
        self.scale = float(scale)
        self.measured_features = None

    def initialize(self, models, shared_data=None, labels=None):
        self.measured_features = []
        for model, user_data in zip(models, shared_data):
            w_grad, b_grad = head_grads(user_data["gradients"], model.module)
            b = b_grad[:, None]
            debiased = w_grad / torch.where(b.abs() > 1e-10, b, torch.full_like(b, float("inf")))
            self.measured_features.append(debiased[torch.as_tensor(labels, device=debiased.device).long()])

    def __call__(self, tensor, intermediates=None):
        total = torch.zeros((), dtype=tensor.dtype, device=tensor.device)
        for captured, measured in zip(intermediates or [], self.measured_features or []):
            if "features" in captured:
                total = total + torch.square(captured["features"] - measured).mean()
        return total * self.scale

    def __repr__(self):
        return f"Feature space regularization, scale={self.scale}"


regularizer_lookup = dict(
    total_variation=TotalVariation,
    orthogonality=OrthogonalityRegularization,
    norm=NormRegularization,
    deep_inversion=DeepInversion,
    features=FeatureRegularization,
)
# the regularizers that read what the objective's forward captured (inside the matching graph)
CAPTURING = (DeepInversion, FeatureRegularization)
