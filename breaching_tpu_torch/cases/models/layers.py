"""Building blocks of the port's model zoo (counterpart of ``breaching_tpu/cases/models/layers.py``).

- ``Conv`` and ``Dense`` draw weights and biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  the statistics of torch's default init, from an explicit generator.
- ``max_pool`` pads with -inf, as flax's ``max_pool`` does; ``avg_pool_global`` is
  the mean over height and width.
- ``GroupNorm`` and ``LayerNorm`` are flax's: statistics with var = E[x^2] - mean^2
  (clipped at 0) and eps 1e-6, where torch's modules take the two-pass variance and
  1e-5.
- The weight bridge (``model_preparation.load_flat_state``) names a ``Conv`` and a
  ``Dense`` as the JAX package's wrappers do (``<name>/conv/kernel``,
  ``<name>/dense/kernel``); a layer made with ``direct`` is a flax ``nn.Conv`` or
  ``nn.Dense`` used without the wrapper (``<name>/kernel``). A module with parameters
  of its own layout lists them in ``flax_entries``.
- ``BatchNorm`` is the JAX package's BatchNorm, not ``nn.BatchNorm2d``: in train
  mode it normalizes with var = E[x^2] - mean^2 and folds the batch statistics into
  a cumulative running average (torch's ``momentum=None``), so after one batch the
  running statistics are exactly that batch's.
- ``capture``: the counterpart of the JAX models' ``sow`` into 'intermediates'. A
  forward given a dict collects the pre-head features under "features" and, in train
  mode only (as the JAX BatchNorm sows only there), each BatchNorm's batch (mean,
  var) under "bn_stats", keyed by the layer's module name (``name_batchnorms``). The
  tensors are the forward's own, not copies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init


def _uniform_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)


def Conv(in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
         use_bias: bool = True, generator: torch.Generator | None = None) -> nn.Conv2d:
    """A Conv2d padded by kernel_size // 2 on each side, biased unless ``use_bias=False``."""
    conv = skip_init(nn.Conv2d, in_channels, out_channels, kernel_size, stride,
                     padding=kernel_size // 2, bias=use_bias)
    fan_in = in_channels * kernel_size * kernel_size
    _uniform_(conv.weight, fan_in, generator)
    if use_bias:
        _uniform_(conv.bias, fan_in, generator)
    return conv


def Dense(in_features: int, out_features: int, generator: torch.Generator | None = None) -> nn.Linear:
    dense = skip_init(nn.Linear, in_features, out_features)
    _uniform_(dense.weight, in_features, generator)
    _uniform_(dense.bias, in_features, generator)
    return dense


def direct(layer: nn.Module) -> nn.Module:
    """Mark a Conv2d or Linear as a flax ``nn.Conv`` or ``nn.Dense`` used directly, whose
    parameters the JAX package names ``<name>/kernel`` and ``<name>/bias``."""
    layer.flax_direct = True
    return layer


def lecun_normal_(tensor: torch.Tensor, fan_in: int, generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two standard deviations, with variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std, generator=generator)


def _fast_normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) over ``dims``, with flax's var = E[x^2] - mean^2
    clipped at 0."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0)
    return (x - mean) * torch.rsqrt(var + eps)


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm`` over NCHW: ``num_groups`` groups of consecutive channels,
    capped at the channel count, eps 1e-6 (the JAX package's ``layers.GroupNorm``, whose
    parameters it names ``<name>/gn/scale`` and ``<name>/gn/bias``)."""

    def __init__(self, features: int, num_groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.num_groups = min(num_groups, features)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        y = _fast_normalize(x.reshape(x.shape[0], self.num_groups, -1), -1, self.eps).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/gn/scale", self.weight, None
        yield f"params/{prefix}/gn/bias", self.bias, None


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last dimension, eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _fast_normalize(x, -1, self.eps) * self.weight + self.bias

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/scale", self.weight, None
        yield f"params/{prefix}/bias", self.bias, None


# ``train=TRIALS``: BatchNorm normalizes by the batch's statistics and leaves its running
# statistics unwritten. Under ``torch.func.vmap`` over the attack's trials each trial has its
# own batch statistics, which no buffer of the shared model could take (the JAX package's
# vmap returns its updated statistics unused).
TRIALS = "trials"


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with cumulative running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros(()))

    name = ""  # the module name under which ``capture`` files its batch statistics

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(dim=axes)
            var = (x * x).mean(dim=axes) - mean * mean
            if capture is not None:
                capture.setdefault("bn_stats", {})[self.name] = (mean, var)
            if train != TRIALS:
                self._update_running_stats(x, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)

    def _update_running_stats(self, x, mean, var):
        with torch.no_grad():  # in place: the caller owns the buffers it passes
            n = self.num_batches_tracked
            count = x.numel() // x.shape[1]
            unbiased = var * count / max(count - 1, 1)
            self.running_mean.copy_((self.running_mean * n + mean) / (n + 1))
            self.running_var.copy_((self.running_var * n + unbiased) / (n + 1))
            self.num_batches_tracked.add_(1)


def max_pool(x: torch.Tensor, window: int, stride: int | None = None, padding: int = 0) -> torch.Tensor:
    """Max pooling over NCHW; padded places are -inf, so they never win."""
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """flax's ``avg_pool`` with a window and stride of ``window``, no padding."""
    return F.avg_pool2d(x, window, window)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C): the mean over height and width."""
    return x.mean(dim=(2, 3))


def name_batchnorms(model: nn.Module) -> None:
    """Give each BatchNorm of ``model`` its module name, under which ``capture`` files
    its batch statistics."""
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.name = name
