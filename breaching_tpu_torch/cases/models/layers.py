"""Building blocks of the port's model zoo (counterpart of ``breaching_tpu/cases/models/layers.py``).

- ``Conv`` and ``Dense`` draw weights and biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  the statistics of torch's default init, from an explicit generator.
- ``max_pool`` pads with -inf, as flax's ``max_pool`` does; ``avg_pool_global`` is
  the mean over height and width.
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
            with torch.no_grad():  # in place: the caller owns the buffers it passes
                n = self.num_batches_tracked
                count = x.numel() // x.shape[1]
                unbiased = var * count / max(count - 1, 1)
                self.running_mean.copy_((self.running_mean * n + mean) / (n + 1))
                self.running_var.copy_((self.running_var * n + unbiased) / (n + 1))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def max_pool(x: torch.Tensor, window: int, stride: int | None = None, padding: int = 0) -> torch.Tensor:
    """Max pooling over NCHW; padded places are -inf, so they never win."""
    return F.max_pool2d(x, window, stride or window, padding)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C): the mean over height and width."""
    return x.mean(dim=(2, 3))


def name_batchnorms(model: nn.Module) -> None:
    """Give each BatchNorm of ``model`` its module name, under which ``capture`` files
    its batch statistics."""
    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.name = name
