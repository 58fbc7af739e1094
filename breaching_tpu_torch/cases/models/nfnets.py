"""Normalizer-free networks, NFNet-F0 to F7 (counterpart of
``breaching_tpu/cases/models/nfnets.py``), NCHW.

Scaled weight-standardized convolutions (``WSConv``: each output channel's kernel
standardized with its unbiased variance, times sqrt(fan_in) floored at eps 1e-4 inside
the root, times a learned gain), the variance-preserving activations (``_vp_act``: GELU
in flax's tanh form, or ReLU, times its gain), four-convolution bottleneck blocks
(``NFBlock``: 1x1, grouped 3x3 with the stride, grouped 3x3, 1x1, groups of 128
channels) with squeeze-excite scaled by 2, a zero-initialized ``skip_gain`` and an
average-pool shortcut where a block downsamples, the blocks' input scale beta reset at
each stage's start, a final 1x1 convolution to twice the width, and a dense head named
``linear`` (N(0, 0.01) kernel). Stochastic depth and dropout are left out, as in the JAX
package: attacks run the model in eval mode, where both are the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, avg_pool, avg_pool_global

_VP_GAINS = {"gelu": 1.7015043497085571, "relu": 1.7139588594436646}

nfnet_params = {
    "F0": {"width": [256, 512, 1536, 1536], "depth": [1, 2, 6, 3]},
    "F1": {"width": [256, 512, 1536, 1536], "depth": [2, 4, 12, 6]},
    "F2": {"width": [256, 512, 1536, 1536], "depth": [3, 6, 18, 9]},
    "F3": {"width": [256, 512, 1536, 1536], "depth": [4, 8, 24, 12]},
    "F4": {"width": [256, 512, 1536, 1536], "depth": [5, 10, 30, 15]},
    "F5": {"width": [256, 512, 1536, 1536], "depth": [6, 12, 36, 18]},
    "F6": {"width": [256, 512, 1536, 1536], "depth": [7, 14, 42, 21]},
    "F7": {"width": [256, 512, 1536, 1536], "depth": [8, 16, 48, 24]},
}


def _vp_act(x: torch.Tensor, activation: str) -> torch.Tensor:
    name = activation.lower()
    y = F.gelu(x, approximate="tanh") if name == "gelu" else F.relu(x)
    return y * _VP_GAINS[name]


class WSConv(nn.Module):
    """A scaled weight-standardized convolution, padded by ``padding`` on each side
    (kernel_size // 2 unless given; the stem's are unpadded), with flax's Xavier-normal
    kernel, unit gain and zero bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: int | None = None, groups: int = 1, generator=None):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.padding = kernel_size // 2 if padding is None else padding
        self.fan_in = kernel_size * kernel_size * (in_channels // groups)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
        fan_out = kernel_size * kernel_size * out_channels
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (self.fan_in + fan_out)), generator=generator)
        self.gain = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = self.weight.mean(dim=(1, 2, 3), keepdim=True)
        var = self.weight.var(dim=(1, 2, 3), keepdim=True, unbiased=True)
        weight = (self.weight - mean) * torch.rsqrt(torch.clamp(var * self.fan_in, min=1e-4))
        weight = weight * self.gain.reshape(-1, 1, 1, 1)
        return F.conv2d(x, weight, self.bias, self.stride, self.padding, groups=self.groups)

    def flax_entries(self, prefix: str):
        from .model_preparation import conv_kernel

        yield f"params/{prefix}/kernel", self.weight, conv_kernel
        yield f"params/{prefix}/gain", self.gain, None
        yield f"params/{prefix}/bias", self.bias, None


class Stem(nn.Module):
    """Four unpadded 3x3 convolutions of 16, 32, 64, 128 channels, the stem's stride on
    the first and the last."""

    def __init__(self, in_channels: int, stride: int = 2, activation: str = "gelu", generator=None):
        super().__init__()
        self.activation = activation
        self.conv0 = WSConv(in_channels, 16, 3, stride, padding=0, generator=generator)
        self.conv1 = WSConv(16, 32, 3, padding=0, generator=generator)
        self.conv2 = WSConv(32, 64, 3, padding=0, generator=generator)
        self.conv3 = WSConv(64, 128, 3, stride, padding=0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv0, self.conv1, self.conv2):
            x = _vp_act(conv(x), self.activation)
        return self.conv3(x)


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, ratio: float = 0.5, activation: str = "gelu", generator=None):
        super().__init__()
        hidden = max(int(features * ratio), 1)
        self.activation = activation
        self.fc0 = Dense(features, hidden, generator=generator)
        self.fc1 = Dense(hidden, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = _vp_act(self.fc0(avg_pool_global(x)), self.activation)
        return torch.sigmoid(self.fc1(s))[:, :, None, None]


class NFBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1, alpha: float = 0.2, beta: float = 1.0,
                 se_ratio: float = 0.5, group_size: int = 128, activation: str = "gelu", generator=None):
        super().__init__()
        self.stride, self.alpha, self.beta, self.activation = stride, alpha, beta, activation
        width = int(features * 0.5)
        groups = max(width // group_size, 1)
        width = group_size * groups if width >= group_size else width
        self.conv_shortcut = None
        if stride > 1 or in_features != features:
            self.conv_shortcut = WSConv(in_features, features, 1, generator=generator)
        self.conv0 = WSConv(in_features, width, 1, generator=generator)
        self.conv1 = WSConv(width, width, 3, stride, groups=groups, generator=generator)
        self.conv1b = WSConv(width, width, 3, groups=groups, generator=generator)
        self.conv2 = WSConv(width, features, 1, generator=generator)
        self.squeeze_excite = SqueezeExcite(features, se_ratio, activation, generator)
        self.skip_gain = nn.Parameter(torch.zeros(()))

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/skip_gain", self.skip_gain, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _vp_act(x, self.activation) * self.beta
        if self.stride > 1:
            shortcut = self.conv_shortcut(avg_pool(out, 2))
        elif self.conv_shortcut is not None:
            shortcut = self.conv_shortcut(out)
        else:
            shortcut = x
        y = _vp_act(self.conv0(out), self.activation)
        y = _vp_act(self.conv1(y), self.activation)
        y = _vp_act(self.conv1b(y), self.activation)
        y = self.conv2(y)
        y = (self.squeeze_excite(y) * 2.0) * y
        return y * self.alpha * self.skip_gain + shortcut


class NFNet(nn.Module):
    head_name = "linear"

    def __init__(self, num_classes: int = 1000, variant: str = "F0", stem: str = "ImageNet", alpha: float = 0.2,
                 se_ratio: float = 0.5, activation: str = "gelu", shape=(3, 224, 224), generator=None):
        super().__init__()
        params = nfnet_params[variant]
        self.activation = activation
        self.stem = Stem(shape[0], stride=2 if stem == "ImageNet" else 1, activation=activation, generator=generator)
        self.blocks = []  # module names in execution order
        expected_std, in_features = 1.0, params["width"][0] // 2
        for stage, (width, depth, stride) in enumerate(zip(params["width"], params["depth"], (1, 2, 2, 2))):
            for block_index in range(depth):
                name = f"stage{stage}_block{block_index}"
                self.add_module(name, NFBlock(in_features, width, stride if block_index == 0 else 1, alpha,
                                              1.0 / expected_std, se_ratio, activation=activation,
                                              generator=generator))
                self.blocks.append(name)
                in_features = width
                if block_index == 0:  # the scale resets at a stage's start, then grows
                    expected_std = 1.0
                expected_std = (expected_std ** 2 + alpha ** 2) ** 0.5
        self.final_conv = WSConv(in_features, 2 * in_features, 1, generator=generator)
        self.linear = Dense(2 * in_features, num_classes, generator=generator)
        with torch.no_grad():
            self.linear.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = self.stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = avg_pool_global(_vp_act(self.final_conv(x), self.activation))
        if capture is not None:
            capture["features"] = x
        return x if features else self.linear(x)
