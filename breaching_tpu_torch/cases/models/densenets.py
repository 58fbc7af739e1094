"""DenseNet (counterpart of ``breaching_tpu/cases/models/densenets.py``), NCHW.

Dense layers (``block{s}_layer{i}``: BatchNorm, ReLU, 1x1 convolution to ``bn_size``
times the growth rate, BatchNorm, ReLU, 3x3 convolution to the growth rate, the result
concatenated to the input), transitions between the blocks (``transition{s}``: BatchNorm,
ReLU, 1x1 convolution halving the features, 2x2 average pool), a final BatchNorm and
ReLU, the global mean and a head. The ImageNet stem is a 7x7/2 convolution, BatchNorm,
ReLU and a 3x3/2 max pool padded by 1; the CIFAR stem one bias-free 3x3 convolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense, avg_pool, avg_pool_global, max_pool, name_batchnorms


def densenet_depths_to_config(depth: int):
    """(growth rate, layers per block, stem features) of DenseNet-``depth``."""
    table = {
        121: (32, (6, 12, 24, 16), 64),
        161: (48, (6, 12, 36, 24), 96),
        169: (32, (6, 12, 32, 32), 64),
        201: (32, (6, 12, 48, 32), 64),
    }
    if depth not in table:
        raise ValueError(f"Invalid DenseNet depth {depth}.")
    return table[depth]


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4, generator=None):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = Conv(in_channels, bn_size * growth_rate, 1, use_bias=False, generator=generator)
        self.norm2 = BatchNorm(bn_size * growth_rate)
        self.conv2 = Conv(bn_size * growth_rate, growth_rate, use_bias=False, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x, train=train, capture=capture)))
        y = self.conv2(F.relu(self.norm2(y, train=train, capture=capture)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_channels: int, features: int, generator=None):
        super().__init__()
        self.norm = BatchNorm(in_channels)
        self.conv = Conv(in_channels, features, 1, use_bias=False, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        return avg_pool(self.conv(F.relu(self.norm(x, train=train, capture=capture))), 2)


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int = 32, block_config=(6, 12, 24, 16), num_init_features: int = 64,
                 bn_size: int = 4, num_classes: int = 10, stem: str = "CIFAR", shape=(3, 32, 32), generator=None):
        super().__init__()
        channels = shape[0]
        self.stem = stem
        if stem == "ImageNet":
            self.stem_conv = Conv(channels, num_init_features, 7, 2, use_bias=False, generator=generator)
            self.stem_norm = BatchNorm(num_init_features)
        else:
            self.stem_conv = Conv(channels, num_init_features, use_bias=False, generator=generator)
        self.layers = []  # module names in execution order
        features = num_init_features
        for stage, num_layers in enumerate(block_config):
            for i in range(num_layers):
                self.add_module(f"block{stage}_layer{i}",
                                DenseLayer(features + i * growth_rate, growth_rate, bn_size, generator))
                self.layers.append(f"block{stage}_layer{i}")
            features += num_layers * growth_rate
            if stage != len(block_config) - 1:
                self.add_module(f"transition{stage}", Transition(features, features // 2, generator))
                self.layers.append(f"transition{stage}")
                features //= 2
        self.final_norm = BatchNorm(features)
        self.head = Dense(features, num_classes, generator=generator)
        name_batchnorms(self)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = self.stem_conv(x)
        if self.stem == "ImageNet":
            x = max_pool(F.relu(self.stem_norm(x, train=train, capture=capture)), 3, 2, padding=1)
        for name in self.layers:
            x = getattr(self, name)(x, train=train, capture=capture)
        x = avg_pool_global(F.relu(self.final_norm(x, train=train, capture=capture)))
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)
