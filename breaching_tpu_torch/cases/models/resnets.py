"""ResNets with the CIFAR and ImageNet stems, BasicBlock or Bottleneck, BatchNorm or
GroupNorm (counterpart of ``breaching_tpu/cases/models/resnets.py``), NCHW.

Module names are the flax names of the JAX package (``stem_conv``, ``stem_norm``,
``stage{s}_block{b}.conv1`` / ``bn1`` / ... / ``downsample_conv`` / ``downsample_norm``,
``head``), so that its checkpoints load through ``load_flat_state`` by a rename.
A block takes the downsample path exactly where the JAX block does, when its
residual's shape differs from its output's; the spatial sizes that decide this are
followed from the input shape at construction. The GroupNorm ResNets (``resnetgn*``)
take flax's GroupNorm of 4 groups (``norm="groupnorm4th"``; 32 for another GroupNorm
name), capped at the channel count, as the JAX package's ``_make_norm`` does.

The malicious server's deep placement (``place_imprint``) runs an imprint block before
stage ``imprint_position`` (the JAX ResNet's ``imprint_block`` and ``imprint_position``);
with ``linear_prefix`` the ReLUs before it, the stem's and the BasicBlocks'
(``identity_nonlin``), become identities. A Bottleneck keeps its ReLUs, as in the JAX
package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense, GroupNorm, avg_pool_global, max_pool, name_batchnorms


def resnet_depths_to_config(depth: int):
    table = {
        20: ("basic", [3, 3, 3]),
        32: ("basic", [5, 5, 5]),
        56: ("basic", [9, 9, 9]),
        110: ("basic", [18, 18, 18]),
        18: ("basic", [2, 2, 2, 2]),
        34: ("basic", [3, 4, 6, 3]),
        50: ("bottleneck", [3, 4, 6, 3]),
        101: ("bottleneck", [3, 4, 23, 3]),
        152: ("bottleneck", [3, 8, 36, 3]),
    }
    if depth not in table:
        raise ValueError(f"Invalid ResNet depth {depth}.")
    return table[depth]


def _make_norm(norm: str, features: int) -> nn.Module:
    if norm.lower().startswith("group"):
        return GroupNorm(features, num_groups=4 if "4th" in norm else 32)
    return BatchNorm(features)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _out_size(size: int, stride: int) -> int:
    """Height or width after a stride-s convolution padded by kernel_size // 2 (odd
    kernels), or a 3x3 max pool padded by 1."""
    return (size - 1) // stride + 1


class BasicBlock(nn.Module):
    expansion = 1
    identity_nonlin = False  # a linearized prefix of a deep imprint placement

    def __init__(self, in_channels: int, features: int, stride: int, size: tuple,
                 generator: torch.Generator | None = None, norm: str = "BatchNorm2d"):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 3, stride, use_bias=False, generator=generator)
        self.bn1 = _make_norm(norm, features)
        self.conv2 = Conv(features, features, 3, use_bias=False, generator=generator)
        self.bn2 = _make_norm(norm, features)
        self.downsample_conv = self.downsample_norm = None
        out = tuple(_out_size(s, stride) for s in size)
        if (in_channels, *size) != (features, *out):
            self.downsample_conv = Conv(in_channels, features, 1, stride, use_bias=False,
                                        generator=generator)
            self.downsample_norm = _make_norm(norm, features)

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        act = _identity if self.identity_nonlin else F.relu
        y = act(self.bn1(self.conv1(x), train=train, capture=capture))
        y = self.bn2(self.conv2(y), train=train, capture=capture)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x), train=train, capture=capture)
        return act(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int, size: tuple,
                 generator: torch.Generator | None = None, norm: str = "BatchNorm2d"):
        super().__init__()
        self.conv1 = Conv(in_channels, features, 1, use_bias=False, generator=generator)
        self.bn1 = _make_norm(norm, features)
        self.conv2 = Conv(features, features, 3, stride, use_bias=False, generator=generator)
        self.bn2 = _make_norm(norm, features)
        self.conv3 = Conv(features, 4 * features, 1, use_bias=False, generator=generator)
        self.bn3 = _make_norm(norm, 4 * features)
        self.downsample_conv = self.downsample_norm = None
        out = tuple(_out_size(s, stride) for s in size)
        if (in_channels, *size) != (4 * features, *out):
            self.downsample_conv = Conv(in_channels, 4 * features, 1, stride, use_bias=False,
                                        generator=generator)
            self.downsample_norm = _make_norm(norm, 4 * features)

    def forward(self, x: torch.Tensor, train: bool = False, capture: dict | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train=train, capture=capture))
        y = F.relu(self.bn2(self.conv2(y), train=train, capture=capture))
        y = self.bn3(self.conv3(y), train=train, capture=capture)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x), train=train, capture=capture)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet over NCHW images of ``shape`` (C, H, W).

    stem="CIFAR": 3x3 stem conv, no max pool. stem="ImageNet": 7x7/2 stem conv and a
    3x3/2 max pool padded by 1.
    """

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, stem: str = "ImageNet", width: int = 64,
                 strides: Sequence[int] = (1, 2, 2, 2), shape=(3, 224, 224),
                 generator: torch.Generator | None = None, norm: str = "BatchNorm2d"):
        super().__init__()
        channels, *size = shape
        self.stem, self.block_type, self.width, self.strides = stem, block, width, tuple(strides)
        self.imprint_block, self.imprint_position, self.linear_prefix = None, 0, False
        if stem == "ImageNet":
            self.stem_conv = Conv(channels, width, 7, 2, use_bias=False, generator=generator)
            size = [_out_size(_out_size(s, 2), 2) for s in size]  # the conv, then the pool
        else:
            self.stem_conv = Conv(channels, width, 3, use_bias=False, generator=generator)
        self.stem_norm = _make_norm(norm, width)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.blocks = []  # (stage, index in the stage, module name) in execution order
        channels, features = width, width
        for stage, (num_blocks, stride) in enumerate(zip(layers, strides)):
            for idx in range(num_blocks):
                s = stride if idx == 0 else 1
                name = f"stage{stage}_block{idx}"
                self.add_module(name, block_cls(channels, features, s, tuple(size), generator, norm))
                self.blocks.append((stage, idx, name))
                size = [_out_size(v, s) for v in size]
                channels = features * block_cls.expansion
            features *= 2
        self.head = Dense(channels, num_classes, generator=generator)
        name_batchnorms(self)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        """Logits, or the pre-head features with ``features``; a ``capture`` dict
        collects the features and train-mode BatchNorm statistics (``layers.BatchNorm``)."""
        x = self.stem_norm(self.stem_conv(x), train=train, capture=capture)
        x = x if self._linear_before(0) else F.relu(x)
        if self.stem == "ImageNet":
            x = max_pool(x, 3, 2, padding=1)
        for stage, idx, name in self.blocks:
            if self.imprint_block is not None and stage == self.imprint_position and idx == 0:
                x = self.imprint_block(x)
            x = getattr(self, name)(x, train=train, capture=capture)
        x = avg_pool_global(x)
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)

    def features_before(self, x: torch.Tensor, position: int) -> torch.Tensor:
        """The NCHW feature map entering stage ``position``, in eval mode: what an imprint
        block placed there reads."""
        x = self.stem_norm(self.stem_conv(x))
        x = x if self._linear_before(0) else F.relu(x)
        if self.stem == "ImageNet":
            x = max_pool(x, 3, 2, padding=1)
        for stage, _, name in self.blocks:
            if stage >= position:
                break
            x = getattr(self, name)(x)
        return x

    def _linear_before(self, stage: int) -> bool:
        return self.imprint_block is not None and self.linear_prefix and stage < self.imprint_position

    def place_imprint(self, block: nn.Module, position: int, linear_prefix: bool) -> None:
        """Run ``block`` before stage ``position``; with ``linear_prefix`` the ReLUs before
        it become identities (the JAX ResNet's ``imprint_block``, ``imprint_position`` and
        ``linear_prefix``)."""
        self.imprint_block, self.imprint_position, self.linear_prefix = block, int(position), bool(linear_prefix)
        for stage, _, name in self.blocks:
            module = getattr(self, name)
            if isinstance(module, BasicBlock):
                module.identity_nonlin = self._linear_before(stage)


def build_resnet(model_name: str, classes: int, is_imagenet_data: bool, shape=(3, 224, 224),
                 generator: torch.Generator | None = None) -> ResNet:
    """Parse names like resnet18 / resnet50 / ResNet32-10 / resnetgn20-4 into a ResNet."""
    lname = model_name.lower()
    norm = "groupnorm4th" if "resnetgn" in lname else "BatchNorm2d"
    if "-" in lname:
        depth = int("".join(filter(str.isdigit, lname.split("-")[0])))
        width_mult = int("".join(filter(str.isdigit, lname.split("-")[1])))
    else:
        depth = int("".join(filter(str.isdigit, lname)))
        width_mult = 1
    block, layers = resnet_depths_to_config(depth)
    if is_imagenet_data:
        stem, base_width = "ImageNet", 64
        strides = (1, 2, 2, 2)
    else:
        stem = "CIFAR"
        base_width = 16 if len(layers) < 4 else 64
        strides = (1, 2, 2, 2)[: len(layers)]
    return ResNet(block=block, layers=layers, num_classes=classes, stem=stem,
                  width=base_width * width_mult, strides=strides, shape=tuple(shape),
                  generator=generator, norm=norm)
