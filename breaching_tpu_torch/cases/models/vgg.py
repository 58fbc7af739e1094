"""VGG with BatchNorm (counterpart of ``breaching_tpu/cases/models/vgg.py``), NCHW.

A plan of 3x3 convolutions (``conv{i}``, each followed by ``bn{i}`` and a ReLU) and 2x2
max pools, the features flattened in the JAX package's height-width-channel order, and
for ImageNet data two ReLU layers of 4096 (``fc0``, ``fc1``) before the head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense, max_pool, name_batchnorms
from .vision_nets import flatten_hwc

VGG_PLANS = {
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
              "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, plan_name: str = "VGG11", num_classes: int = 10, head: str = "CIFAR", shape=(3, 32, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.plan = VGG_PLANS[plan_name.upper()]
        channels, height, width = shape
        idx = 0
        for entry in self.plan:
            if entry == "M":
                height, width = height // 2, width // 2
                continue
            self.add_module(f"conv{idx}", Conv(channels, entry, generator=generator))
            self.add_module(f"bn{idx}", BatchNorm(entry))
            channels, idx = entry, idx + 1
        features = channels * height * width
        self.imagenet_head = head == "ImageNet"
        if self.imagenet_head:
            self.fc0 = Dense(features, 4096, generator=generator)
            self.fc1 = Dense(4096, 4096, generator=generator)
            features = 4096
        self.head = Dense(features, num_classes, generator=generator)
        name_batchnorms(self)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        idx = 0
        for entry in self.plan:
            if entry == "M":
                x = max_pool(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"bn{idx}")(getattr(self, f"conv{idx}")(x), train=train, capture=capture))
            idx += 1
        x = flatten_hwc(x)
        if self.imagenet_head:
            x = F.relu(self.fc1(F.relu(self.fc0(x))))
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)
