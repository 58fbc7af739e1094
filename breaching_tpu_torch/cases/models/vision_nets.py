"""Vision architectures of the port (counterpart of ``breaching_tpu/cases/models/vision_nets.py``):
the ConvNet, ``LinearModel`` (``linear``, the analytic sanity check's one dense layer) and
``NoneModel`` (``none``, no parameters).

NCHW ``nn.Module``s; ``forward(x, train=False, features=False, capture=None)`` returns
logits, or the pre-head features with ``features=True``; a ``capture`` dict collects
the features and train-mode BatchNorm statistics (``layers.BatchNorm``). Features (and
the inputs of ``linear`` and ``none``) are flattened in height-width-channel order, the
JAX package's order, so that its dense weights load with a plain transpose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense, name_batchnorms


class ConvNet(nn.Module):
    """The 8-conv BatchNorm ConvNet (reference ConvNet, model_preparation.py:437-479):
    widths [w, 2w, 2w, 4w, 4w, 4w | pool3 | 4w, 4w | pool3], then a linear head."""

    WIDTHS = (1, 2, 2, 4, 4, 4, 4, 4)
    POOLS_AFTER = (5, 7)

    def __init__(self, width: int = 32, num_classes: int = 10, shape=(3, 32, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width_px = shape
        for idx, w in enumerate(self.WIDTHS):
            self.add_module(f"conv{idx}", Conv(channels, w * width, generator=generator))
            self.add_module(f"bn{idx}", BatchNorm(w * width))
            channels = w * width
        for _ in self.POOLS_AFTER:
            height, width_px = height // 3, width_px // 3
        self.head = Dense(channels * height * width_px, num_classes, generator=generator)
        name_batchnorms(self)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        for idx in range(len(self.WIDTHS)):
            x = getattr(self, f"conv{idx}")(x)
            x = F.relu(getattr(self, f"bn{idx}")(x, train=train, capture=capture))
            if idx in self.POOLS_AFTER:
                x = F.max_pool2d(x, 3)
        x = flatten_hwc(x)
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)

    def from_jax_state(self, params: dict, buffers: dict) -> "ConvNet":
        """Load the JAX package's ConvNet state (nested dicts of arrays, flax names
        conv{i}, bn{i}, head) through ``model_preparation.load_flat_state``."""
        from .model_preparation import load_flat_state

        flat = {}

        def flatten(tree, prefix):
            for key, value in tree.items():
                if isinstance(value, dict):
                    flatten(value, f"{prefix}{key}/")
                else:
                    flat[f"{prefix}{key}"] = value

        flatten(params, "params/")
        flatten(buffers, "buffers/")
        load_flat_state(self, flat, strict=True)
        return self


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C), in the JAX package's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LinearModel(nn.Module):
    """One dense layer on the flattened input, the analytic sanity check's model
    (reference: model_preparation.py:236-240): the FC inversion is exact here."""

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width = shape
        self.head = Dense(channels * height * width, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = flatten_hwc(x)
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


class NoneModel(nn.Module):
    """No parameters: the flattened input, zero-padded to a multiple of the classes and
    averaged into one logit per class (reference: model_preparation.py:311-313)."""

    def __init__(self, num_classes: int = 10, shape=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = flatten_hwc(x)
        if capture is not None:
            capture["features"] = x
        if features:
            return x
        x = F.pad(x, (0, -x.shape[-1] % self.num_classes))
        return x.reshape(x.shape[0], self.num_classes, -1).mean(-1)
