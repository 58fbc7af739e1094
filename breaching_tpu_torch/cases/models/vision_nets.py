"""Vision architectures of the port (counterpart of ``breaching_tpu/cases/models/vision_nets.py``).

NCHW ``nn.Module``s; ``forward(x, train=False, features=False)`` returns logits, or
the pre-head features with ``features=True``. The features are flattened in
height-width-channel order, the JAX package's order, so that its head weights load
with a plain transpose.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, Dense


def _assign(target: torch.Tensor, array, name: str) -> None:
    value = torch.tensor(np.asarray(array), dtype=target.dtype)
    if value.shape != target.shape:
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not fit {tuple(target.shape)}.")
    with torch.no_grad():
        target.copy_(value)


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

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False) -> torch.Tensor:
        for idx in range(len(self.WIDTHS)):
            x = getattr(self, f"conv{idx}")(x)
            x = F.relu(getattr(self, f"bn{idx}")(x, train=train))
            if idx in self.POOLS_AFTER:
                x = F.max_pool2d(x, 3)
        x = x.permute(0, 2, 3, 1).flatten(1)
        return x if features else self.head(x)

    def from_jax_state(self, params: dict, buffers: dict) -> "ConvNet":
        """Load the JAX package's ConvNet state (nested dicts of arrays, flax names
        conv{i}, bn{i}, head): conv kernels HWIO -> OIHW, dense kernels (in, out) ->
        (out, in), BN scale -> weight and mean/var -> running_mean/running_var."""
        for idx in range(len(self.WIDTHS)):
            conv, bn = getattr(self, f"conv{idx}"), getattr(self, f"bn{idx}")
            p = params[f"conv{idx}"]["conv"]
            _assign(conv.weight, np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), f"conv{idx}.kernel")
            _assign(conv.bias, p["bias"], f"conv{idx}.bias")
            _assign(bn.weight, params[f"bn{idx}"]["scale"], f"bn{idx}.scale")
            _assign(bn.bias, params[f"bn{idx}"]["bias"], f"bn{idx}.bias")
            b = buffers[f"bn{idx}"]
            _assign(bn.running_mean, b["mean"], f"bn{idx}.mean")
            _assign(bn.running_var, b["var"], f"bn{idx}.var")
            _assign(bn.num_batches_tracked, b["num_batches_tracked"], f"bn{idx}.num_batches_tracked")
        head = params["head"]["dense"]
        _assign(self.head.weight, np.asarray(head["kernel"]).T, "head.kernel")
        _assign(self.head.bias, head["bias"], "head.bias")
        return self
