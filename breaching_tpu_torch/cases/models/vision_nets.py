"""Vision architectures of the port (counterpart of ``breaching_tpu/cases/models/vision_nets.py``):
the ConvNet, ``ConvNetSmall``, ``LeNetZhu``, ``CNN6`` (R-GAP's net, with its recursion
plan ``rgap_layers``), ``ConvNetBeyond``, ``ConvNetTrivial``, ``MLP``, ``LinearModel``
(``linear``, the analytic sanity check's one dense layer) and ``NoneModel`` (``none``, no
parameters).

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
from torch.nn.utils import skip_init

from .layers import BatchNorm, Conv, Dense, avg_pool_global, direct, max_pool, name_batchnorms


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


class ConvNetSmall(nn.Module):
    """The BatchNorm-free small ConvNet (JAX ``ConvNetSmall``): widths w, 2w, 4w (stride
    2), a 3x3 max pool, 4w (stride 2), the global mean, a linear head."""

    def __init__(self, width: int = 32, num_classes: int = 10, shape=(3, 32, 32),
                 generator: torch.Generator | None = None):
        super().__init__()
        channels = shape[0]
        self.conv0 = Conv(channels, width, generator=generator)
        self.conv1 = Conv(width, 2 * width, generator=generator)
        self.conv2 = Conv(2 * width, 4 * width, stride=2, generator=generator)
        self.conv3 = Conv(4 * width, 4 * width, stride=2, generator=generator)
        self.head = Dense(4 * width, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = F.relu(self.conv2(F.relu(self.conv1(F.relu(self.conv0(x))))))
        x = avg_pool_global(F.relu(self.conv3(max_pool(x, 3))))
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


class LeNetZhu(nn.Module):
    """The sigmoid LeNet of the DLG paper (JAX ``LeNetZhu``): three 5x5 convolutions of
    12 channels (strides 2, 2, 1), every weight and bias drawn from U(-0.5, 0.5); flax
    layers used directly."""

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width = shape
        for idx, stride in enumerate((2, 2, 1)):
            self.add_module(f"conv{idx}", direct(skip_init(nn.Conv2d, channels, 12, 5, stride, padding=2)))
            channels = 12
            height, width = (height - 1) // stride + 1, (width - 1) // stride + 1
        self.head = direct(skip_init(nn.Linear, 12 * height * width, num_classes))
        with torch.no_grad():
            for param in self.parameters():
                param.uniform_(-0.5, 0.5, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        for idx in range(3):
            x = torch.sigmoid(getattr(self, f"conv{idx}")(x))
        x = flatten_hwc(x)
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


class CNN6(nn.Module):
    """The 6-layer LeakyReLU (slope 0.2) CNN that R-GAP attacks (JAX ``CNN6``): bias-free
    strided convolutions, then a linear head. ``rgap_layers`` is R-GAP's recursion plan:
    per convolution, its module name, features, kernel, stride, padding and slope."""

    SPECS = [(12, 4, 2, 2), (36, 3, 2, 1), (36, 3, 1, 1),
             (36, 3, 1, 1), (64, 3, 2, 1), (128, 3, 1, 1)]  # (features, kernel, stride, padding)

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width = shape
        for idx, (feats, k, stride, pad) in enumerate(self.SPECS):
            # every padding of SPECS is kernel // 2, Conv's own
            self.add_module(f"conv{idx}", Conv(channels, feats, k, stride, use_bias=False, generator=generator))
            channels = feats
            height, width = ((v + 2 * pad - k) // stride + 1 for v in (height, width))
        self.head = Dense(channels * height * width, num_classes, generator=generator)
        self.rgap_layers = [dict(name=f"conv{i}", features=f, kernel=k, stride=s, padding=p, slope=0.2)
                            for i, (f, k, s, p) in enumerate(self.SPECS)]

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        for idx in range(len(self.SPECS)):
            x = F.leaky_relu(getattr(self, f"conv{idx}")(x), 0.2)
        x = flatten_hwc(x)
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


class ConvNetBeyond(nn.Module):
    """The LeakyReLU (slope 0.01) stack of "Beyond Inferring Class Representatives" (JAX
    ``ConvNetBeyond``): convolutions of 32, 64, 128, 256 channels (strides 2, 1, 2, 1), a
    dense layer as wide as the flattened features, a head, and a softmax on the logits."""

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width = shape
        self.plan = ((32, 2), (64, 1), (128, 2), (256, 1))
        for feats, stride in self.plan:
            self.add_module(f"conv{feats}", Conv(channels, feats, stride=stride, generator=generator))
            channels = feats
            height, width = (height - 1) // stride + 1, (width - 1) // stride + 1
        flat = channels * height * width
        self.linear0 = Dense(flat, flat, generator=generator)
        self.head = Dense(flat, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        for feats, _ in self.plan:
            x = F.leaky_relu(getattr(self, f"conv{feats}")(x), 0.01)
        x = F.leaky_relu(self.linear0(flatten_hwc(x)), 0.01)
        if capture is not None:
            capture["features"] = x
        return x if features else torch.softmax(self.head(x), dim=1)


class ConvNetTrivial(nn.Module):
    """One convolution of 3072 channels, the global mean, a head (JAX ``ConvNetTrivial``)."""

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Conv(shape[0], 3072, generator=generator)
        self.head = Dense(3072, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = avg_pool_global(F.relu(self.conv(x)))
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


class MLP(nn.Module):
    """Three ReLU layers of 1024 on the flattened input, then a head (JAX ``MLP``)."""

    WIDTHS = (1024, 1024, 1024)

    def __init__(self, num_classes: int = 10, shape=(3, 32, 32), generator: torch.Generator | None = None):
        super().__init__()
        channels, height, width = shape
        features = channels * height * width
        for idx, w in enumerate(self.WIDTHS):
            self.add_module(f"linear{idx}", Dense(features, w, generator=generator))
            features = w
        self.head = Dense(features, num_classes, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        x = flatten_hwc(x)
        for idx in range(len(self.WIDTHS)):
            x = F.relu(getattr(self, f"linear{idx}")(x))
        if capture is not None:
            capture["features"] = x
        return x if features else self.head(x)


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
