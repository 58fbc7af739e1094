"""LPIPS (Zhang et al., 2018) on NCHW images (counterpart of
``breaching_tpu/analysis/lpips.py``): a fixed AlexNet or VGG-16 trunk, the
activations at its tap layers unit-normalized over the channels, their squared
differences weighted by non-negative 1x1 heads, averaged over space and summed over
the taps.

The weights come from an ``.npz`` of the JAX package's schema, so one file serves
both packages: ``trunk/<i>/w`` and ``trunk/<i>/b`` (convolutions HWIO),
``lin/<k>/w`` ([1, 1, C_k, 1]), ``meta/net`` ("alex" or "vgg"), ``meta/shift`` and
``meta/scale`` (3,). The scorer holds its convolutions OIHW and converts on load and
save. ``features`` flattens every tap channels-last, as the JAX package's NHWC
arrays flatten, so that its vectors compare entry by entry with the JAX package's.
No calibrated weights are in the repository; ``random_init`` writes a structural
placeholder from a ``torch.Generator``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..attacks.auxiliaries.augmentations import resize

# trunk convolutions: (out_channels, kernel, stride, padding, maxpool_before); taps
# after the ReLUs listed in the second entry
_ALEX_CONVS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
_ALEX_TAPS = [0, 1, 2, 3, 4]  # relu1..relu5

_VGG_CONVS = [
    (64, 3, 1, 1, False), (64, 3, 1, 1, False),
    (128, 3, 1, 1, True), (128, 3, 1, 1, False),
    (256, 3, 1, 1, True), (256, 3, 1, 1, False), (256, 3, 1, 1, False),
    (512, 3, 1, 1, True), (512, 3, 1, 1, False), (512, 3, 1, 1, False),
    (512, 3, 1, 1, True), (512, 3, 1, 1, False), (512, 3, 1, 1, False),
]
_VGG_TAPS = [1, 3, 6, 9, 12]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3

_ARCHS = {"alex": (_ALEX_CONVS, _ALEX_TAPS), "vgg": (_VGG_CONVS, _VGG_TAPS)}

# Zhang et al.'s input scaling (images in [-1, 1])
_DEFAULT_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_DEFAULT_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS:
    """Batched LPIPS distance. ``__call__(x, y)`` takes NCHW images in [0, 1] and
    returns the distance of each pair [B]; ``features(x)`` the flattened normalized
    taps that the IIP's 'lpips' score and the batch order compare. ``trunk`` holds
    (weight OIHW, bias) per convolution, ``lin`` a (C_k,) head per tap or None (a
    plain mean)."""

    def __init__(self, net, trunk, lin, shift=None, scale=None):
        if net not in _ARCHS:
            raise ValueError(f"Unknown LPIPS trunk {net!r}")
        self.net = net
        self.convs, self.taps = _ARCHS[net]
        self.trunk = [(torch.as_tensor(w, dtype=torch.float32), torch.as_tensor(b, dtype=torch.float32))
                      for w, b in trunk]
        self.lin = [None if w is None else torch.as_tensor(w, dtype=torch.float32) for w in lin]
        self.shift = torch.as_tensor(_DEFAULT_SHIFT if shift is None else shift, dtype=torch.float32)
        self.scale = torch.as_tensor(_DEFAULT_SCALE if scale is None else scale, dtype=torch.float32)

    def to(self, device):
        """The same scorer with its tensors on ``device``."""
        return LPIPS(self.net, [(w.to(device), b.to(device)) for w, b in self.trunk],
                     [None if w is None else w.to(device) for w in self.lin],
                     self.shift.to(device), self.scale.to(device))

    # ---------------------------------------------------------------- weights

    @classmethod
    def from_npz(cls, path):
        with np.load(path, allow_pickle=False) as blob:
            flat = dict(blob)
        net = str(flat["meta/net"]) if "meta/net" in flat else "alex"
        convs, taps = _ARCHS[net]
        trunk = [(flat[f"trunk/{i}/w"].transpose(3, 2, 0, 1), flat[f"trunk/{i}/b"]) for i in range(len(convs))]
        lin = [flat[f"lin/{k}/w"].reshape(-1) if f"lin/{k}/w" in flat else None for k in range(len(taps))]
        return cls(net, trunk, lin, shift=flat.get("meta/shift"), scale=flat.get("meta/scale"))

    def save_npz(self, path):
        out = {"meta/net": np.asarray(self.net),
               "meta/shift": self.shift.cpu().numpy(), "meta/scale": self.scale.cpu().numpy()}
        for i, (w, b) in enumerate(self.trunk):
            out[f"trunk/{i}/w"] = w.cpu().numpy().transpose(2, 3, 1, 0)
            out[f"trunk/{i}/b"] = b.cpu().numpy()
        for k, w in enumerate(self.lin):
            if w is not None:
                out[f"lin/{k}/w"] = w.cpu().numpy().reshape(1, 1, -1, 1)
        np.savez(path, **out)

    @classmethod
    def random_init(cls, net="alex", generator=None):
        """He-initialized trunk (zero biases) and uniform heads 1/C from ``generator``.
        Not perceptually calibrated: for tests and as a structural placeholder."""
        convs, taps = _ARCHS[net]
        trunk, c_in = [], 3
        for c_out, k, _, _, _ in convs:
            w = torch.randn(c_out, c_in, k, k, generator=generator) * math.sqrt(2.0 / (k * k * c_in))
            trunk.append((w, torch.zeros(c_out)))
            c_in = c_out
        lin = [torch.full((convs[t][0],), 1.0 / convs[t][0]) for t in taps]
        return cls(net, trunk, lin)

    # ---------------------------------------------------------------- forward

    def _normalized_taps(self, x):
        """NCHW in [0, 1] -> the tap activations, each unit-normalized over channels.
        Images under 32 px a side are first upsampled bilinearly by the smallest
        integer factor that reaches 32 (the stride-4 convolution and the pools would
        leave nothing of them)."""
        H, W = x.shape[2:]
        if min(H, W) < 32:
            s = -(-32 // min(H, W))
            x = resize(x, (H * s, W * s))
        h = (2.0 * x - 1.0 - self.shift.reshape(1, 3, 1, 1)) / self.scale.reshape(1, 3, 1, 1)
        outs = []
        for i, ((_, _, stride, padding, pool), (w, b)) in enumerate(zip(self.convs, self.trunk)):
            if pool:
                h = F.max_pool2d(h, 3, 2)
            h = F.relu(F.conv2d(h, w, None, stride, padding) + b.reshape(1, -1, 1, 1))
            if i in self.taps:
                outs.append(h / torch.sqrt(torch.sum(h ** 2, dim=1, keepdim=True) + 1e-10))
        return outs

    def __call__(self, x, y):
        x, y = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
        with torch.no_grad():
            total = torch.zeros(x.shape[0], device=x.device)
            for a, b, w in zip(self._normalized_taps(x), self._normalized_taps(y), self.lin):
                d2 = (a - b) ** 2
                if w is None:
                    total = total + torch.mean(d2, dim=(1, 2, 3))
                else:  # the learned heads are non-negative 1x1 convolutions
                    total = total + torch.mean(torch.sum(d2 * F.relu(w).reshape(1, -1, 1, 1), dim=1), dim=(1, 2))
        return total

    def features(self, x):
        """The taps flattened channels-last and joined: (B, sum_k H_k W_k C_k)."""
        with torch.no_grad():
            taps = self._normalized_taps(torch.as_tensor(x, dtype=torch.float32))
        return torch.cat([t.permute(0, 2, 3, 1).reshape(t.shape[0], -1) for t in taps], dim=-1)


# ---------------------------------------------------------------- discovery

def find_lpips_weights(cfg_case=None, net="alex"):
    """A converted LPIPS npz: $BREACHING_LPIPS_WEIGHTS, then
    <data.path>/checkpoints/lpips_<net>.npz, then ~/data/checkpoints/; None if none exists."""
    candidates = []
    env = os.environ.get("BREACHING_LPIPS_WEIGHTS")
    if env:
        candidates.append(env)
    if cfg_case is not None:
        try:
            candidates.append(os.path.expanduser(
                os.path.join(str(cfg_case.data.path), "checkpoints", f"lpips_{net}.npz")))
        except AttributeError:
            pass
    candidates.append(os.path.expanduser(f"~/data/checkpoints/lpips_{net}.npz"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_lpips(cfg_case=None, net="alex"):
    """An LPIPS scorer on the CPU, or None when no weights file exists."""
    path = find_lpips_weights(cfg_case, net)
    return None if path is None else LPIPS.from_npz(path)


# ---------------------------------------------------------------- conversion

def convert_torch_lpips(lpips_module, out_path):
    """Write an instantiated ``lpips.LPIPS(net=...)`` module (the official package, Zhang
    et al.'s weights) to this schema; reads only the module's attributes."""
    net = lpips_module.pnet_type  # 'alex' | 'vgg'
    convs, taps = _ARCHS[net]
    torch_convs = [layer for idx in range(1, len(taps) + 1) for layer in getattr(lpips_module.net, f"slice{idx}")
                   if layer.__class__.__name__ == "Conv2d"]
    assert len(torch_convs) == len(convs), (len(torch_convs), len(convs))
    trunk = [(c.weight.detach().cpu(), c.bias.detach().cpu()) for c in torch_convs]
    lin = [layer.model[-1].weight.detach().cpu().reshape(-1) for layer in lpips_module.lins]
    scaling = lpips_module.scaling_layer
    model = LPIPS(net, trunk, lin, shift=scaling.shift.detach().cpu().reshape(3),
                  scale=scaling.scale.detach().cpu().reshape(3))
    model.save_npz(out_path)
    return model
