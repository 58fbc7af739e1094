"""Vision Transformer with APRIL's modified first block (counterpart of
``breaching_tpu/cases/models/vit.py``), on NCHW images.

A 16x16 patch embedding, a class token and a position embedding, blocks of fused-qkv
attention and an exact-erf GELU MLP, a final LayerNorm, and a head on the normed class
token (the features ``features=True`` returns and ``capture`` collects). The ``april``
variants drop block 0's ``norm1`` and both of its residual connections, which makes
APRIL's closed-form inversion exact (``attacks/analytic_attack.py`` ``AprilAttacker``).

The layers are flax's used directly (``patch_embed/kernel``, ``block0/attn/qkv/kernel``,
``cls_token``, ``pos_embed``), with flax's initializers: LeCun-normal kernels, zero
biases and class token, a N(0, 0.02) position embedding; LayerNorm is flax's (eps 1e-6).
Tokens are the patches in row-major order, as the JAX model reshapes its NHWC patch map.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from .layers import LayerNorm, direct, lecun_normal_


def _dense(in_features: int, out_features: int, generator) -> nn.Linear:
    """flax's ``nn.Dense``: a LeCun-normal kernel and a zero bias."""
    layer = direct(skip_init(nn.Linear, in_features, out_features))
    lecun_normal_(layer.weight, in_features, generator)
    nn.init.zeros_(layer.bias)
    return layer


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = _dense(dim, 3 * dim, generator)  # fused q, k, v: APRIL reads it
        self.proj = _dense(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, tokens, dim = x.shape
        head_dim = dim // self.num_heads
        q, k, v = (t.reshape(batch, tokens, self.num_heads, head_dim).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(head_dim), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(batch, tokens, dim))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, generator=None):
        super().__init__()
        self.fc1 = _dense(dim, hidden, generator)
        self.fc2 = _dense(hidden, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # the exact (erf) GELU


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4, april_modified: bool = False,
                 generator=None):
        super().__init__()
        self.april_modified = april_modified
        if not april_modified:
            self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, generator)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim, dim * mlp_ratio, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.april_modified:  # no norm1, no residual connections
            return self.mlp(self.norm2(self.attn(x)))
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 num_classes: int = 1000, april_modified: bool = False, shape=(3, 224, 224), generator=None):
        super().__init__()
        channels, height, width = shape
        self.patch_size = patch_size
        tokens = (height // patch_size) * (width // patch_size)
        self.patch_embed = direct(skip_init(nn.Conv2d, channels, dim, patch_size, patch_size))
        lecun_normal_(self.patch_embed.weight, channels * patch_size * patch_size, generator)
        nn.init.zeros_(self.patch_embed.bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens + 1, dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads, april_modified=april_modified and i == 0,
                                               generator=generator))
        self.norm = LayerNorm(dim)
        self.head = _dense(dim, num_classes, generator)

    def flax_entries(self, prefix: str):
        yield "params/cls_token", self.cls_token, None
        yield "params/pos_embed", self.pos_embed, None

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), tokens], dim=1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        feats = self.norm(x)[:, 0]
        if capture is not None:
            capture["features"] = feats
        return feats if features else self.head(feats)

    @staticmethod
    def april_refs(tree: dict) -> dict:
        """What APRIL reads, from a dict by parameter name of the weights or of their
        gradients, in the JAX package's layouts (``vit_april_refs``): the block-0 qkv
        kernel (D, 3D), the position embedding (1, T + 1, D), the patch kernel as
        (P*P*C, D) in (row, column, channel) order, and the patch bias."""
        kernel = tree["patch_embed.weight"]
        return dict(qkv_kernel=tree["block0.attn.qkv.weight"].T,
                    pos_embed=tree["pos_embed"],
                    patch_kernel=kernel.permute(2, 3, 1, 0).reshape(-1, kernel.shape[0]),
                    patch_bias=tree["patch_embed.bias"])

    def april_retile(self, patches: np.ndarray) -> np.ndarray:
        """(P*P*C, T-1) patch pixels in ``april_refs``' order as one (C, H, W) image
        (the JAX package's ``vit_april_retile``, then channels first)."""
        p = self.patch_size
        grid = int(np.sqrt(patches.shape[1]))
        c = patches.shape[0] // (p * p)
        tiles = patches.T.reshape(grid, grid, p, p, c)
        return tiles.transpose(4, 0, 2, 1, 3).reshape(c, grid * p, grid * p)


def build_vit(name: str, classes: int, shape=(3, 224, 224), generator=None) -> VisionTransformer:
    """ViT-B/16 (768 wide, 12 blocks, 12 heads), or ViT-S/16 (384, 12, 6) for a name that
    says ``small``; APRIL's first block for a name that says ``april``."""
    lname = name.lower()
    dim, heads = (384, 6) if "small" in lname else (768, 12)
    return VisionTransformer(dim=dim, depth=12, num_heads=heads, num_classes=classes,
                             april_modified="april" in lname, shape=tuple(shape), generator=generator)
