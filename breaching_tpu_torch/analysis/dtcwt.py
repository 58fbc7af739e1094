"""2-D dual-tree complex wavelet transform (Kingsbury) and CW-SSIM on it (counterpart
of ``breaching_tpu/analysis/dtcwt.py``; reference breaching/analysis/metrics.py:11-55
takes the transform from pytorch_wavelets with ``biort="near_sym_b",
qshift="qshift_b"``).

The same explicit four-tree form as the JAX package: level 1 filters with the
near_sym_b pair and splits each band into its four polyphase grids; every further
level filters each (y-tree, x-tree) lowpass grid with its own tree's q-shift filters
and decimates by 2. Each filter is a reflect-padded correlation along one axis,
``F.conv2d`` with a (L, 1) or (1, L) kernel. The reflect pad folds as numpy's
``mode="reflect"`` does when the pad is wider than the axis (a 4-wide grid under 14
taps), where ``F.pad(mode="reflect")`` refuses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Kingsbury near_sym_b level-1 biorthogonal pair (13, 19 taps)
NEAR_SYM_B_H0O = np.array(
    [-0.0017581, 0.0, 0.0222656, -0.0468750, -0.0482422, 0.2968750,
     0.5554688, 0.2968750, -0.0482422, -0.0468750, 0.0222656, 0.0, -0.0017581],
    np.float64)
NEAR_SYM_B_H1O = np.array(
    [-0.0000706, 0.0, 0.0013419, -0.0018834, -0.0071568, 0.0238560,
     0.0556431, -0.0516881, -0.2997576, 0.5594308, -0.2997576, -0.0516881,
     0.0556431, 0.0238560, -0.0071568, -0.0018834, 0.0013419, 0.0, -0.0000706],
    np.float64)

# Kingsbury qshift_b tree filters (14 taps, levels >= 2)
QSHIFT_B_H0A = np.array(
    [0.00325314, -0.00388321, 0.03466035, -0.03887280,
     -0.11720389, 0.27529538, 0.75614564, 0.56881042,
     0.01186609, -0.10671180, 0.02382538, 0.01702522,
     -0.00543948, -0.00455690], np.float64)
QSHIFT_B_H0B = QSHIFT_B_H0A[::-1].copy()
QSHIFT_B_H1A = (-1.0) ** np.arange(len(QSHIFT_B_H0A)) * QSHIFT_B_H0B
QSHIFT_B_H1B = QSHIFT_B_H1A[::-1].copy()


def _reflect_index(n: int, before: int, after: int) -> np.ndarray:
    """The source index of every position of an axis of n reflect-padded by
    (before, after), folding again and again as numpy's ``mode="reflect"`` does."""
    positions = np.arange(-before, n + after)
    if n == 1:
        return np.zeros_like(positions)
    period = 2 * (n - 1)
    folded = np.mod(positions, period)
    return np.where(folded >= n, period - folded, folded)


def _reflect_pad(x, axis: int, before: int, after: int):
    """numpy's ``np.pad(x, ..., mode="reflect")`` along one axis of a tensor."""
    if before == 0 and after == 0:
        return x
    index = torch.as_tensor(_reflect_index(x.shape[axis], before, after), device=x.device)
    return torch.index_select(x, axis, index)


def _corr_axis(x, h, axis: int, stride: int = 1):
    """Reflect-padded 'same' correlation of (N, H, W) with the filter h along H
    (axis 1) or W (axis 2), keeping every ``stride``-th output from the first."""
    L = len(h)
    xp = _reflect_pad(x, axis, (L - 1) // 2, L // 2)
    kernel = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    kernel = kernel.reshape(1, 1, L, 1) if axis == 1 else kernel.reshape(1, 1, 1, L)
    strides = (stride, 1) if axis == 1 else (1, stride)
    return F.conv2d(xp[:, None], kernel, stride=strides)[:, 0]


def _even_pad(x):
    """Reflect-pad H and W of (N, H, W) to even sizes (pytorch_wavelets' rule per level)."""
    x = _reflect_pad(x, 1, 0, x.shape[1] % 2)
    return _reflect_pad(x, 2, 0, x.shape[2] % 2)


def _quads_to_complex(s00, s01, s10, s11):
    """Four (y-tree, x-tree) real subbands -> two oriented complex subbands
    ((re1, im1), (re2, im2)), each scaled by 1/sqrt(2) to keep the energy."""
    s = 0.5 ** 0.5
    return ((s * (s00 - s11), s * (s01 + s10)),
            (s * (s00 + s11), s * (s01 - s10)))


def dtcwt2d(img, levels: int = 5):
    """Forward DTCWT of (N, H, W) tensors: a list of ``levels`` pairs (re, im), each
    (N, 6, H_l, W_l), the six oriented complex subbands of a level."""
    x = _even_pad(img)
    out = []

    lo_x = _corr_axis(x, NEAR_SYM_B_H0O, axis=2)
    hi_x = _corr_axis(x, NEAR_SYM_B_H1O, axis=2)
    bands = {
        "lh": _corr_axis(lo_x, NEAR_SYM_B_H1O, axis=1),
        "hl": _corr_axis(hi_x, NEAR_SYM_B_H0O, axis=1),
        "hh": _corr_axis(hi_x, NEAR_SYM_B_H1O, axis=1),
    }
    level = []
    for name in ("lh", "hl", "hh"):
        b = _even_pad(bands[name])
        level.extend(_quads_to_complex(b[:, 0::2, 0::2], b[:, 0::2, 1::2], b[:, 1::2, 0::2], b[:, 1::2, 1::2]))
    out.append((torch.stack([re for re, _ in level], dim=1), torch.stack([im for _, im in level], dim=1)))

    ll = _even_pad(_corr_axis(lo_x, NEAR_SYM_B_H0O, axis=1))
    # grids[p][q]: y-tree p, x-tree q (0 = tree a, 1 = tree b)
    grids = [[ll[:, 0::2, 0::2], ll[:, 0::2, 1::2]],
             [ll[:, 1::2, 0::2], ll[:, 1::2, 1::2]]]
    lo_f = (QSHIFT_B_H0A, QSHIFT_B_H0B)
    hi_f = (QSHIFT_B_H1A, QSHIFT_B_H1B)
    for _ in range(1, levels):
        sub = {name: [[None] * 2 for _ in range(2)] for name in ("lh", "hl", "hh")}
        new_grids = [[None] * 2 for _ in range(2)]
        for p in range(2):
            for q in range(2):
                g = _even_pad(grids[p][q])
                lo_xq = _corr_axis(g, lo_f[q], axis=2, stride=2)
                hi_xq = _corr_axis(g, hi_f[q], axis=2, stride=2)
                sub["lh"][p][q] = _corr_axis(lo_xq, hi_f[p], axis=1, stride=2)
                sub["hl"][p][q] = _corr_axis(hi_xq, lo_f[p], axis=1, stride=2)
                sub["hh"][p][q] = _corr_axis(hi_xq, hi_f[p], axis=1, stride=2)
                new_grids[p][q] = _corr_axis(lo_xq, lo_f[p], axis=1, stride=2)
        level = []
        for name in ("lh", "hl", "hh"):
            s = sub[name]
            level.extend(_quads_to_complex(s[0][0], s[0][1], s[1][0], s[1][1]))
        out.append((torch.stack([re for re, _ in level], dim=1), torch.stack([im for _, im in level], dim=1)))
        grids = new_grids
    return out


def dtcwt_cw_ssim(rec, ref, scales: int = 5, K: float = 1e-6):
    """CW-SSIM on DTCWT coefficients of NCHW images: per level the pixelwise index
    (2|sum_o x conj(y)| + K) / (sum_o |x|^2 + sum_o |y|^2 + K), averaged over
    channels and pixels, then over levels; the batch mean. Levels the image cannot
    hold are not requested."""
    B, C, H, W = rec.shape
    usable = max(1, min(scales, int(np.floor(np.log2(max(min(H, W), 2)))) - 1))
    xs = dtcwt2d(rec.reshape(B * C, H, W), levels=usable)
    ys = dtcwt2d(ref.reshape(B * C, H, W), levels=usable)
    total = 0.0
    for (xr, xi), (yr, yi) in zip(xs, ys):
        conj_re = torch.sum(xr * yr + xi * yi, dim=1)
        conj_im = torch.sum(xi * yr - xr * yi, dim=1)
        num = 2.0 * torch.sqrt(conj_re ** 2 + conj_im ** 2) + K
        den = torch.sum(xr ** 2 + xi ** 2, dim=1) + torch.sum(yr ** 2 + yi ** 2, dim=1) + K
        total = total + torch.mean((num / den).reshape(B, -1), dim=1)
    return torch.mean(total / usable)
