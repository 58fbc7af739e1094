"""Image-quality metrics on NCHW batches in [0, 1] (counterpart of
``breaching_tpu/analysis/metrics.py``): MSE and PSNR, SSIM, CW-SSIM over a Gabor
bank, registered PSNR, the image identifiability precision (IIP), the batch order
by pixels or LPIPS features, and the gradient uniqueness diagnostic.

Registered PSNR follows the JAX package's arithmetic where its result depends on it:
the sampling grid is ``jnp.linspace``'s float32 values bit for bit (XLA on the CPU
multiplies by the reciprocal of n - 1 and fuses the last product into an FMA; the
grid here reproduces that for every side from 2 to 299 pixels), the clips inside the
warp split their gradient in half at a tie as ``jnp.clip`` does, and Adam is optax's
(``optimizers.FirstOrder``). The JAX package ``vmap``s the registration over the
images; here the batch carries one row of warp parameters per image and the
per-image losses are summed, which gives each row its own image's gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..attacks.auxiliaries.optimizers import FirstOrder


def mse_psnr(rec, ref, factor: float = 1.0, clip: bool = False):
    """Batch-mean MSE and the mean PSNR over the images of finite PSNR
    (inf if every image matches exactly)."""
    if clip:
        rec = torch.clamp(rec, 0, 1)
    mse_per = torch.mean((rec - ref) ** 2, dim=tuple(range(1, rec.dim())))
    psnrs = torch.where(mse_per > 0, 10.0 * torch.log10(factor ** 2 / torch.clamp(mse_per, min=1e-20)),
                        torch.full_like(mse_per, float("inf")))
    finite = torch.isfinite(psnrs)
    mean_psnr = psnrs[finite].mean() if finite.any() else torch.tensor(float("inf"), device=rec.device)
    return mse_per.mean(), mean_psnr


def _gaussian_kernel(size: int = 11, sigma: float = 1.5):
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(rec, ref, max_val: float = 1.0):
    """Mean SSIM over the batch with per-channel 11x11 gaussian windows (sigma 1.5)."""
    channels = rec.shape[1]
    kernel = _gaussian_kernel().to(rec.device, rec.dtype).expand(channels, 1, 11, 11)

    def filt(x):
        return F.conv2d(x, kernel, groups=channels)

    mu_x, mu_y = filt(rec), filt(ref)
    sigma_x = filt(rec * rec) - mu_x ** 2
    sigma_y = filt(ref * ref) - mu_y ** 2
    sigma_xy = filt(rec * ref) - mu_x * mu_y
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean()


def _gabor_bank(size: int = 7, scales=(1.5, 3.0), orientations=4):
    """The complex Gabor bank of the JAX package's CW-SSIM: (S*O, size, size), each
    filter of zero mean and unit norm."""
    coords = np.arange(size) - (size - 1) / 2.0
    yy, xx = np.meshgrid(coords, coords, indexing="ij")
    kernels = []
    for sigma in scales:
        for k in range(orientations):
            theta = np.pi * k / orientations
            xr = xx * np.cos(theta) + yy * np.sin(theta)
            envelope = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2))
            kern = envelope * np.exp(1j * 2 * np.pi * xr / (2 * sigma))
            kern -= kern.mean()
            kernels.append(kern / np.linalg.norm(kern))
    return np.stack(kernels)


def cw_ssim(rec, ref, k: float = 1e-6):
    """CW-SSIM's index (2|sum cx cy*| + K) / (sum |cx|^2 + |cy|^2 + K) over the Gabor
    bank's coefficients of the luminance, averaged over the filters and the batch
    (reported as ``gabor_cw_ssim``; ``dtcwt.dtcwt_cw_ssim`` is ``cw_ssim``)."""
    rec_g, ref_g = rec.mean(dim=1, keepdim=True), ref.mean(dim=1, keepdim=True)
    total = 0.0
    bank = _gabor_bank()
    for kern in bank:
        kr = torch.as_tensor(np.real(kern), dtype=torch.float32, device=rec.device)[None, None]
        ki = torch.as_tensor(np.imag(kern), dtype=torch.float32, device=rec.device)[None, None]
        ar, ai = F.conv2d(rec_g, kr)[:, 0], F.conv2d(rec_g, ki)[:, 0]
        br, bi = F.conv2d(ref_g, kr)[:, 0], F.conv2d(ref_g, ki)[:, 0]
        dot_re = torch.sum(ar * br + ai * bi, dim=(1, 2))
        dot_im = torch.sum(ai * br - ar * bi, dim=(1, 2))
        num = 2 * torch.sqrt(dot_re ** 2 + dot_im ** 2) + k
        den = torch.sum(ar ** 2 + ai ** 2 + br ** 2 + bi ** 2, dim=(1, 2)) + k
        total = total + torch.mean(num / den)
    return total / len(bank)


# ----------------------------------------------------------------------------- registered PSNR

def _linspace(n: int) -> np.ndarray:
    """``jnp.linspace(-1.0, 1.0, n)`` as XLA computes it on the CPU, in float32: with
    s = i * float32(1 / (n - 1)) and c = 1 - s, the entry i is fma(i, 1 / (n - 1), -c)
    (the product exact in float64, one rounding), and the last entry is 1."""
    if n == 1:
        return np.asarray([-1.0], np.float32)
    i = np.arange(n - 1, dtype=np.float32)
    r = np.float32(1) / np.float32(n - 1)
    c = np.float32(1) - i * r
    return np.concatenate([(i.astype(np.float64) * np.float64(r) - c).astype(np.float32), [np.float32(1)]])


def _grid_coords(H, W, device=None, dtype=torch.float32):
    """(3, H*W): the normalized x, y of every pixel (row-major) and a row of ones."""
    ys, xs = _linspace(H), _linspace(W)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(H * W, np.float32)], axis=0)
    return torch.as_tensor(grid, device=device).to(dtype)


def _clip(x, lo, hi):
    """``jnp.clip``: at x == lo or x == hi half of the gradient passes (torch.clamp passes all)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _sample_normalized(img, src):
    """Bilinear samples of a batch of NCHW images at normalized [-1, 1] source
    coordinates src (B, 2, H*W); differentiable in src. Returns (B, C, H, W)."""
    B, C, H, W = img.shape
    sx = (src[:, 0] + 1.0) * (W - 1) / 2.0
    sy = (src[:, 1] + 1.0) * (H - 1) / 2.0
    x0 = _clip(torch.floor(sx), 0, W - 2)
    y0 = _clip(torch.floor(sy), 0, H - 2)
    wx = _clip(sx - x0, 0.0, 1.0)
    wy = _clip(sy - y0, 0.0, 1.0)
    x0i, y0i = x0.long().detach(), y0.long().detach()
    flat = img.reshape(B, C, H * W)

    def at(yy, xx):
        return torch.gather(flat, 2, (yy * W + xx)[:, None, :].expand(B, C, -1))

    out = (at(y0i, x0i) * ((1 - wy) * (1 - wx))[:, None]
           + at(y0i, x0i + 1) * ((1 - wy) * wx)[:, None]
           + at(y0i + 1, x0i) * (wy * (1 - wx))[:, None]
           + at(y0i + 1, x0i + 1) * (wy * wx)[:, None])
    return out.reshape(B, C, H, W)


def _affine_warp(img, theta, grid=None):
    """Warp each image through its 2x3 affine map: theta (B, 6); ``grid`` is
    ``_grid_coords`` of the images, made here if not given."""
    grid = _grid_coords(*img.shape[2:], device=img.device, dtype=img.dtype) if grid is None else grid
    return _sample_normalized(img, theta.reshape(-1, 2, 3) @ grid)


def _projective_warp(img, h8, grid=None):
    """Warp each image through its homography: h8 (B, 8), the 3x3 matrix with the
    bottom-right entry pinned to 1 (kornia's 'homography' model)."""
    grid = _grid_coords(*img.shape[2:], device=img.device, dtype=img.dtype) if grid is None else grid
    hm = torch.cat([h8, torch.ones_like(h8[:, :1])], dim=1).reshape(-1, 3, 3)
    src = hm @ grid
    w = src[:, 2]
    w = torch.where(torch.abs(w) < 1e-6, torch.sign(w) * 1e-6 + 1e-12, w)
    return _sample_normalized(img, src[:, :2] / w[:, None])


_IDENTITY_THETA = np.asarray([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], np.float32)
_IDENTITY_H8 = np.asarray([1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], np.float32)


def _warp_grad(rec, ref, warp_fn, params):
    """The gradient of the per-image losses mean((warp(rec_i) - ref_i)^2), summed, with
    respect to every image's own warp parameters."""
    params = params.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = torch.sum(torch.mean((warp_fn(rec, params) - ref) ** 2, dim=(1, 2, 3)))
        return torch.autograd.grad(loss, params)[0]


def _register_warped(rec, ref, warp_fn, theta0_np, steps: int = 200, lr: float = 0.02):
    """Per-image registration: ``steps`` steps of optax's Adam at ``lr`` on
    MSE(warp(rec_i), ref_i) from the identity warp; returns the warped images."""
    grid = _grid_coords(*rec.shape[2:], device=rec.device, dtype=rec.dtype)
    warp = functools.partial(warp_fn, grid=grid)
    params = torch.as_tensor(theta0_np, device=rec.device).to(rec.dtype).expand(rec.shape[0], -1).clone()
    adam = FirstOrder(lambda step: lr, "adamw", eps=1e-8, weight_decay=0.0)
    state = adam.init(params)
    for _ in range(steps):
        params = adam.update(_warp_grad(rec, ref, warp, params), state, params)
    with torch.no_grad():
        return warp(rec, params)


def _register_affine(rec, ref):
    """6-parameter affine registration (translation, scale, rotation, shear)."""
    return _register_warped(rec, ref, _affine_warp, _IDENTITY_THETA)


def _register_projective(rec, ref):
    """8-parameter projective registration, at the JAX package's smaller step size."""
    return _register_warped(rec, ref, _projective_warp, _IDENTITY_H8, steps=300, lr=0.01)


def registered_psnr(rec, ref, factor: float = 1.0):
    """The best PSNR of: the images as they are, rolled by each of 25 integer shifts
    of up to 2 pixels, registered by an affine map and by a homography (the JAX
    package's ``registered_psnr``); never below the unregistered PSNR."""
    def psnr_at(rec_s):
        return mse_psnr(rec_s, ref, factor=factor, clip=True)[1]

    with torch.no_grad():
        best = psnr_at(rec)
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                best = torch.maximum(best, psnr_at(torch.roll(rec, (dy, dx), dims=(2, 3))))
    best = torch.maximum(best, psnr_at(_register_affine(rec, ref)))
    return torch.maximum(best, psnr_at(_register_projective(rec, ref)))


# ----------------------------------------------------------------------------- IIP and batch order

def image_identifiability_precision(rec_denorm, true_denorm, pool_denorm):
    """The fraction of reconstructions whose nearest neighbour (squared distance)
    among the true images followed by the pool is their own true image; ties go to
    the first candidate. One reconstruction at a time, to bound the memory."""
    num_images = rec_denorm.shape[0]
    pool = torch.cat([true_denorm, pool_denorm], dim=0)
    pool_flat = pool.reshape(pool.shape[0], -1)
    rec_flat = rec_denorm.reshape(num_images, -1)
    nearest = torch.stack([torch.argmin(torch.sum((row[None, :] - pool_flat) ** 2, dim=-1)) for row in rec_flat])
    return torch.mean((nearest == torch.arange(num_images, device=nearest.device)).float())


def compute_batch_order(rec, ref, lpips_scorer=None):
    """The order of the reconstructed images that matches them to the true ones:
    the assignment of least total cost, with cost[i, j] = mean((ref_i - rec_j)^2)
    over each pair of images (LPIPS features where a scorer is given, pixels
    otherwise), the truth on the rows, solved on the host. ``rec[order]`` lines up
    with ``ref``."""
    from scipy.optimize import linear_sum_assignment

    num_images = rec.shape[0]
    if num_images == 1:
        return np.asarray([0])
    if lpips_scorer is not None:
        rec_flat, ref_flat = lpips_scorer.features(rec), lpips_scorer.features(ref)
    else:
        rec_flat, ref_flat = rec.reshape(num_images, -1), ref.reshape(num_images, -1)
    cost = torch.mean((ref_flat[:, None, :] - rec_flat[None, :, :]) ** 2, dim=-1)
    _, order = linear_sum_assignment(cost.cpu().numpy())
    return order


def gradient_uniqueness(grads_per_example):
    """Diagnostic: the fraction of gradient entries that exactly one example touches
    (nonzero), as a float32 scalar. ``grads_per_example`` holds one gradient per
    example, each a dict or a sequence of tensors in a fixed order."""
    leaves = [list(g.values()) if isinstance(g, dict) else list(g) for g in grads_per_example]
    total = unique = 0
    for per_leaf in zip(*leaves):
        counts = torch.sum(torch.stack([torch.abs(g) > 0 for g in per_leaf]), dim=0)
        unique += int(torch.sum(counts == 1))
        total += counts.numel()
    return torch.tensor(unique, dtype=torch.float32) / max(total, 1)
