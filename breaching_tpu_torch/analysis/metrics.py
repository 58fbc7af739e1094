"""Image-quality metrics on NCHW batches in [0, 1] (counterpart of
``breaching_tpu/analysis/metrics.py`` ``mse_psnr``, ``ssim`` and, without LPIPS,
``compute_batch_order``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse_psnr(rec, ref, factor: float = 1.0, clip: bool = False):
    """Batch-mean MSE and the mean PSNR over the images of finite PSNR
    (inf if every image matches exactly)."""
    if clip:
        rec = torch.clamp(rec, 0, 1)
    mse_per = torch.mean((rec - ref) ** 2, dim=tuple(range(1, rec.dim())))
    psnrs = torch.where(mse_per > 0, 10.0 * torch.log10(factor ** 2 / torch.clamp(mse_per, min=1e-20)),
                        torch.full_like(mse_per, float("inf")))
    finite = torch.isfinite(psnrs)
    mean_psnr = psnrs[finite].mean() if finite.any() else torch.tensor(float("inf"))
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


def compute_batch_order(rec, ref):
    """The order of the reconstructed images that matches them to the true ones:
    the assignment of least total cost, with cost[i, j] = mean((ref_i - rec_j)^2)
    over each pair of images, the truth on the rows, solved on the host (reference
    ``breaching_tpu/analysis/metrics.py:244-266`` without an LPIPS scorer).
    ``rec[order]`` lines up with ``ref``."""
    from scipy.optimize import linear_sum_assignment

    num_images = rec.shape[0]
    if num_images == 1:
        return np.asarray([0])
    rec_flat, ref_flat = rec.reshape(num_images, -1), ref.reshape(num_images, -1)
    cost = torch.mean((ref_flat[:, None, :] - rec_flat[None, :, :]) ** 2, dim=-1)
    _, order = linear_sum_assignment(cost.cpu().numpy())
    return order
