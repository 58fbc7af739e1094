"""The port's image metrics against the JAX package's on the same images.

Tolerances: float32 means over a few thousand pixels and an 11x11 gaussian
filter summed in other orders; MSE and PSNR agree to 1e-5 relative, SSIM, whose
values lie in [-1, 1], to 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.analysis import metrics as jax_metrics
from breaching_tpu_torch.analysis import metrics

torch.set_num_threads(1)


def _pair(seed, shape=(2, 3, 32, 32), noise=0.1):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, shape).astype(np.float32)
    rec = np.clip(ref + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    return rec, ref


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("noise", [0.01, 0.1, 0.5])
def test_mse_psnr_and_ssim_match(noise):
    rec, ref = _pair(0, noise=noise)
    mse, psnr = metrics.mse_psnr(torch.from_numpy(rec), torch.from_numpy(ref), clip=True)
    j_mse, j_psnr = jax_metrics.mse_psnr(_nhwc(rec), _nhwc(ref), clip=True)
    assert float(mse) == pytest.approx(float(j_mse), rel=1e-5)
    assert float(psnr) == pytest.approx(float(j_psnr), rel=1e-5)
    ssim = float(metrics.ssim(torch.from_numpy(rec), torch.from_numpy(ref)))
    assert abs(ssim - float(jax_metrics.ssim(_nhwc(rec), _nhwc(ref)))) <= 1e-5


def test_psnr_of_an_exact_match():
    rec, ref = _pair(1)
    rec[0] = ref[0]  # one exact image: its PSNR is infinite and left out of the mean
    _, psnr = metrics.mse_psnr(torch.from_numpy(rec), torch.from_numpy(ref))
    _, j_psnr = jax_metrics.mse_psnr(_nhwc(rec), _nhwc(ref))
    assert float(psnr) == pytest.approx(float(j_psnr), rel=1e-5)
    _, psnr = metrics.mse_psnr(torch.from_numpy(ref), torch.from_numpy(ref))
    assert float(psnr) == float("inf") == float(jax_metrics.mse_psnr(_nhwc(ref), _nhwc(ref))[1])
