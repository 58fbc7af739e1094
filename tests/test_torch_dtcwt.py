"""The port's dual-tree complex wavelet transform and its CW-SSIM against the JAX
package's (``breaching_tpu/analysis/dtcwt.py``) on the same images.

Tolerances (float32 on both sides, filters summed in other orders; the agreement
measured here in brackets): the reflect pad exactly; every level's coefficients to
1e-5 of the level's largest entry [2e-7]; ``dtcwt_cw_ssim`` to 1e-5 [1e-7]; the
golden value of ``tests/test_dtcwt.py`` to its own 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.analysis import dtcwt as jax_dtcwt
from breaching_tpu_torch.analysis import dtcwt
from breaching_tpu_torch.analysis import metrics

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("before,after", [(2, 2), (3, 4), (6, 7), (8, 5), (0, 1)])
def test_reflect_pad_folds_as_numpy(n, before, after):
    """Pads wider than the axis fold back again and again (a 4-wide grid under 14
    taps pads by 6 and 7), where F.pad(mode="reflect") refuses."""
    x = np.arange(3 * n, dtype=np.float32).reshape(3, n)
    want = np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (before, after)), mode="reflect"))
    got = dtcwt._reflect_pad(torch.from_numpy(x), 1, before, after).numpy()
    np.testing.assert_array_equal(got, want)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0.5, 0.2, size=shape), 0, 1).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, size=shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("shape,levels", [((2, 32, 32), 4), ((3, 16, 16), 3), ((1, 21, 34), 4)])
def test_coefficients_match(shape, levels):
    x, _ = _images(0, shape)
    got = dtcwt.dtcwt2d(torch.from_numpy(x), levels=levels)
    want = jax_dtcwt.dtcwt2d(jnp.asarray(x), levels=levels)
    assert len(got) == len(want) == levels
    for (re, im), (j_re, j_im) in zip(got, want):
        for part, j_part in ((re, j_re), (im, j_im)):
            j_part = np.asarray(j_part)
            assert part.shape == j_part.shape
            np.testing.assert_allclose(part.numpy(), j_part, rtol=0, atol=1e-5 * np.abs(j_part).max())


@pytest.mark.parametrize("size", [16, 32, 48])
@pytest.mark.parametrize("seed", [0, 1])
def test_cw_ssim_matches(size, seed):
    x, y = _images(seed, (2, 3, size, size))
    got = float(dtcwt.dtcwt_cw_ssim(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jax_dtcwt.dtcwt_cw_ssim(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                                         jnp.asarray(np.transpose(y, (0, 2, 3, 1)))))
    assert abs(got - want) <= 1e-5


def test_cw_ssim_golden_value():
    """The input and golden value of tests/test_dtcwt.py."""
    rng = np.random.default_rng(42)
    x = np.clip(rng.normal(0.5, 0.2, size=(1, 32, 32, 3)), 0, 1).astype(np.float32)
    noise = rng.normal(0, 0.05, size=x.shape).astype(np.float32)
    y = np.clip(x + noise, 0, 1)
    val = float(dtcwt.dtcwt_cw_ssim(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()),
                                    torch.from_numpy(np.transpose(y, (0, 3, 1, 2)).copy())))
    assert val == pytest.approx(0.9508, abs=2e-3)


def test_cw_ssim_forgives_a_shift_that_ssim_does_not():
    """The property the metric is reported for (tests/test_dtcwt.py's input)."""
    from scipy.ndimage import gaussian_filter

    img = np.clip(gaussian_filter(np.random.default_rng(7).normal(0.5, 0.25, size=(48, 48)), 1.5), 0, 1)
    a = torch.from_numpy(img[None, None].astype(np.float32))
    b = torch.from_numpy(np.roll(img, 3, axis=1)[None, None].astype(np.float32))
    cw, plain = float(dtcwt.dtcwt_cw_ssim(a, b)), float(metrics.ssim(a, b))
    assert cw > plain + 0.15 and cw > 0.5
