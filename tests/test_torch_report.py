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


def _shuffled(seed, noise, shape=(4, 3, 16, 16)):
    """A truth and a noisy reconstruction of it in another order: (rec, ref, perm) with
    rec[i] close to ref[perm[i]]."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, shape).astype(np.float32)
    perm = rng.permutation(shape[0])
    rec = np.clip(ref[perm] + noise * rng.normal(size=shape), 0, 1).astype(np.float32)
    return rec, ref, perm


@pytest.mark.parametrize("seed,noise", [(0, None), (1, None), (2, 0.05), (3, 0.3)])
def test_batch_order_matches_the_jax_package(seed, noise):
    """Independent random batches (noise None), and a truth shuffled into the
    reconstruction: the assignment by pixel MSE is the JAX package's, and on a
    shuffled truth it undoes the shuffle."""
    if noise is None:
        rec, ref = _pair(seed, shape=(5, 3, 16, 16), noise=1.0)
    else:
        rec, ref, perm = _shuffled(seed, noise)
    order = metrics.compute_batch_order(torch.from_numpy(rec), torch.from_numpy(ref))
    np.testing.assert_array_equal(order, jax_metrics.compute_batch_order(_nhwc(rec), _nhwc(ref)))
    if noise is not None:
        np.testing.assert_array_equal(perm[order], np.arange(len(perm)))
    assert metrics.compute_batch_order(torch.from_numpy(rec[:1]), torch.from_numpy(ref[:1])).tolist() == [0]


@pytest.fixture(scope="module")
def batch_cases():
    """Both packages' case (ConvNet-8 on CIFAR-10 shapes at 16x16, 4 images a user) on
    the same weights; the user's true data from each."""
    import jax

    import breaching_tpu as jax_breaching
    import breaching_tpu_torch as breaching

    overrides = ["case=1_single_image_small", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]",
                 "case.user.num_data_points=4", "case.data.batch_size=4", "seed=2"]
    jax_cfg = jax_breaching.get_config(overrides)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(
        jax_cfg.case, jax_breaching.utils.system_startup(cfg=jax_cfg))
    cfg = breaching.get_config(overrides)
    user, server, model, _ = breaching.cases.construct_case(
        cfg.case, breaching.utils.system_startup(cfg=cfg, device="cpu"))
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    _, payloads, true = server.run_protocol(user)
    _, j_payloads, j_true = j_server.run_protocol(j_user)
    return dict(report=breaching.analysis.report, payloads=payloads, true=true, model=server.model, cfg=cfg), \
        dict(report=jax_breaching.analysis.report, payloads=j_payloads, true=j_true, model=j_server.model,
             cfg=jax_cfg)


@pytest.mark.parametrize("with_labels", [True, False])
def test_report_on_a_batch_of_4_matches_the_jax_package(batch_cases, with_labels):
    """The truth shuffled and perturbed as the reconstruction: the report orders it
    back, and its order, PSNR, SSIM, worst-image MSE and label accuracy are the JAX
    package's; LPIPS is NaN on both (no LPIPS weights in the repo). Without labels the
    JAX package also takes the feature-space MSE in the new order, and it agrees."""
    port, ref = batch_cases
    truth = port["true"]["data"].numpy()
    rng = np.random.default_rng(5)
    perm = rng.permutation(4)
    rec = (truth[perm] + 0.3 * rng.normal(size=truth.shape)).astype(np.float32)
    labels = port["true"]["labels"].numpy()[perm] if with_labels else None
    got = port["report"](dict(data=torch.from_numpy(rec), labels=None if labels is None else torch.from_numpy(labels)),
                         port["true"], port["payloads"], port["model"], cfg_case=port["cfg"].case)
    want = ref["report"](dict(data=jnp.asarray(np.transpose(rec, (0, 2, 3, 1))),
                              labels=None if labels is None else jnp.asarray(labels)),
                         ref["true"], ref["payloads"], ref["model"], cfg_case=ref["cfg"].case)
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(perm[got["order"]], np.arange(4))
    for key in ("psnr", "max_mse", "mse"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])
    if with_labels:
        assert got["label_acc"] == want["label_acc"] == 1.0
    else:
        assert np.isnan(got["label_acc"]) and np.isnan(want["label_acc"])
        assert got["feat_mse"] == pytest.approx(want["feat_mse"], rel=1e-4)
