"""The rest of the port's image metrics against the JAX package's on the same images:
registered PSNR, CW-SSIM over the Gabor bank, the IIP, the batch order by LPIPS
features, the gradient uniqueness, and the whole report with every IIP score.

Tolerances (float32 on both sides; the agreement measured here in brackets):
- the sampling grid: bit for bit against ``jnp.linspace`` [equal];
- the registration's first-step gradient from the identity warp, where sample
  positions sit on the clips' ties: 1e-6 of its largest entry [2e-7];
- the images after the full schedules (200 affine steps, 300 projective): 1e-4 of
  the largest entry [4e-7 at 16x16, 6e-7 at 32x32]; ``registered_psnr``: 1e-3 dB [0];
- ``gabor_cw_ssim``: 1e-5 [1e-7]; the golden values of
  ``tests/test_aux_subsystems.py`` to their own 2e-3;
- IIP, the gradient uniqueness and the batch order: exactly;
- the report: as ``tests/test_torch_report.py`` (MSE, PSNR 1e-5 relative; SSIM 1e-5),
  ``cw_ssim`` and ``gabor_cw_ssim`` 1e-5, ``rpsnr`` 1e-3 dB, LPIPS 1e-5 relative,
  the feature-space MSE 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.analysis import metrics as JM
from breaching_tpu.analysis.lpips import LPIPS as JaxLPIPS
import breaching_tpu_torch as breaching
from breaching_tpu_torch.analysis import metrics as M
from breaching_tpu_torch.analysis.lpips import LPIPS

torch.set_num_threads(1)


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _smooth_pair(seed, size, batch=2, shift=1, noise=0.05):
    """Smooth images and a shifted, noisy copy of them: something to register."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    ref = gaussian_filter(rng.uniform(0, 1, (batch, 3, size, size)), (0, 0, 1.5, 1.5)).astype(np.float32)
    rec = np.clip(np.roll(ref, shift, axis=3) + noise * rng.normal(size=ref.shape), 0, 1).astype(np.float32)
    return rec, ref


@pytest.mark.parametrize("size", [(h, h) for h in range(2, 65)] + [(224, 224), (16, 32), (31, 7)])
def test_grid_is_the_jax_packages_bit_for_bit(size):
    got = M._grid_coords(*size).numpy()
    want = np.asarray(JM._grid_coords(*size))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("warp", ["affine", "projective"])
@pytest.mark.parametrize("size", [16, 32])
def test_first_step_gradient_from_the_identity(warp, size, monkeypatch):
    rec, ref = _smooth_pair(0, size)
    port_warp, jax_warp, p0 = dict(affine=(M._affine_warp, JM._affine_warp, M._IDENTITY_THETA),
                                   projective=(M._projective_warp, JM._projective_warp, M._IDENTITY_H8))[warp]
    j_p0 = jnp.asarray(p0.reshape(2, 3) if warp == "affine" else p0)
    want = np.stack([np.asarray(jax.grad(lambda t, i=i: jnp.mean((jax_warp(_nhwc(rec)[i], t) - _nhwc(ref)[i]) ** 2))(
        j_p0)).reshape(-1) for i in range(len(rec))])
    got = M._warp_grad(torch.from_numpy(rec), torch.from_numpy(ref), port_warp,
                       torch.from_numpy(p0).expand(len(rec), -1).clone())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    # the identity puts samples on integer positions, where the clip of a weight sits
    # on a tie; torch.clamp, which passes the whole gradient there, misses the JAX one
    sx = (M._grid_coords(size, size)[0] + 1.0) * (size - 1) / 2.0
    wx = torch.clamp(sx - torch.clamp(torch.floor(sx), 0, size - 2), 0, 1)
    assert ((wx == 0) | (wx == 1)).sum() >= size
    monkeypatch.setattr(M, "_clip", torch.clamp)
    clamped = M._warp_grad(torch.from_numpy(rec), torch.from_numpy(ref), port_warp,
                           torch.from_numpy(p0).expand(len(rec), -1).clone())
    assert np.abs(clamped.numpy() - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("size", [16, 32])
def test_registrations_and_registered_psnr(size):
    rec, ref = _smooth_pair(1, size)
    for port_fn, jax_fn in ((M._register_affine, JM._register_affine),
                            (M._register_projective, JM._register_projective)):
        want = _nchw(jax_fn(_nhwc(rec), _nhwc(ref)))
        got = port_fn(torch.from_numpy(rec), torch.from_numpy(ref)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    got = float(M.registered_psnr(torch.from_numpy(rec), torch.from_numpy(ref)))
    want = float(JM.registered_psnr(_nhwc(rec), _nhwc(ref)))
    assert abs(got - want) <= 1e-3
    assert got >= float(M.mse_psnr(torch.from_numpy(rec), torch.from_numpy(ref), clip=True)[1])


def test_registered_psnr_of_identical_images_is_infinite():
    _, ref = _smooth_pair(2, 16)
    assert float(M.registered_psnr(torch.from_numpy(ref), torch.from_numpy(ref))) == float("inf")


@pytest.mark.parametrize("seed,noise", [(0, 0.02), (1, 0.2), (2, 1.0)])
def test_gabor_cw_ssim_matches(seed, noise):
    rec, ref = _smooth_pair(seed, 32, batch=3, shift=0, noise=noise)
    got = float(M.cw_ssim(torch.from_numpy(rec), torch.from_numpy(ref)))
    assert abs(got - float(JM.cw_ssim(_nhwc(rec), _nhwc(ref)))) <= 1e-5


def test_gabor_cw_ssim_golden_values():
    """The inputs and golden values of tests/test_aux_subsystems.py, made by the JAX
    package, scored by the port."""
    rng = np.random.RandomState(0)
    base = np.asarray(jax.nn.sigmoid(2 * jax.image.resize(
        jnp.asarray(rng.randn(2, 8, 8, 3), jnp.float32), (2, 32, 32, 3), "bilinear")))
    noisy = base + 0.1 * rng.randn(2, 32, 32, 3).astype(np.float32)
    shifted = np.roll(base, (1, 1), axis=(1, 2))
    random = rng.rand(2, 32, 32, 3).astype(np.float32)

    def score(x):
        return float(M.cw_ssim(torch.from_numpy(_nchw(x).copy()), torch.from_numpy(_nchw(base).copy())))

    np.testing.assert_allclose(score(base), 1.0, atol=1e-5)
    np.testing.assert_allclose(score(noisy), 0.67789, atol=2e-3)
    np.testing.assert_allclose(score(shifted), 0.89044, atol=2e-3)
    np.testing.assert_allclose(score(random), 0.06041, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_identifiability_precision_matches(seed):
    """Some reconstructions close to their truth, some close to a decoy, and the
    truth itself repeated in the pool (a tie that goes to the first candidate)."""
    rng = np.random.default_rng(seed)
    true = rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32)
    pool = rng.uniform(0, 1, (10, 3, 16, 16)).astype(np.float32)
    pool[3] = true[1]
    rec = true + 0.05 * rng.normal(size=true.shape).astype(np.float32)
    rec[2] = pool[5] + 0.01 * rng.normal(size=pool[5].shape).astype(np.float32)
    rec[1] = true[1]
    got = float(M.image_identifiability_precision(*(torch.from_numpy(x) for x in (rec, true, pool))))
    want = float(JM.image_identifiability_precision(_nhwc(rec), _nhwc(true), _nhwc(pool)))
    assert got == want == 0.75


def test_gradient_uniqueness_matches():
    rng = np.random.default_rng(3)
    grads = []
    for _ in range(3):
        grads.append({name: rng.normal(size=shape).astype(np.float32) * (rng.uniform(size=shape) < 0.4)
                      for name, shape in (("a", (5, 4)), ("b", (7,)))})
    want = float(JM.gradient_uniqueness([{k: jnp.asarray(v) for k, v in g.items()} for g in grads]))
    got = float(M.gradient_uniqueness([{k: torch.from_numpy(v) for k, v in g.items()} for g in grads]))
    assert got == want
    assert float(M.gradient_uniqueness([[torch.from_numpy(g["a"]), torch.from_numpy(g["b"])] for g in grads])) == want


@pytest.fixture(scope="module")
def alex_npz(tmp_path_factory):
    """Random AlexNet LPIPS weights written by the JAX package."""
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_alex.npz")
    JaxLPIPS.random_init("alex").save_npz(path)
    return path


@pytest.mark.parametrize("seed,noise", [(0, 0.05), (1, 0.3)])
def test_batch_order_by_lpips_features(alex_npz, seed, noise):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32)
    perm = rng.permutation(4)
    rec = np.clip(ref[perm] + noise * rng.normal(size=ref.shape), 0, 1).astype(np.float32)
    got = M.compute_batch_order(torch.from_numpy(rec), torch.from_numpy(ref), LPIPS.from_npz(alex_npz))
    want = JM.compute_batch_order(_nhwc(rec), _nhwc(ref), JaxLPIPS.from_npz(alex_npz))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(perm[got], np.arange(4))


@pytest.fixture(scope="module")
def cases():
    """Both packages' case (ConvNet-8, CIFAR-10 shapes at 16x16, 4 images a user) on the
    same weights; the payloads and the user's true data from each. User 1's images lie
    outside the IIP pool (the dataset's first 40): an image of the pool's own would tie
    with it up to rounding, and the nearest of the two is then the platform's choice."""
    overrides = ["case=1_single_image_small", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]",
                 "case.user.num_data_points=4", "case.data.batch_size=4", "case.impl.iip_pool_cap=40",
                 "case.user.user_idx=1", "seed=2"]
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
    return dict(payloads=payloads, true=true, model=server.model, cfg=cfg), \
        dict(payloads=j_payloads, true=j_true, model=j_server.model, cfg=jax_cfg)


@pytest.mark.parametrize("with_labels", [True, False])
def test_full_report_with_iip_matches(cases, alex_npz, monkeypatch, with_labels):
    """The truth shuffled and perturbed as the reconstruction, LPIPS weights on disk,
    ``compute_full_iip=True``: every key the JAX package returns, in its order, with
    its values; the caller's dict takes the matched order (``data`` and ``order``)
    without labels and keeps its own with them, and the feature-space MSE follows
    the caller's dict in both."""
    monkeypatch.setenv("BREACHING_LPIPS_WEIGHTS", alex_npz)
    port, ref = cases
    truth = port["true"]["data"].numpy()
    rng = np.random.default_rng(5)
    perm = rng.permutation(4)
    rec = (truth[perm] + 0.3 * rng.normal(size=truth.shape)).astype(np.float32)
    labels = port["true"]["labels"].numpy()[perm] if with_labels else None
    rec_data = dict(data=torch.from_numpy(rec), labels=None if labels is None else torch.from_numpy(labels))
    j_rec_data = dict(data=_nhwc(rec), labels=None if labels is None else jnp.asarray(labels))
    got = breaching.analysis.report(rec_data, port["true"], port["payloads"], port["model"],
                                    compute_full_iip=True, cfg_case=port["cfg"].case)
    want = jax_breaching.analysis.report(j_rec_data, ref["true"], ref["payloads"], ref["model"],
                                         compute_full_iip=True, cfg_case=ref["cfg"].case)
    assert list(got) == list(want)
    assert {"cw_ssim", "gabor_cw_ssim", "rpsnr", "IIP-pixel", "IIP-lpips", "IIP-self"} <= set(got)
    np.testing.assert_array_equal(got["order"], want["order"])
    np.testing.assert_array_equal(perm[got["order"]], np.arange(4))
    for key in ("mse", "psnr", "max_mse"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    for key in ("ssim", "cw_ssim", "gabor_cw_ssim"):
        assert abs(got[key] - want[key]) <= 1e-5, key
    assert abs(got["rpsnr"] - want["rpsnr"]) <= 1e-3
    assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-5)
    for key in ("IIP-pixel", "IIP-lpips", "IIP-self", "parameters"):
        assert got[key] == want[key], key
    assert got["feat_mse"] == pytest.approx(want["feat_mse"], rel=1e-4)
    if with_labels:
        assert got["label_acc"] == want["label_acc"] == 1.0
        assert set(rec_data) == set(j_rec_data) == {"data", "labels"}
        np.testing.assert_array_equal(rec_data["data"].numpy(), rec)
    else:
        assert np.isnan(got["label_acc"]) and np.isnan(want["label_acc"])
        assert set(rec_data) == set(j_rec_data) == {"data", "labels", "order"}
        np.testing.assert_array_equal(rec_data["order"], j_rec_data["order"])
        np.testing.assert_array_equal(rec_data["data"].numpy(), rec[got["order"]])
        np.testing.assert_array_equal(_nchw(j_rec_data["data"]), rec[got["order"]])


def test_label_accuracy_leaves_out_the_ignore_index():
    from breaching_tpu.analysis.analysis import _label_accuracy as jax_label_accuracy
    from breaching_tpu_torch.analysis.analysis import _label_accuracy

    rec, true = dict(labels=np.asarray([3, -100, 1, 1])), dict(labels=np.asarray([1, 3, -100, 2]))
    assert _label_accuracy(rec, true) == jax_label_accuracy(rec, true, None) == 2 / 3


def test_iip_pool_stops_at_the_cap(cases, monkeypatch):
    """The pool holds the first ``iip_pool_cap`` images of the full dataset, and the
    loader is not drawn past the batch that reaches the cap."""
    from breaching_tpu.analysis.analysis import _compute_iip as jax_compute_iip
    from breaching_tpu_torch.analysis import analysis
    from breaching_tpu_torch.cases.data import data_preparation

    port, ref = cases
    drawn = []
    real_iter = data_preparation.DataLoader.__iter__

    def counting_iter(self):
        for batch in real_iter(self):
            drawn.append(len(batch["inputs"]))
            yield batch

    monkeypatch.setattr(data_preparation.DataLoader, "__iter__", counting_iter)
    pool = analysis._iip_pool(port["cfg"].case, 10, torch.device("cpu"))
    assert pool.shape == (10, 3, 16, 16) and drawn == [4, 4, 4]
    truth = torch.clamp(port["true"]["data"] * 0.25 + 0.5, 0, 1)
    for cap in (6, 0):
        monkeypatch.setitem(port["cfg"].case.impl, "iip_pool_cap", cap)
        monkeypatch.setitem(ref["cfg"].case.impl, "iip_pool_cap", cap)
        got = analysis._compute_iip(truth, truth, port["cfg"].case, model=port["model"])
        want = jax_compute_iip(_nhwc(truth.numpy()), _nhwc(truth.numpy()), ref["cfg"].case, model=ref["model"])
        assert got == want
