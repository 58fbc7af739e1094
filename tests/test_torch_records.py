"""The run's records (``utils.save_summary``, ``dump_metrics``, ``save_reconstruction``)
of the port against the JAX package's, and the data utilities ``CachedDataset`` and
``measure_mean_std``.

The entry point's records are compared on one run of each package's
``simulate_breach.main_process`` on the same weights and the same initial candidate
(2 hard-signed Adam steps, ConvNet-8 at 16x16): the summary table's header equal, every
value equal but the metrics', which agree to 1e-3 relative (1e-4 on ``mse`` and
``psnr``; the indices in [-1, 1], SSIM and the CW-SSIMs, and the attack's cosine
distance ``opt_value`` to 1e-5 absolute; the two
attacks' pixels are not bit for bit the same, as ``tests/test_torch_attack.py`` holds
them), and two columns left out:
``total_time`` (seconds of each run) and ``base_dir`` (each package writes into a
directory of its own). The metrics' YAML and the PNGs are compared on the same input:
the same dict through both packages' ``dump_metrics`` reads back equal (NaN where NaN),
and the same reconstruction through both ``save_reconstruction`` decodes to equal
arrays.
"""

import csv
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
import simulate_breach as jax_simulate
from breaching_tpu.cases.data.cached_dataset import CachedDataset as JaxCachedDataset
from breaching_tpu.cases.data.datasets_vision import VisionDataset as JaxVisionDataset
from breaching_tpu.cases.data.datasets_vision import measure_mean_std as jax_measure_mean_std
from breaching_tpu_torch.cases.data.cached_dataset import CachedDataset
from breaching_tpu_torch.cases.data.datasets_vision import VisionDataset, measure_mean_std
from breaching_tpu_torch.config.loader import parse_yaml
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
CASE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
        "case.data.shape=[3, 16, 16]", "seed=0"]
# metric columns and their tolerance, relative (or absolute for the indices in [-1, 1]):
# two attacks whose pixels differ in the last bits
METRIC_TOLERANCE = dict(mse=1e-4, psnr=1e-4, rpsnr=1e-3, max_mse=1e-3, feat_mse=1e-3)
# opt_value, a cosine distance 1 - cos with cos close to 1, keeps only absolute precision
ABSOLUTE = dict(ssim=1e-5, cw_ssim=1e-5, gabor_cw_ssim=1e-5, opt_value=1e-5)


def align_packages(monkeypatch, x0):
    """Make both packages' entry points run on the JAX package's model weights and start
    their attacks from x0 (NCHW, one row per image): the JAX entry point must run first
    (it leaves its model for the port's)."""
    models = []
    jax_construct, port_construct = jax_breaching.cases.construct_model, breaching.cases.construct_model

    def jax_construct_model(*args, **kwargs):
        model, loss = jax_construct(*args, **kwargs)
        models.append(model)
        return model, loss

    def port_construct_model(*args, **kwargs):
        model, loss = port_construct(*args, **kwargs)
        model.from_jax_state(jax.tree_util.tree_map(np.array, models[-1].params),
                             jax.tree_util.tree_map(np.array, models[-1].buffers))
        return model, loss

    monkeypatch.setattr(jax_breaching.cases, "construct_model", jax_construct_model)
    monkeypatch.setattr(breaching.cases, "construct_model", port_construct_model)
    jax_prepare, port_prepare = jax_breaching.attacks.prepare_attack, breaching.attacks.prepare_attack
    x0_nhwc = jnp.asarray(np.transpose(x0, (0, 2, 3, 1)))

    def jax_prepare_attack(*args, **kwargs):
        attacker = jax_prepare(*args, **kwargs)
        attacker._initialize_data = lambda shape, key: jnp.broadcast_to(x0_nhwc, shape)
        return attacker

    def port_prepare_attack(*args, **kwargs):
        attacker = port_prepare(*args, **kwargs)
        attacker._initialize_data = lambda shape: torch.from_numpy(np.broadcast_to(x0, shape).copy())
        return attacker

    monkeypatch.setattr(jax_breaching.attacks, "prepare_attack", jax_prepare_attack)
    monkeypatch.setattr(breaching.attacks, "prepare_attack", port_prepare_attack)


def _table(path):
    with open(path) as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    return rows[0], rows[1:]


def _close(got, want, rel, absolute=0.0):
    got, want = float(got), float(want)
    return (math.isnan(got) and math.isnan(want)) or got == want or abs(got - want) <= rel * abs(want) + absolute


def _metric_close(key, got, want):
    return _close(got, want, METRIC_TOLERANCE.get(key, 0.0), ABSOLUTE.get(key, 0.0))


@pytest.fixture(scope="module")
def entry_runs(tmp_path_factory):
    """One run of each package's simulate_breach with save_reconstruction=True."""
    root = tmp_path_factory.mktemp("records")
    x0 = np.random.default_rng(3).normal(size=(1, 3, 16, 16)).astype(np.float32)
    overrides = CASE + ["attack.optim.max_iterations=2", "attack.optim.callback=1", "save_reconstruction=True",
                        "name=records"]
    with pytest.MonkeyPatch.context() as monkeypatch:
        align_packages(monkeypatch, x0)
        want = jax_simulate.main_process(0, 1, jax_breaching.get_config(overrides + [f"base_dir={root}/jax"]))
        got = main_process(breaching.get_config(overrides + [f"base_dir={root}/port"]), device="cpu")
    return root, got, want


def test_summary_row_matches_the_jax_package(entry_runs):
    root, got, want = entry_runs
    header, rows = _table(root / "port" / "tables" / "table_breach_single_image_small.csv")
    j_header, j_rows = _table(root / "jax" / "tables" / "table_breach_single_image_small.csv")
    assert header == j_header and len(rows) == len(j_rows) == 1
    assert {"cw_ssim", "gabor_cw_ssim", "rpsnr", "lpips", "feat_mse", "total_time"} <= set(header)
    for key, value, j_value in zip(header, rows[0], j_rows[0]):
        if key in ("total_time", "base_dir"):
            continue
        if key in METRIC_TOLERANCE or key in ABSOLUTE:
            assert _metric_close(key, value, j_value), (key, value, j_value)
        else:
            assert value == j_value, (key, value, j_value)
    assert rows[0][header.index("base_dir")] == str(root / "port")


def test_metrics_yaml_matches_the_jax_package(entry_runs):
    root, got, want = entry_runs
    with open(root / "port" / "metrics_records.yaml") as fh:
        text = fh.read()
    with open(root / "jax" / "metrics_records.yaml") as fh:
        j_loaded = yaml.safe_load(fh)
    loaded = yaml.safe_load(text)
    assert list(loaded) == list(j_loaded) == sorted(want)
    for key, value in loaded.items():
        assert type(value) is type(j_loaded[key]), key
        if isinstance(value, float):
            assert _metric_close(key, value, j_loaded[key]), key
        else:
            assert value == j_loaded[key], key
    assert _equal_nan(parse_yaml(text), loaded)


def test_entry_point_saves_its_reconstruction(entry_runs):
    root, _, _ = entry_runs
    image = np.asarray(Image.open(root / "port" / "reconstructions" / "records_rec_0.png"))
    assert image.shape == (16, 16, 3) and image.dtype == np.uint8
    assert os.path.exists(root / "jax" / "reconstructions" / "records_rec_0.png")


def _equal_nan(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal_nan(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_equal_nan(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


class _Cfg(dict):
    __getattr__ = dict.__getitem__


def test_dump_metrics_of_one_dict_reads_back_equal(tmp_path):
    """The metrics' types and the values that need YAML's care: NaN, infinities, floats
    without a dot in their repr, numpy scalars, arrays, None, strings that would read
    as another type."""
    metrics = {"mse": 0.00123, "psnr": float("inf"), "lpips": float("nan"), "low": float("-inf"), "tiny": 1e-05,
               "big": 1.5e+20, "whole": 3.0, "np_float": np.float32(0.25), "np_int": np.int64(7), "parameters": 2906,
               "order": np.asarray([2, 0, 1]), "nested": [[0.5, 1.0], [2.0, float("nan")]], "none": None,
               "flag": True, "label": "Label Acc", "yes": "yes", "number": "12", "empty": [], "IIP-pixel": 0.75,
               "torch_order": torch.tensor([1, 0])}
    j_metrics = {k: (np.asarray(v) if isinstance(v, torch.Tensor) else v) for k, v in metrics.items()}
    for package, data, name in ((breaching, metrics, "port"), (jax_breaching, j_metrics, "jax")):
        package.utils.dump_metrics(_Cfg(name=name), data, out_dir=str(tmp_path))
    with open(tmp_path / "metrics_port.yaml") as fh:
        text = fh.read()
    with open(tmp_path / "metrics_jax.yaml") as fh:
        want = yaml.safe_load(fh)
    assert _equal_nan(yaml.safe_load(text), want)
    assert _equal_nan(parse_yaml(text), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_saved_pngs_decode_to_the_jax_packages_pixels(tmp_path, seed):
    """The same reconstruction through both packages' ``save_reconstruction``: equal
    pixels, values on the clip bounds and on exact multiples of 1/255 included."""
    rng = np.random.default_rng(seed)
    mean, std = [0.4914, 0.4822, 0.4465], [0.2470, 0.2435, 0.2616]
    pixels = rng.uniform(-0.1, 1.1, (3, 3, 16, 20))
    pixels[0, :, 0] = np.arange(20) / 255.0
    data = ((pixels - np.asarray(mean)[:, None, None]) / np.asarray(std)[:, None, None]).astype(np.float32)
    metadata = _Cfg(modality="vision", mean=mean, std=std)
    breaching.utils.save_reconstruction(dict(data=torch.from_numpy(data)), [dict(metadata=metadata)], None,
                                        _Cfg(name="port", base_dir=str(tmp_path)))
    jax_breaching.utils.save_reconstruction(dict(data=jnp.asarray(np.transpose(data, (0, 2, 3, 1)))),
                                            [dict(metadata=metadata)], None, _Cfg(name="jax", base_dir=str(tmp_path)))
    for idx in range(3):
        got = np.asarray(Image.open(tmp_path / "reconstructions" / f"port_rec_{idx}.png"))
        want = np.asarray(Image.open(tmp_path / "reconstructions" / f"jax_rec_{idx}.png"))
        assert got.shape == (16, 20, 3)
        np.testing.assert_array_equal(got, want)
    breaching.utils.save_reconstruction(dict(data=torch.from_numpy(data)), [dict(metadata=metadata)], None,
                                        _Cfg(name="port", base_dir=str(tmp_path)), user_idx=4)
    assert os.path.exists(tmp_path / "reconstructions" / "port_user4_rec_2.png")


def test_table_keeps_its_columns_and_skips_dry_runs(tmp_path):
    breaching.utils.save_to_table(str(tmp_path), "t", False, a=1, b="x")
    breaching.utils.save_to_table(str(tmp_path), "t", False, b=2, c=3)
    breaching.utils.save_to_table(str(tmp_path), "t", True, a=5, b=6)
    jax_breaching.utils.save_to_table(str(tmp_path), "j", False, a=1, b="x")
    jax_breaching.utils.save_to_table(str(tmp_path), "j", False, b=2, c=3)
    with open(tmp_path / "t.csv") as fh, open(tmp_path / "j.csv") as j_fh:
        assert fh.read() == j_fh.read() == "a\tb\n1\tx\n\t2\n"


def test_flatten_and_average_match():
    nested = {"a": 1, "b": {"c": 2.0, "d": {"e": "x"}}, "f": [1, 2]}
    assert breaching.utils.flatten(nested) == jax_breaching.utils.flatten(nested)
    dicts = [dict(psnr=20.0, lpips=float("nan"), n=np.int64(3), name="x"), dict(psnr=np.float32(22.0), n=1)]
    assert breaching.utils.avg_n_dicts(dicts) == jax_breaching.utils.avg_n_dicts(dicts) == dict(psnr=21.0, n=2.0)


@pytest.fixture(scope="module")
def datasets():
    """Both packages' CIFAR-10 validation views of 6 examples at 8x8."""
    port_cfg, jax_cfg = breaching.get_case_config("1_single_image_small"), jax_breaching.get_case_config(
        "1_single_image_small")
    port_cfg.data.shape = jax_cfg.data.shape = [3, 8, 8]
    return (VisionDataset(port_cfg.data, split="validation").subset(np.arange(6)),
            JaxVisionDataset(jax_cfg.data, split="validation").subset(np.arange(6)))


def test_cached_dataset_matches(datasets):
    port, ref = datasets
    cached, j_cached = CachedDataset(port), JaxCachedDataset(ref)
    assert len(cached) == len(j_cached) == 6
    np.testing.assert_array_equal(cached.labels, j_cached.labels)
    for idx in range(6):
        np.testing.assert_array_equal(cached[idx]["inputs"], np.transpose(j_cached[idx]["inputs"], (2, 0, 1)))
        np.testing.assert_array_equal(cached[idx]["inputs"], port[idx]["inputs"])
    np.testing.assert_array_equal(cached.mean, j_cached.mean)
    assert cached.name == j_cached.name


@pytest.mark.parametrize("max_items", [None, 4])
def test_measure_mean_std_matches(datasets, max_items):
    port, ref = datasets
    mean, std = measure_mean_std(port, max_items)
    j_mean, j_std = jax_measure_mean_std(ref, max_items)
    np.testing.assert_allclose(mean, j_mean, rtol=1e-12)
    np.testing.assert_allclose(std, j_std, rtol=1e-12)
