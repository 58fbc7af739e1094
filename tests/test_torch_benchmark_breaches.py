"""The port's ``benchmark_breaches`` against the JAX package's, on the same weights and the
same initial candidates (ConvNet-8 at 16x16, one image a user, dry runs of 2 users),
one user at a time and as a fleet of 2: the users' rows (each report with every IIP
score), each user's ``Trial_<t>_Val`` sliced out of the wave's stats, and the averaged
row. Then the port alone: its tables and images on disk, a user whose report fails,
and Ctrl-C in the middle of a wave.

Tolerances as ``tests/test_torch_records.py`` holds the metrics (the two attacks'
pixels are not bit for bit the same); the losses of each trial to 1e-3 relative, as
``tests/test_torch_fleet.py`` holds the fleet's.
"""

import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

import benchmark_breaches as jax_benchmark
import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch import benchmark_breaches
from test_torch_records import _metric_close, align_packages

torch.set_num_threads(1)
BASE = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
        "case.data.shape=[3, 16, 16]", "case.user.num_data_points=1", "case.user.provide_labels=True",
        "case.impl.iip_pool_cap=64", "attack.optim.callback=1", "seed=4", "name=bench"]


def _spy(monkeypatch, package):
    """Record every save_summary call of ``package``'s benchmark: (metrics, stats, table)."""
    calls, real = [], package.utils.save_summary

    def save_summary(cfg, metrics, stats, local_time, table_name="breach"):
        calls.append((metrics, stats, table_name))
        return real(cfg, metrics, stats, local_time, table_name=table_name)

    monkeypatch.setattr(package.utils, "save_summary", save_summary)
    return calls


@pytest.mark.parametrize("fleet", [1, 2])
def test_rows_match_the_jax_package(fleet, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    x0 = np.random.default_rng(6).normal(size=(1, 3, 16, 16)).astype(np.float32)
    align_packages(monkeypatch, x0)
    overrides = BASE + ["dryrun=True", "num_trials=2", f"fleet={fleet}"]
    j_calls, calls = _spy(monkeypatch, jax_breaching), _spy(monkeypatch, breaching)
    want = jax_benchmark.main_process(0, 1, jax_breaching.get_config(overrides))
    outputs = {}
    got = benchmark_breaches.main_process(breaching.get_config(overrides), device="cpu", outputs=outputs)

    assert outputs["failures"] == []
    assert len(calls) == len(j_calls) == fleet  # a dry run stops after its first wave
    assert [r[0] for r in outputs["reports"]] == list(range(fleet))
    for (metrics, stats, table), (j_metrics, j_stats, j_table) in zip(calls, j_calls):
        assert table == j_table == "benchmark"
        assert list(metrics) == list(j_metrics)
        assert {"cw_ssim", "gabor_cw_ssim", "rpsnr", "IIP-pixel", "IIP-self"} <= set(metrics)
        for key, value in metrics.items():
            if key in ("IIP-pixel", "IIP-self", "label_acc", "parameters", "order", "lpips"):
                assert value == j_metrics[key] or (np.isnan(value) and np.isnan(j_metrics[key])), key
            else:
                assert _metric_close(key, value, j_metrics[key]), (key, value, j_metrics[key])
        trials = sorted(k for k in stats if k.startswith("Trial_"))
        assert trials == sorted(k for k in j_stats if k.startswith("Trial_")) == ["Trial_0_Val"]
        np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-3)
    if fleet == 2:  # each user's trial is its own column of the wave's stats
        assert calls[0][1]["Trial_0_Val"] != calls[1][1]["Trial_0_Val"]
    assert list(got) == list(want)
    assert {"spent_time", "user_idx", "psnr", "rpsnr", "IIP-pixel"} <= set(got)
    assert got["user_idx"] == want["user_idx"] == (fleet - 1) / 2
    for key in got:
        if key != "spent_time":
            assert _metric_close(key, got[key], want[key]) or got[key] == want[key], key


def _table(path):
    with open(path) as fh:
        return list(csv.reader(fh, delimiter="\t"))


RUN = BASE + ["attack.optim.max_iterations=2", "num_trials=3", "fleet=2", "save_reconstruction=True"]


def test_records_of_a_run(tmp_path, monkeypatch):
    """Two waves (users 0-1, then 2): a row per user, one averaged row, the images of each
    user under their own names."""
    monkeypatch.chdir(tmp_path)
    cfg = breaching.get_config(RUN + [f"base_dir={tmp_path}/run"])
    outputs = {}
    average = benchmark_breaches.main_process(cfg, device="cpu", outputs=outputs)
    rows = _table(tmp_path / "run" / "tables" / "table_benchmark_single_image_small.csv")
    assert len(rows) == 4 and "rpsnr" in rows[0] and "IIP-pixel" in rows[0]
    bench = _table(tmp_path / "outputs" / "tables" / "BENCHMARK_breach_single_image_small_invertinggradients.csv")
    assert len(bench) == 2 and bench[0] == list(average)
    assert average["user_idx"] == 1.0
    assert [r[0] for r in outputs["reports"]] == [0, 1, 2] and outputs["failures"] == []
    for user in range(3):
        image = np.asarray(Image.open(tmp_path / "run" / "reconstructions" / f"bench_user{user}_rec_0.png"))
        assert image.shape == (16, 16, 3)


def test_a_failed_report_is_logged_and_skipped(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    real = breaching.analysis.report
    seen = []

    def report(reconstruction, *args, **kwargs):
        seen.append(1)
        if len(seen) == 2:
            raise RuntimeError("report of the second user")
        return real(reconstruction, *args, **kwargs)

    monkeypatch.setattr(breaching.analysis, "report", report)
    outputs = {}
    average = benchmark_breaches.main_process(breaching.get_config(RUN + [f"base_dir={tmp_path}"]), device="cpu",
                                              outputs=outputs)
    assert [r[0] for r in outputs["reports"]] == [0, 2]
    assert [(users, str(e)) for users, e in outputs["failures"]] == [([1], "report of the second user")]
    assert average["user_idx"] == 1.0
    assert not os.path.exists(tmp_path / "reconstructions" / "bench_user1_rec_0.png")


def test_an_interrupt_averages_the_users_done(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    real = breaching.analysis.report
    seen = []

    def report(reconstruction, *args, **kwargs):
        seen.append(1)
        if len(seen) == 2:
            raise KeyboardInterrupt
        return real(reconstruction, *args, **kwargs)

    monkeypatch.setattr(breaching.analysis, "report", report)
    outputs = {}
    average = benchmark_breaches.main_process(breaching.get_config(RUN + [f"base_dir={tmp_path}"]), device="cpu",
                                              outputs=outputs)
    assert [r[0] for r in outputs["reports"]] == [0] and len(seen) == 2
    assert average["user_idx"] == 0.0
