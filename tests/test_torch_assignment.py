"""The port's capacitated assignment solver (``breaching_tpu_torch/native.py``, built from
its own copy of the C++ source) against the JAX package's and against the exact
replicated assignment (``linear_sum_assignment`` on the cost matrix with each cluster's
column repeated cap times), over the JAX package's test grid
(tests/test_native_assignment.py): the JAX solver's labels, or, where the optimum ties,
an equal optimum cost to 1e-9; infeasible capacities raise; a failed build raises and
never falls back."""

import os

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from breaching_tpu import native as jax_native
from breaching_tpu_torch import native


def _replicated_cost(cost, caps):
    replicated = np.repeat(cost, caps, axis=1)
    rows, cols = linear_sum_assignment(replicated)
    return replicated[rows, cols].sum()


def _check(cost, caps):
    labels = native.capacitated_assignment(cost, caps)
    n, k = cost.shape
    caps = np.broadcast_to(np.asarray(caps, np.int64), (k,))
    assert labels.shape == (n,) and labels.dtype == np.int64
    assert (np.bincount(labels, minlength=k) <= caps).all()
    ours = cost[np.arange(n), labels].sum()
    assert ours == pytest.approx(_replicated_cost(cost, caps), abs=1e-9)
    want = jax_native.capacitated_assignment(cost, caps)
    if not np.array_equal(labels, want):  # a tie between optima
        assert ours == pytest.approx(cost[np.arange(n), want].sum(), abs=1e-9)
    return labels


@pytest.mark.parametrize("n,k,seed", [(12, 3, 0), (40, 5, 1), (64, 8, 2), (100, 4, 3), (33, 7, 4)])
def test_matches_jax_and_the_replicated_optimum(n, k, seed):
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(n, k))
    cap = int(np.ceil(n / k)) + rng.integers(0, 3)
    _check(cost, np.full(k, cap, np.int64))


def test_uneven_and_tight_capacities():
    rng = np.random.default_rng(7)
    _check(rng.normal(size=(30, 4)), np.asarray([3, 10, 2, 15], np.int64))
    labels = _check(rng.normal(size=(24, 3)), 8)  # one capacity for every cluster
    assert (np.bincount(labels, minlength=3) == 8).all()


def test_ties_reach_the_optimum():
    """Integer costs with many equal optima (k-means' distances at a symmetric start)."""
    rng = np.random.default_rng(5)
    _check(rng.integers(0, 3, size=(48, 6)).astype(np.float64), 8)


def test_infeasible_capacities_raise():
    with pytest.raises(ValueError, match="infeasible"):
        native.capacitated_assignment(np.zeros((10, 2)), 4)


def test_library_is_keyed_by_the_source(monkeypatch, tmp_path):
    assert os.path.dirname(native.library_path()) == native.BUILD_DIR
    other = tmp_path / "capacitated_assignment.cc"
    other.write_text(open(native.SOURCE).read() + "\n// another revision\n")
    first = native.library_path()
    monkeypatch.setattr(native, "SOURCE", str(other))
    assert native.library_path() != first


def test_library_is_keyed_by_the_compiler(monkeypatch):
    """A library built by another g++ (another machine's) is never loaded."""
    first = native.library_path()
    monkeypatch.setattr(native, "compiler_version", lambda: "g++ (another build) 0.0")
    assert native.library_path() != first


def test_failed_build_raises_and_does_not_fall_back(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.capacitated_assignment(np.zeros((4, 2)), 2)
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
