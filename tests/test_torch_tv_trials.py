"""Total variation of T trials at once (``ops.tv_value_and_grad_trials``, through its
plain per-trial form on the CPU, and the TV regularizer's ``trials``) against the JAX
package's TV regularizer vmapped over the trials; and the kernels' build and load: the
library's name follows the torch version and every source, and the CPU wrappers never
load it. The kernel's trials form is held against the plain one in
tests/test_torch_kernels.py.

Inputs come from numpy seeds and reach both sides as the same float32 arrays.
Tolerances, as tests/test_torch_tv.py states them: each trial's value, a mean of n
terms summed in two orders, 1e-5 relative; the gradient, where sqrt and pow(., -0.5)
come from two libraries, 1e-6 of the largest |value|.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.regularizers import TotalVariation as JaxTotalVariation
from breaching_tpu_torch import ops
from breaching_tpu_torch.attacks.auxiliaries.regularizers import TotalVariation
from breaching_tpu_torch.ops import _build, image, matching

torch.set_num_threads(1)
TRIALS = (3, 1, 3, 16, 16)  # T trials of 1x3x16x16
EXPONENTS = [(1.0, 1.0), (2.0, 0.5)]


def _stack(seed):
    return np.random.default_rng(seed).normal(size=TRIALS).astype(np.float32)


def _jax_trials(x, p, q, double_opponents):
    """The JAX regularizer's value and gradient of each trial, vmapped, in NCHW."""
    reg = JaxTotalVariation(scale=0.2, inner_exp=p, outer_exp=q, double_opponents=double_opponents)
    values, grads = jax.vmap(jax.value_and_grad(reg))(jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2))))
    return np.asarray(values), np.transpose(np.asarray(grads), (0, 1, 4, 2, 3))


def _opponents(x):
    """The double-opponent channels the port's TotalVariation appends (dim -3)."""
    c0, c1, c2 = x[..., 0:1, :, :], x[..., 1:2, :, :], x[..., 2:3, :, :]
    return torch.cat([x, c0 - c1, c0 - c2, c1 - c2], dim=-3)


def _assert_values(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _assert_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("p,q", EXPONENTS)
@pytest.mark.parametrize("double_opponents", [False, True])
def test_tv_value_and_grad_trials_plain_matches_jax_vmap(p, q, double_opponents):
    x = _stack(30)
    want_values, want_grads = _jax_trials(x, p, q, double_opponents)
    xt = torch.from_numpy(x).requires_grad_(double_opponents)
    z = _opponents(xt) if double_opponents else xt
    values, grad = image.tv_value_and_grad_trials_plain(z.detach(), torch.tensor([0.2]), p, q, 1e-8)
    assert values.shape == (TRIALS[0],) and grad.shape == z.shape
    if double_opponents:  # the gradient with respect to the opponent channels, pulled back to x
        grad, = torch.autograd.grad(z, xt, grad)
    _assert_values(values, want_values)
    _assert_grad(grad, want_grads)


@pytest.mark.parametrize("p,q", EXPONENTS)
@pytest.mark.parametrize("double_opponents", [False, True])
def test_total_variation_regularizer_trials_matches_jax_vmap(p, q, double_opponents):
    x = _stack(31)
    want_values, want_grads = _jax_trials(x, p, q, double_opponents)
    xt = torch.from_numpy(x).requires_grad_(True)
    values = TotalVariation(scale=0.2, inner_exp=p, outer_exp=q, double_opponents=double_opponents).trials(xt)
    grad, = torch.autograd.grad(values.sum(), xt)
    assert values.shape == (TRIALS[0],)
    _assert_values(values.detach(), want_values)
    _assert_grad(grad, want_grads)


def test_tv_value_and_grad_trials_is_each_trial_on_its_own():
    # the trials form is the single form applied to each trial, bit for bit
    x, scale = torch.from_numpy(_stack(32)), torch.tensor([0.2])
    values, grad = ops.tv_value_and_grad_trials(x, scale, 2.0, 0.5)
    for t in range(TRIALS[0]):
        value, want = ops.tv_value_and_grad(x[t], scale, 2.0, 0.5)
        assert torch.equal(values[t], value) and torch.equal(grad[t], want)


def test_tv_value_and_grad_trials_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):  # not a stack of trials
        ops.tv_value_and_grad_trials(torch.zeros(1, 3, 4, 4), torch.ones(1))
    with pytest.raises(ValueError):  # not contiguous
        ops.tv_value_and_grad_trials(torch.zeros(2, 1, 3, 4, 4).transpose(3, 4), torch.ones(1))
    with pytest.raises(ValueError):  # neither the CPU nor a CUDA device: no plain fallback
        ops.tv_value_and_grad_trials(torch.zeros(2, 1, 3, 4, 4, device="meta"), torch.ones(1, device="meta"))


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of the kernels' sources that ``_build`` reads in their place."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_library_path_follows_the_torch_version(csrc_copy, monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(torch, "__version__", torch.__version__ + "+other")
    assert _build.library_path() != before


def test_library_path_follows_the_binding_source(csrc_copy):
    before = _build.library_path()
    assert "bindings.cpp" in map(os.path.basename, _build.sources())
    with open(csrc_copy / "bindings.cpp", "a") as fh:
        fh.write("\n// changed\n")
    assert _build.library_path() != before


def test_library_path_follows_the_cxx11_abi(csrc_copy, monkeypatch):
    before = _build.library_path()
    monkeypatch.setattr(torch._C, "_GLIBCXX_USE_CXX11_ABI", not torch._C._GLIBCXX_USE_CXX11_ABI)
    assert _build.library_path() != before


def _cpu_calls():
    """Every wrapper's CPU path, with small inputs."""
    rng = np.random.default_rng(33)
    vec = [torch.from_numpy(rng.normal(size=64).astype(np.float32)) for _ in range(2)]
    img = torch.from_numpy(rng.normal(size=(1, 3, 8, 8)).astype(np.float32))
    stack = torch.from_numpy(rng.normal(size=(2, 1, 3, 8, 8)).astype(np.float32))
    one, lo, hi = torch.tensor([0.2]), -torch.ones(3), torch.ones(3)
    leaf = img.clone().requires_grad_(True)
    leaves = stack.clone().requires_grad_(True)
    rec = vec[0].clone().requires_grad_(True)
    step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
    return {
        "axpby": lambda: ops.axpby(one, vec[0], -one, vec[1]),
        "matching_sums": lambda: ops.matching_sums(*vec),
        "tv_forward": lambda: ops.tv_forward(img),
        "tv_value_and_grad": lambda: ops.tv_value_and_grad(img, one),
        "tv_value_and_grad_trials": lambda: ops.tv_value_and_grad_trials(stack, one),
        "total_variation": lambda: torch.autograd.grad(ops.total_variation(leaf, scale=one), leaf),
        "total_variation_trials": lambda: torch.autograd.grad(
            ops.total_variation_trials(leaves, scale=one).sum(), leaves),
        "fused_euclidean": lambda: torch.autograd.grad(ops.fused_euclidean(rec, vec[1]), rec),
        "fused_cosine_similarity": lambda: torch.autograd.grad(ops.fused_cosine_similarity(rec, vec[1]), rec),
        "box_project": lambda: ops.box_project(img, lo, hi),
        "cosine_backward": lambda: matching.cosine_backward(ops.matching_sums(*vec), one, *vec),
        "matching_sums into a row": lambda: ops.matching_sums(*vec, out=torch.empty(2, 3)[1]),
        "box_project in place": lambda: ops.box_project(img.clone(), lo, hi, out=img.clone()),
        "cosine_backward of rows": lambda: matching.cosine_backward(
            torch.stack([ops.matching_sums(*vec)] * 2), torch.tensor([0.2, 0.3]), *(torch.stack([v] * 2) for v in vec)),
        "fused_cosine_similarity_trials": lambda: torch.autograd.grad(
            ops.fused_cosine_similarity_trials(torch.stack([rec] * 2), torch.stack(vec)).sum(), rec),
        "adam_box_step": lambda: ops.adam_box_step(
            img.clone(), img.clone(), img * 0, img * 0, img.clone(), lo, hi, one[0], one[0] + 1, torch.empty(()),
            step),
        "adam_box_step_trials": lambda: ops.adam_box_step_trials(
            stack.clone(), stack.clone(), stack * 0, stack * 0, stack.clone(), lo, hi, torch.ones(2),
            torch.full((2,), 2.0), torch.empty(2), step),
    }


@pytest.mark.parametrize("name", list(_cpu_calls()))
def test_cpu_wrappers_never_load_the_library(name, monkeypatch):
    def refuse():
        raise AssertionError("a CPU wrapper loaded the kernels' library")

    for loader in ("build", "load_ops", "op"):
        monkeypatch.setattr(_build, loader, refuse)
    monkeypatch.setattr(torch.ops, "load_library", lambda path: refuse())
    _cpu_calls()[name]()


FAKE_NVCC = """#!/usr/bin/env python3
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as fh:
    fh.write(f"start {'link' if '-shared' in args else os.path.basename(args[args.index('-c') + 1])} {time.time()}\\n")
if "-c" in args and os.path.basename(args[args.index("-c") + 1]) == os.environ.get("FAKE_NVCC_FAIL"):
    sys.exit("error: refused")
time.sleep(0.5)
if "-shared" in args:
    missing = [a for a in args if a.endswith(".o") and not os.path.exists(a)]
    assert not missing, missing
with open(out, "w") as fh:
    fh.write("built")
with open(log, "a") as fh:
    fh.write(f"end {time.time()}\\n")
"""


@pytest.mark.parametrize("fail", [None, "bindings.cpp"], ids=["builds", "a-source-fails"])
def test_build_starts_one_nvcc_per_source_at_once_then_links(csrc_copy, tmp_path, monkeypatch, fail):
    """``build`` compiles each ``.cu`` file and ``bindings.cpp`` with its own ``nvcc -c``, all
    started before any ends, links the objects into the keyed library, and raises (leaving no
    library) when a source does not compile, after every ``nvcc`` has ended."""
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC)
    fake.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", fail)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    compiled = sorted(os.path.basename(p) for p in _build.sources() if p.endswith((".cu", ".cpp")))
    if fail:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.build()
        assert not os.path.exists(_build.library_path())
        return
    target = _build.build()
    assert target == _build.library_path() and open(target).read() == "built"
    lines = [line.split() for line in log.read_text().splitlines()]
    starts = [line[1] for line in lines if line[0] == "start"]
    assert sorted(starts[:-1]) == compiled and starts[-1] == "link"
    first_end = min(float(line[1]) for line in lines if line[0] == "end")
    assert all(float(line[2]) < first_end for line in lines if line[0] == "start" and line[1] != "link")
    assert _build.build() == target  # built once: the library is reused
