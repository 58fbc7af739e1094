"""The host's C++ solver for Decepticon's sentence clustering (counterpart of
``breaching_tpu/native``): ``capacitated_assignment``, an exact min-cost assignment of n
rows to k clusters of bounded size (``csrc/host/capacitated_assignment.cc``).

The source is compiled at first use with the host's ``g++`` into
``breaching_tpu_torch/_build/`` under a name keyed by a hash of the source, the flags and
``g++ --version`` (through ``ops/_build.py``'s ``keyed_library`` and ``compile_once``, as
the kernels are built), and loaded through its C interface with ``ctypes``. Where the build or the load fails,
the solver raises: it never falls back to another method. ``capacitated_assignment.seconds``
adds up the time spent in the solver (its build and load excluded), for the profiles of
slice 13.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import time

import numpy as np

from .ops._build import compile_once, keyed_library

PACKAGE_ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(PACKAGE_ROOT, "csrc", "host", "capacitated_assignment.cc")
BUILD_DIR = os.path.join(PACKAGE_ROOT, "_build")
FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]

_lib = None


@functools.cache
def compiler_version() -> str:
    """``g++ --version``'s first line. Raises RuntimeError where ``g++`` cannot run."""
    try:
        proc = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        raise RuntimeError(f"The assignment solver's compiler g++ cannot run: {err}") from err
    return proc.stdout.splitlines()[0] if proc.stdout else ""


def library_path() -> str:
    return keyed_library(BUILD_DIR, "capacitated_assignment", [*FLAGS, compiler_version()], [SOURCE])


def build() -> str:
    """Compile the solver unless a library for the current source and compiler exists.
    Raises RuntimeError when ``g++`` fails or is missing."""
    target = library_path()
    compile_once(target, lambda partial: ["g++", *FLAGS, "-o", partial, SOURCE], timeout=300)
    return target


def load():
    """The solver's library, built and loaded on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.capacitated_assignment.restype = ctypes.c_int
        lib.capacitated_assignment.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        _lib = lib
    return _lib


def capacitated_assignment(cost, caps) -> np.ndarray:
    """Labels (n,) int64 assigning each row of the (n, k) ``cost`` to one of k clusters at
    the least total cost, cluster c taking at most ``caps[c]`` rows (an int for all): the
    exact min-cost-flow optimum. Raises ValueError where the capacities hold fewer than n
    rows."""
    lib = load()
    start = time.perf_counter()
    cost = np.ascontiguousarray(cost, np.float64)
    n, k = cost.shape
    caps = np.ascontiguousarray(np.broadcast_to(np.asarray(caps, np.int64), (k,)))
    if caps.sum() < n:
        raise ValueError(f"infeasible: sum of capacities {caps.sum()} < {n} rows")
    out = np.empty(n, np.int64)
    if lib.capacitated_assignment(cost, n, k, caps, out) != 0:
        raise ValueError("infeasible capacitated assignment")
    capacitated_assignment.seconds += time.perf_counter() - start
    return out


capacitated_assignment.seconds = 0.0
