"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files go through ONE ``nvcc`` call into a plain-C shared
library, loaded with ``ctypes``; no source includes PyTorch's headers, so the
build takes seconds and needs neither ``ninja`` nor PyTorch's extension builder.
The library lands in ``breaching_tpu_torch/_build/`` under a name keyed by a
hash of the sources and flags, and is built at first use. Paths are resolved
from this file, so the build works from any working directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_ROOT, "csrc")
BUILD_DIR = os.path.join(PACKAGE_ROOT, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# C signature of every exported kernel entry point; each returns its cudaError_t.
SIGNATURES = {
    "b1_matching_sums": [_P, _P, _I64, _P, _I32, _P, _P],
    "b2_axpby": [_P, _P, _P, _P, _P, _I64, _P],
    "b2_cosine_backward": [_P, _P, _P, _P, _P, _I64, _I32, _P],
    "b3_tv_forward": [_P, _I64, _I32, _I32, _F32, _F32, _F32, _P, _I32, _P, _P],
    "b3_tv_value_and_grad": [_P, _P, _I64, _I32, _I32, _F32, _F32, _F32, _P, _P, _P, _P],
    "b4_box_project": [_P, _P, _P, _P, _I64, _I64, _I32, _P],
    "b4_adam_box_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32,
                         _F32, _F32, _F32, _F32, _F32, _F32, _F32, _F32, _I32, _P],
}

_library = None
build_seconds = None  # wall time of the nvcc call that built the loaded library, None if cached


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def find_nvcc() -> str:
    """nvcc from torch's CUDA_HOME, then $CUDA_HOME, then /usr/local/cuda."""
    from torch.utils.cpp_extension import CUDA_HOME

    tried = []
    for home in (CUDA_HOME, os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            path = os.path.join(home, "bin", "nvcc")
            tried.append(path)
            if os.access(path, os.X_OK):
                return path
    raise RuntimeError(f"nvcc not found; tried {tried}.")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"libbreaching_kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for the current sources exists."""
    global build_seconds
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, partial = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", partial,
           *[p for p in sources() if p.endswith(".cu")]]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(partial)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    build_seconds = time.perf_counter() - start
    os.replace(partial, target)
    return target


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with argtypes set."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {status}.")


def launch_stream(name: str, *tensors) -> int | None:
    """Where a wrapper's work runs. The raw handle of the current CUDA stream if every
    tensor is a contiguous float32 tensor on one CUDA device (the kernel runs there);
    None if every tensor lies on the CPU (the plain version runs). Raises for anything
    else: a CUDA tensor never falls back to the plain version.

    The common case, the kernel's, is decided in one pass over the tensors' devices,
    dtypes and contiguity, and the stream handle is read without building a
    ``torch.cuda.Stream``: at the slice's sizes this host work is the call's cost."""
    device = tensors[0].device
    if device.type == "cuda":
        for t in tensors:
            if t.device != device or t.dtype is not torch.float32 or not t.is_contiguous():
                break
        else:
            return torch._C._cuda_getCurrentRawStream(device.index)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return None
    if len(devices) != 1 or device.type != "cuda":
        raise ValueError(f"{name}: tensors must all lie on the CPU or on one CUDA device, got {devices}.")
    raise ValueError(f"{name}: the kernel takes contiguous float32 tensors, got "
                     f"{[(t.dtype, t.stride()) for t in tensors]}.")


def reduce_blocks(n: int) -> int:
    """Blocks of a two-pass reduction over n elements (at least 16 per thread, at most
    1024 blocks, as csrc/reduce.cuh allows)."""
    return max(1, min(1024, -(-n // (256 * 16))))
