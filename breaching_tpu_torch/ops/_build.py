"""Build and load the port's CUDA kernels.

Each of ``csrc/*.cu`` and ``csrc/bindings.cpp`` is compiled by its own ``nvcc``, all started
together, and one more ``nvcc`` links them into one shared library. ``bindings.cpp`` registers every kernel with PyTorch's dispatcher as
an op of ``torch.ops.breaching`` (loaded with ``torch.ops.load_library``,
``load_ops``; ``op`` gives one op's callable). ``bindings.cpp`` is the only source that
includes PyTorch's headers: it is compiled against the include and library paths of
the torch that runs, with its C++ ABI flag, and without ``ninja`` or PyTorch's
extension builder. The library lands in
``breaching_tpu_torch/_build/`` under a name keyed by a hash of the sources, the
flags and the torch version, and is built at first use. Paths are resolved from this
file, so the build works from any working directory. ``keyed_library`` and
``compile_once`` name and build a library so; the host's assignment solver
(``native.py``) builds through them too.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_ROOT, "csrc")
BUILD_DIR = os.path.join(PACKAGE_ROOT, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++20", "-O3", "-Xcompiler", "-fPIC"]
TORCH_LIBRARIES = ["c10", "c10_cuda", "torch_cpu", "torch_cuda"]

_ops = None
_op_callables = {}  # name -> the op's callable, bound at its first call
build_seconds = None  # wall time of the nvcc calls that built the loaded library, None if cached


def sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh", ".cpp")))


def flags() -> list[str]:
    """nvcc's flags: NVCC_FLAGS and the C++ ABI of the torch that runs, which
    ``bindings.cpp`` must share to link against it."""
    return [*NVCC_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]


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


def keyed_library(build_dir: str, stem: str, key: list[str], inputs: list[str]) -> str:
    """``<build_dir>/lib<stem>_<hash>.so``, the hash over ``key`` and the names and contents of
    the ``inputs`` files."""
    digest = hashlib.sha256(" ".join(key).encode())
    for path in inputs:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def compile_once(target: str, command, timeout=None):
    """Builds ``target`` unless it exists: ``command(path)`` is the compiler's argument list
    writing to ``path``, a temporary file in the target's directory that is renamed once
    the build succeeded, so that concurrent builders never load half a library. Returns the
    build's seconds, None where the library existed. Raises RuntimeError where the compiler
    fails or cannot run."""
    if os.path.exists(target):
        return None
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, partial = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(target))
    os.close(fd)
    cmd = command(partial)
    name = os.path.basename(cmd[0])
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as err:
        os.unlink(partial)
        raise RuntimeError(f"{name} could not run ({' '.join(cmd)}): {err}") from err
    if proc.returncode != 0:
        os.unlink(partial)
        raise RuntimeError(f"{name} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    seconds = time.perf_counter() - start
    os.replace(partial, target)
    return seconds


def library_path() -> str:
    return keyed_library(BUILD_DIR, "breaching_kernels", [*flags(), torch.__version__], sources())


def build() -> str:
    """Compile the kernels unless a library for the current sources exists: one ``nvcc -c``
    for each source, run at once (``bindings.cpp``, which includes PyTorch's headers, takes
    most of the time), then the link."""
    global build_seconds
    target = library_path()
    if os.path.exists(target):
        return target
    from torch.utils.cpp_extension import include_paths, library_paths

    nvcc, lib_dirs = find_nvcc(), library_paths()
    os.makedirs(BUILD_DIR, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in sources() if p.endswith((".cu", ".cpp"))):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *flags(), *[f"-I{p}" for p in include_paths()], "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = [proc.communicate()[1] for _, _, proc in jobs]  # waits for every nvcc
        for (cmd, _, proc), err in zip(jobs, errors):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")

        def link(partial):
            return [nvcc, *flags(), "-shared", "-o", partial, *[obj for _, obj, _ in jobs],
                    *[f"-L{p}" for p in lib_dirs],
                    *[arg for p in lib_dirs for arg in ("-Xlinker", "-rpath", "-Xlinker", p)],
                    *[f"-l{name}" for name in TORCH_LIBRARIES]]

        if compile_once(target, link) is not None:
            build_seconds = time.perf_counter() - start
    return target


def load_ops():
    """``torch.ops.breaching``, the dispatcher's ops of the kernels' shared library,
    built and loaded on first use. Raises if the build or the load fails."""
    global _ops
    if _ops is None:
        torch.ops.load_library(build())
        _ops = torch.ops.breaching
    return _ops


def op(name: str):
    """The callable of ``torch.ops.breaching.<name>.default``, the op's one overload:
    called directly, it skips ``OpOverload.__call__``'s Python frame (about 1.3 us of a
    7-argument call's 5 on a CPU core). Bound once per name, at the first call."""
    fn = _op_callables.get(name)
    if fn is None:
        fn = _op_callables[name] = getattr(load_ops(), name).default._op
    return fn


_TYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16", torch.float16: "f16"}


def count_launch(wrapper, *tensors) -> None:
    """One launch of ``wrapper``'s kernel: its ``launches`` count, and its count by the
    element types of ``tensors`` in ``launches_by_type`` (e.g. "bf16-f32"), the form
    of the kernel that ran."""
    wrapper.launches += 1
    key = "-".join(_TYPE_NAMES.get(t.dtype, str(t.dtype)) for t in tensors)
    wrapper.launches_by_type[key] = wrapper.launches_by_type.get(key, 0) + 1


def require_cpu(name: str, *tensors) -> None:
    """The plain version's guard: raises unless every tensor lies on the CPU (every
    wrapper sends CUDA tensors to its dispatcher op before this)."""
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"{name}: tensors must all lie on the CPU or on one CUDA device, got "
                             f"{[str(t.device) for t in tensors]}.")
