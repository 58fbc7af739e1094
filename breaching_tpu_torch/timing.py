"""Kernel times on the card, and the launch paths of checkouts of the port compared.

``time_ms`` is how ``chip_smoke.py`` times every kernel. Run as a script,

    python3 -m breaching_tpu_torch.timing ROOT [ROOT ...]

it times, for the port found under each ROOT in the order given, the wrappers of
the standalone kernels B2 (``ops.axpby``) and B4 (``ops.box_project``) beside their
library calls, at the slice's shapes (ConvNet-64's 2,904,970 parameters, one
3x32x32 image), and prints one JSON line per ROOT. Give a checkout of the parent
commit and this one as parent, change, change, parent to compare two launch paths
on one card. Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys
import time

import torch


def time_ms(fn, iters=200, warmup=20):
    """Time per call of ``fn`` on the card, in ms: (200 calls enqueued back to back
    between two events; the same 200 calls captured in a CUDA graph and replayed
    between two events, which is device time alone; host time to enqueue one call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    per_call = start.elapsed_time(end) / iters

    begin = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - begin) * 1e3 / iters
    torch.cuda.synchronize()

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return per_call, start.elapsed_time(end) / iters, host


def _time_standalone(root: str) -> dict:
    """B2 and B4 of the port under ``root``, and their library calls, at the slice's shapes."""
    for name in [m for m in sys.modules if m.split(".")[0] == "breaching_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from breaching_tpu_torch import ops
    finally:
        sys.path.remove(root)
    gen = torch.Generator().manual_seed(99)
    r, d = (torch.randn(2_904_970, generator=gen).cuda() for _ in range(2))
    a, b = torch.tensor([-0.7], device="cuda"), torch.tensor([1.3], device="cuda")
    ar = a * r
    x = torch.randn(1, 3, 32, 32, generator=gen).cuda()
    lo, hi = torch.tensor([-1.9, -2.0, -1.7], device="cuda"), torch.tensor([2.1, 2.1, 2.0], device="cuda")
    lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
    calls = {"b2_axpby": lambda: ops.axpby(a, r, b, d), "torch.add(alpha=)": lambda: torch.add(ar, d, alpha=1.3),
             "b4_box_project": lambda: ops.box_project(x, lo, hi), "torch.clamp": lambda: torch.clamp(x, lo4, hi4)}
    return {name: dict(zip(("ms", "device_ms", "host_ms"), time_ms(fn))) for name, fn in calls.items()}


def main(roots):
    if not torch.cuda.is_available():
        raise SystemExit("breaching_tpu_torch.timing needs a CUDA device.")
    for root in roots:
        print(json.dumps(dict(root=root, device=torch.cuda.get_device_name(0), **_time_standalone(root))),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
