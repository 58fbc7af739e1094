"""Kernel times on the card, and the launch paths of checkouts of the port compared.

``time_ms`` is how ``chip_smoke.py`` times every kernel. Run as a script,

    python3 -m breaching_tpu_torch.timing ROOT [ROOT ...]

it times, for the port found under each ROOT in the order given, the wrappers of the
standalone kernels B2 (``ops.axpby``) and B4 (``ops.box_project``, and its in-place
form where the tree has it) beside their library calls, at the slice's shapes
(ConvNet-64's 2,904,970 parameters, one 3x32x32 image); TV at 1x3x32x32,
1x3x224x224, 4x3x224x224 and 100x3x32x32: the forward and backward wrappers called
in turn (``ops.tv_forward`` then ``ops.tv_backward``), the fused
``ops.tv_value_and_grad`` where the tree has it, and the attack's TV regularizer
(scale 0.2) with its gradient through autograd, which is what one attack step spends
on TV; and the regularizer's trials form on the fleet's 8x1x3x224x224 stack. It
prints one JSON line per ROOT. Give a
checkout of the parent commit and this one as parent, change, change, parent to
compare two launch paths on one card. Needs a CUDA device.
"""

from __future__ import annotations

import inspect
import json
import sys
import time

import torch


# Twice the H100's 50 MB L2: reading this much between two calls leaves none of the
# first call's operands in the cache.
FLUSH_BYTES = 100 * 2**20


def _graph_ms(calls, iters):
    """Device time of ``iters`` rounds of ``calls`` captured in one CUDA graph and
    replayed between two events, in ms per round."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            for call in calls:
                call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters=200, warmup=20):
    """Time per call of ``fn`` on the card, in ms: (``iters`` calls enqueued back to back
    between two events; device time of one call with its operands cold; host time to
    enqueue one call; device time of one call with its operands warm in L2).

    Device times come from CUDA graph replays, which leave out the host. Warm: the
    calls back to back, each finding the last one's operands in L2 where they fit.
    Cold: each call after a read of ``FLUSH_BYTES`` that evicts them, as in the attack
    step, where a double backward through the model runs between two calls; the time
    of the reads alone, replayed the same way, is subtracted."""
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

    warm = _graph_ms([fn], iters)
    scratch = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")

    def flush():
        torch.sum(scratch, dim=0, out=sink)

    cold = _graph_ms([flush, fn], iters) - _graph_ms([flush], iters)
    return per_call, cold, host, warm


def _time_standalone(root: str) -> dict:
    """B2, B3 and B4 of the port under ``root``, and the library calls of B2 and B4."""
    for name in [m for m in sys.modules if m.split(".")[0] == "breaching_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        from breaching_tpu_torch import ops
        from breaching_tpu_torch.attacks.auxiliaries.regularizers import TotalVariation
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
    if "out" in inspect.signature(ops.box_project).parameters:  # the in-place form, where the tree has it
        xi = x.clone()
        calls["b4_box_project in place"] = lambda: ops.box_project(xi, lo, hi, out=xi)
        calls["torch.clamp(out=)"] = lambda: torch.clamp(xi, lo4, hi4, out=xi)
    g = torch.tensor([0.2], device="cuda")
    reg = TotalVariation(scale=0.2)
    for shape in ((1, 3, 32, 32), (1, 3, 224, 224), (4, 3, 224, 224), (100, 3, 32, 32)):
        img = torch.randn(*shape, generator=gen).cuda()
        leaf = img.clone().requires_grad_(True)
        at = "x".join(map(str, shape))
        calls[f"tv_forward + tv_backward {at}"] = lambda img=img: (ops.tv_forward(img), ops.tv_backward(img, g))
        if hasattr(ops, "tv_value_and_grad"):
            calls[f"b3_tv_value_and_grad {at}"] = lambda img=img: ops.tv_value_and_grad(img, g)
        calls[f"TV regularizer value and gradient {at}"] = lambda leaf=leaf: torch.autograd.grad(reg(leaf), leaf)
    # the fleet's step: TV of 8 trials stacked, through the regularizer's trials form
    stack = torch.randn(8, 1, 3, 224, 224, generator=gen).cuda().requires_grad_(True)
    calls["TV regularizer trials value and gradient 8x1x3x224x224"] = \
        lambda: torch.autograd.grad(reg.trials(stack).sum(), stack)
    return {name: dict(zip(("ms", "device_ms", "host_ms", "device_warm_ms"), time_ms(fn)))
            for name, fn in calls.items()}


def main(roots):
    if not torch.cuda.is_available():
        raise SystemExit("breaching_tpu_torch.timing needs a CUDA device.")
    for root in roots:
        print(json.dumps(dict(root=root, device=torch.cuda.get_device_name(0), **_time_standalone(root))),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
