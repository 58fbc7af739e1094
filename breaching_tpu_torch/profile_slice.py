"""Where the time of the slice's attack step goes, on the card.

    python3 -m breaching_tpu_torch.profile_slice [--iterations N]

Runs Inverting Gradients with the fused cosine objective on ConvNet-64 / CIFAR-10
shapes through the entry points: one warm-up attack, an attack of N steps
(default 200) timed with the profiler off, and the same attack under
``torch.profiler``. Prints one JSON line: milliseconds per step with the
profiler off and on (wall clock around the synchronised attack; the difference
is the profiler's cost), device-busy milliseconds per step (the sum of the
kernels' device times; one stream, so they do not overlap), the idle share of
the unprofiled step, kernel launches per step, device time per step of the
kernels that take most of it, and device time and launches per step of each of
the port's own kernels (``csrc/``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

import breaching_tpu_torch as breaching

SLICE = ["case=1_single_image_small", "attack=invertinggradients",
         "attack.objective.type=fused-cosine-similarity", "attack.optim.callback=0", "seed=0"]


def _attack(iterations):
    cfg = breaching.get_config(SLICE + [f"attack.optim.max_iterations={iterations}"])
    setup = breaching.utils.system_startup(cfg=cfg)
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared_data, payloads, _ = server.run_protocol(user)
    return lambda: attacker.reconstruct(payloads, shared_data, server.secrets)


def _timed(run) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iterations", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device.")

    _attack(50)()  # warm-up: kernel build, cuDNN heuristics, allocator
    steps = args.iterations
    run = _attack(steps)
    wall_ms = _timed(run)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = _timed(run)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    # the port's kernels by name, without the return type that templates carry
    port = {e.key.removeprefix("void ").split("(")[0]: e for e in kernels if "breaching::" in e.key}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), iterations=steps,
        ms_per_step=wall_ms / steps, profiled_ms_per_step=profiled_ms / steps,
        device_busy_ms_per_step=busy_ms / steps, idle_share=1.0 - busy_ms / wall_ms,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels_us_per_step={e.key[:90]: e.self_device_time_total / steps for e in top},
        port_kernels_us_per_step={k: e.self_device_time_total / steps for k, e in port.items()},
        port_launches_per_step={k: e.count / steps for k, e in port.items()})))


if __name__ == "__main__":
    main()
