#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from any directory; needs one CUDA device

Phases, one line each on standard output:
  1. the card, as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives it;
  2. the kernels' build with ``nvcc`` (breaching_tpu_torch/ops/_build.py), with
     its seconds;
  3. each kernel against its plain PyTorch version on the card, at the slice's
     shapes and at ragged shapes, with the tolerance stated;
  4. the attack gradient of the slice on the card against the same computation on
     the CPU, through the plain versions;
  5. the slice end to end through the entry points: Inverting Gradients with the
     fused cosine objective on ConvNet-64 / CIFAR-10 shapes, a bounded number of
     iterations; loss at the start and end, PSNR, SSIM, it/s and every kernel's
     launch count;
  6. each kernel's time beside its bound, the plain version's time and one
     PyTorch call of the same function.
Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, without that line, when no CUDA device is present, a kernel does
not build, launch or agree, a kernel of the slice was not launched, or the
attack's loss does not fall.
"""

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ITERATIONS = 2000
DEVICE = "cuda"
SLICE = ["case=1_single_image_small", "attack=invertinggradients",
         "attack.objective.type=fused-cosine-similarity"]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNELS = {  # name -> (source, TPU kernel's pallas_call it replaces)
    "b1_matching_sums": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:83"),
    "b2_axpby": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:104"),
    "b3_tv_forward": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:47"),
    "b3_tv_backward": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:47"),
    "b4_box_project": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:75"),
}


class CheckFailed(Exception):
    pass


def require(condition, message):
    if not condition:
        raise CheckFailed(message)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def check_kernels(ops, n_params, image_shape):
    """Phase 3: every kernel against its plain version. Returns the largest error
    of each kernel at the slice's shapes."""
    from breaching_tpu_torch.ops import image, matching

    gen = torch.Generator().manual_seed(1234)
    dev = torch.device(DEVICE)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    worst = {}

    def report(name, shape, got, want, tol, slice_shape):
        err = (got - want).abs()
        ok = bool((err <= tol).all())
        print(f"check {name} {shape}: max_abs_err={err.max().item():.3e} "
              f"tol={torch.as_tensor(tol).min().item():.3e} {'ok' if ok else 'FAILED'}", flush=True)
        require(ok, f"{name} disagrees with its plain version at {shape}")
        if slice_shape:
            worst[name] = max(worst.get(name, 0.0), err.max().item())

    for n, offset in ((n_params, 0), (1_000_003, 0), (1_000_003, 1)):
        # offset 1 starts both vectors 4 bytes into their buffers: the unaligned path
        r, d = randn(n + offset)[offset:], randn(n + offset)[offset:]
        shape = f"n={n}{' unaligned' if offset else ''}"
        got = ops.matching_sums(r, d).double()
        want = matching.matching_sums_plain(r, d).double()
        # float32 sums of n terms in two different orders: each within about
        # (terms per thread + log2 n) * 2^-24 of the sum of |terms|; 1e-5 covers both
        scale = torch.stack([(r * d).abs().double().sum(), (r * r).double().sum(), (d * d).double().sum()])
        report("b1_matching_sums", shape, got, want, 1e-5 * scale, n == n_params and not offset)

        a, b = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
        got, want = ops.axpby(a, r, b, d), matching.axpby_plain(a, r, b, d)
        # products and sum rounded separately in both: equal up to one rounding
        tol = 2.0 ** -23 * want.abs().max().item()
        report("b2_axpby", shape, got, want, tol, n == n_params and not offset)

    for shape in (image_shape, (2, 3, 331, 1007)):
        x = randn(*shape)
        slice_shape = shape == image_shape
        for p, q in ((1.0, 1.0), (2.0, 0.5)):
            got, want = ops.tv_forward(x, p, q, 1e-8), image.tv_forward_plain(x, p, q, 1e-8)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report("b3_tv_forward", f"{shape} p={p} q={q}", got, want, 1e-5 * abs(want.item()),
                   slice_shape and p == 1.0)
            g = torch.tensor([0.37], device=dev)
            got = ops.tv_backward(x, g, p, q, 1e-8)
            want = image.tv_backward_plain(x, g, p, q, 1e-8)
            xr = x.clone().requires_grad_(True)
            auto, = torch.autograd.grad(image.tv_forward_plain(xr, p, q, 1e-8) * 0.37, xr)
            # same closed form as the plain version: a few roundings apart
            tol = 1e-6 * want.abs().max().item()
            report("b3_tv_backward", f"{shape} p={p} q={q}", got, want, tol, slice_shape and p == 1.0)
            # autograd differentiates pow and the mean by other formulas: 1e-4 relative
            tol = 1e-4 * auto.abs().max().item()
            report("b3_tv_backward vs autograd", f"{shape} p={p} q={q}", got, auto, tol, False)
        lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
        hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
        got, want = ops.box_project(x * 2, lo, hi), image.box_project_plain(x * 2, lo, hi)
        report("b4_box_project", str(shape), got, want, 0.0, slice_shape)
    return worst


def attack_gradient(breaching, device, x0):
    """The slice's loss and its gradient at candidate x0, on `device`."""
    cfg = breaching.get_config(SLICE + ["seed=7"])
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    rec_models, labels, _ = attacker.prepare_attack(payloads, shared)
    attacker.objective.initialize(loss_fn, rec_models[0].module, None, cfg.attack.impl)
    targets = [tuple(shared[0]["gradients"][k] for k in rec_models[0].params)]
    x = x0.to(device).requires_grad_(True)
    value, _ = attacker._loss(x, rec_models, targets, labels)
    grad, = torch.autograd.grad(value, x)
    return value.item(), grad.cpu()


def check_reference(breaching):
    """Phase 4: the attack gradient on the card (kernels, cuDNN) against the CPU
    (plain versions), same weights, data and candidate."""
    x0 = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(5))
    v_gpu, g_gpu = attack_gradient(breaching, DEVICE, x0)
    v_cpu, g_cpu = attack_gradient(breaching, "cpu", x0)
    # float32 on both sides, convolutions and sums in other orders; the gradient
    # passes through a double backward: 1e-4 relative on the value, 1e-3 on the gradient
    v_err = abs(v_gpu - v_cpu) / abs(v_cpu)
    g_err = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    ok = v_err <= 1e-4 and g_err <= 1e-3 and bool(torch.isfinite(g_gpu).all())
    print(f"reference: loss card={v_gpu:.7f} cpu={v_cpu:.7f} rel_err={v_err:.2e} (tol 1e-4); "
          f"gradient rel_err={g_err:.2e} (tol 1e-3) {'ok' if ok else 'FAILED'}", flush=True)
    require(ok, "the slice's attack gradient on the card disagrees with the CPU")


def run_slice(breaching, ops):
    """Phase 5: the main path through the entry points; launch counts from this run only."""
    cfg = breaching.get_config(SLICE + [f"attack.optim.max_iterations={ITERATIONS}",
                                        "attack.optim.callback=500", "seed=0"])
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared_data, payloads, true_user_data = server.run_protocol(user)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start = time.perf_counter()
    reconstruction, stats = attacker.reconstruct(payloads, shared_data, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    metrics = breaching.analysis.report(reconstruction, true_user_data, payloads, server.model,
                                        cfg_case=cfg.case, setup=setup)
    losses = stats["Trial_0_Val"]
    data = reconstruction["data"]
    print(f"slice: ConvNet-64 {sum(p.numel() for p in model.parameters())} parameters, "
          f"{len(losses)} iterations in {seconds:.2f} s = {len(losses) / seconds:.1f} it/s; "
          f"loss first={losses[0]:.6f} last={losses[-1]:.6f} best={stats['opt_value']:.6f}; "
          f"PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; launches {launches}", flush=True)
    require(tuple(data.shape) == (1, 3, 32, 32) and bool(torch.isfinite(data).all()),
            f"reconstruction is not a finite (1, 3, 32, 32) tensor: {tuple(data.shape)}")
    require(losses[-1] < losses[0], "the attack's loss did not fall")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the slice")
    return launches


def time_ms(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(ops, n, image_shape):
    """Phase 6: times at the slice's shapes (inputs warm in L2, as in the attack step)."""
    from breaching_tpu_torch.ops import image, matching

    gen = torch.Generator().manual_seed(99)
    dev = torch.device(DEVICE)
    r, d = torch.randn(n, generator=gen).to(dev), torch.randn(n, generator=gen).to(dev)
    a, b = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
    ar = a * r
    x = torch.randn(*image_shape, generator=gen).to(dev)
    g = torch.tensor([0.37], device=dev)
    lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
    hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
    lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
    m = x.numel()
    cases = {
        # name: (kernel, plain, library call or None, bytes, flops)
        "b1_matching_sums": (lambda: ops.matching_sums(r, d), lambda: matching.matching_sums_plain(r, d),
                             lambda: (torch.dot(r, d), torch.linalg.vector_norm(r),
                                      torch.linalg.vector_norm(d)),
                             8 * n + 12, 6 * n),
        "b2_axpby": (lambda: ops.axpby(a, r, b, d), lambda: matching.axpby_plain(a, r, b, d),
                     lambda: torch.add(ar, d, alpha=1.3), 12 * n + 8, 3 * n),
        "b3_tv_forward": (lambda: ops.tv_forward(x), lambda: image.tv_forward_plain(x), None,
                          4 * m + 4, 8 * m),
        "b3_tv_backward": (lambda: ops.tv_backward(x, g), lambda: image.tv_backward_plain(x, g), None,
                           8 * m + 4, 30 * m),
        "b4_box_project": (lambda: ops.box_project(x, lo, hi), lambda: image.box_project_plain(x, lo, hi),
                           lambda: torch.clamp(x, lo4, hi4), 8 * m + 24, 2 * m),
    }
    timings = {}
    for name, (kernel, plain, library, nbytes, flops) in cases.items():
        bound_ms, bound_by = bound(nbytes, flops)
        row = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                   library_ms=time_ms(library) if library else None,
                   bound_ms=bound_ms, bound_by=bound_by)
        timings[name] = row
        library_us = "-" if library is None else "%.2f us" % (row["library_ms"] * 1e3)
        print(f"time {name}: kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, "
              f"library {library_us}, bound {bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    return timings


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import breaching_tpu_torch as breaching
    from breaching_tpu_torch import ops
    from breaching_tpu_torch.ops import _build

    print(card_line(), flush=True)

    start = time.perf_counter()
    _build.load_library()
    print(f"build: {os.path.relpath(_build.library_path(), REPO)} ready in "
          f"{time.perf_counter() - start:.1f} s (nvcc {_build.build_seconds or 0.0:.1f} s)", flush=True)

    cfg = breaching.get_config(SLICE)
    n_params = sum(p.numel() for p in breaching.cases.construct_model(cfg.case.model, cfg.case.data)[0]
                   .parameters())
    image_shape = (int(cfg.case.user.num_data_points), *cfg.case.data.shape)
    errors = check_kernels(ops, n_params, image_shape)
    check_reference(breaching)
    launches = run_slice(breaching, ops)
    timings = time_kernels(ops, n_params, image_shape)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=errors[name], **timings[name]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
