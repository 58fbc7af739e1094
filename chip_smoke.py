#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from any directory; needs one CUDA device

Phases, one line each on standard output:
  1. the card, as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives it;
  2. the kernels' build with ``nvcc`` (breaching_tpu_torch/ops/_build.py), with
     its seconds;
  3. each kernel against its plain PyTorch version on the card, at the slice's
     shapes and at ragged shapes, with the tolerance stated (the fused
     kernels bit for bit, NaN positions included); the fused TV kernel also at
     1x3x224x224, with NaN and infinite pixels at the boundary, twice in a row
     and in a replayed CUDA graph;
  4. the attack gradient of the slice on the card against the same computation on
     the CPU, through the plain versions (and whether the card gives the same
     bits twice, which is reported, not required);
  5. the slice end to end through the entry points: Inverting Gradients with the
     fused cosine objective on ConvNet-64 / CIFAR-10 shapes, a bounded number of
     iterations; loss at the start and end, PSNR, SSIM, it/s and every kernel's
     launch count (the fused TV kernel once per step, the B3 forward never);
  6. each kernel's time beside its bound, the plain version's time and one
     PyTorch call of the same function (for a fused kernel, the library call of
     the kernel it grew from), each as time per call (200 calls between two
     events), device time (the 200 calls captured in a CUDA graph and replayed)
     and host time per call (the 200 calls enqueued, no wait); the fused TV
     kernel also at 1x3x224x224.
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
KERNELS = {  # name -> (source, what it replaces in the JAX package)
    "b1_matching_sums": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:83"),
    "b2_axpby": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:104"),
    "b2_cosine_backward": ("breaching_tpu_torch/csrc/matching.cu",
                           "breaching_tpu/ops/matching.py:104 (_axpby inside _cos_bwd, :135-146)"),
    "b3_tv_forward": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:47"),
    "b3_tv_value_and_grad": ("breaching_tpu_torch/csrc/image.cu",
                             "breaching_tpu/ops/image.py:47 (_tv_kernel) with the JAX VJP "
                             "breaching_tpu/attacks/auxiliaries/regularizers.py:40-49,75-87"),
    "b4_box_project": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:75"),
    "b4_adam_box_step": ("breaching_tpu_torch/csrc/image.cu",
                         "breaching_tpu/ops/image.py:75 (_box_kernel) with the fused update chain "
                         "breaching_tpu/attacks/optimization_based_attack.py:206-217,401-466"),
}
# The kernels the slice's attack step runs; b2_axpby, b3_tv_forward and b4_box_project
# stay as the counterparts of the JAX package's _axpby, fused_total_variation and
# ops.box_project, checked and timed.
SLICE_KERNELS = ("b1_matching_sums", "b2_cosine_backward", "b3_tv_value_and_grad", "b4_adam_box_step")
BIG = (1, 3, 224, 224)  # the image batch of slice 2 (ResNet-18 at ImageNet shapes)
# (p, q) whose powers p, p-1, q, q-1 cheap_pow forms exactly: the fused TV gradient bit for bit
TV_EXACT = ((1.0, 1.0), (2.0, 1.0), (1.5, 2.0))


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

    def report_exact(name, shape, got, want, slice_shape):
        """Bit for bit where not NaN (signed zeros included), NaN in the same places."""
        nan = torch.isnan(want)
        ok = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                                  want[~nan].view(torch.int32))
        err = (got[~nan] - want[~nan]).abs().max().item() if bool((~nan).any()) else 0.0
        print(f"check {name} {shape}: max_abs_err={err:.3e} tol=0 (bits, {int(nan.sum())} NaN) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        require(ok, f"{name} disagrees with its plain version at {shape}")
        if slice_shape:
            worst[name] = max(worst.get(name, 0.0), err)

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

        sums, upstream = ops.matching_sums(r, d), torch.tensor(0.37, device=dev)
        for wrt_data in (False, True):
            got = ops.cosine_backward(sums, upstream, r, d, wrt_data)
            want = matching.cosine_backward_plain(sums, upstream, r, d, wrt_data)
            report_exact("b2_cosine_backward", f"{shape} wrt_data={wrt_data}", got, want,
                         n == n_params and not offset)

    for shape in (image_shape, (2, 3, 331, 1007)):
        x = randn(*shape)
        slice_shape = shape == image_shape
        for p, q in ((1.0, 1.0), (2.0, 0.5)):
            got, want = ops.tv_forward(x, p, q, 1e-8), image.tv_forward_plain(x, p, q, 1e-8)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report("b3_tv_forward", f"{shape} p={p} q={q}", got, want, 1e-5 * abs(want.item()),
                   slice_shape and p == 1.0)
        lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
        hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
        got, want = ops.box_project(x * 2, lo, hi), image.box_project_plain(x * 2, lo, hi)
        report("b4_box_project", str(shape), got, want, 0.0, slice_shape)
        for signed in (True, False):
            check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed, slice_shape)
    check_tv_value_and_grad(ops, image, report, report_exact, randn, image_shape)
    return worst


def check_tv_value_and_grad(ops, image, report, report_exact, randn, image_shape):
    """b3_tv_value_and_grad against its plain version: the gradient bit for bit for the
    exponents cheap_pow forms exactly (one rounding of the largest |value| otherwise),
    the value to 1e-5 relative; at the slice's shape, at 1x3x224x224 and at ragged
    shapes; with NaN and +-inf pixels at the boundary; repeated and graph-replayed."""
    name = "b3_tv_value_and_grad"
    scale = torch.tensor([0.2], device=DEVICE)

    def run(x, p, q):
        return ops.tv_value_and_grad(x, scale, p, q, 1e-8), image.tv_value_and_grad_plain(x, scale, p, q, 1e-8)

    for shape in (image_shape, BIG, (2, 3, 331, 1007), (2, 3, 17, 23), (1, 6, 33, 31),
                  (1, 6, 9, 1), (1, 3, 1, 7)):
        x = randn(*shape)
        record = shape == image_shape
        for p, q in TV_EXACT + ((2.0, 0.5),):
            (value, grad), (want_value, want) = run(x, p, q)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report(name, f"{shape} p={p} q={q} value", value, want_value, 1e-5 * abs(want_value.item()),
                   record and p == q == 1.0)
            if (p, q) in TV_EXACT:
                report_exact(name, f"{shape} p={p} q={q} gradient", grad, want, record and p == q == 1.0)
            else:  # pow(., -0.5) is rsqrtf in PyTorch, powf in the kernel
                report(name, f"{shape} p={p} q={q} gradient", grad, want,
                       2.0 ** -22 * want.abs().max().item(), False)
            if shape in (image_shape, (2, 3, 331, 1007)) and (p, q) in ((1.0, 1.0), (2.0, 0.5)):
                xr = x.clone().requires_grad_(True)
                auto, = torch.autograd.grad(image.tv_forward_plain(xr, p, q, 1e-8) * 0.2, xr)
                # autograd differentiates pow and the mean by other formulas: 1e-4 relative
                report(f"{name} vs autograd", f"{shape} p={p} q={q}", grad, auto,
                       1e-4 * auto.abs().max().item(), False)

    # C1: the plain version's rolls carry a NaN to the wrapped boundary column and row
    for shape in (image_shape, (2, 3, 17, 23)):
        H, W = shape[-2:]
        places = {"last column": (H // 2, W - 1), "last row": (H - 1, W // 2), "column 0": (H // 2, 0),
                  "row 0": (0, W // 2), "corner": (H - 1, W - 1)}
        cases, nan_cases = 0, 0
        for place, (h, w) in places.items():
            for planted in (float("nan"), float("inf"), float("-inf")):
                for p, q in ((1.0, 1.0), (2.0, 1.0)):
                    x = randn(*shape)
                    x[-1, -1, h, w] = planted
                    (value, grad), (want_value, want) = run(x, p, q)
                    nan = torch.isnan(want)
                    same = torch.equal(torch.isnan(grad), nan) and torch.equal(
                        grad[~nan].view(torch.int32), want[~nan].view(torch.int32))
                    require(same, f"{name} gradient at {shape}, {planted} at the {place}, p={p} q={q}: "
                                  f"{int(torch.isnan(grad).sum())} NaN, the plain version {int(nan.sum())}")
                    require(str(value.item()) == str(want_value.item()),
                            f"{name} value at {shape}, {planted} at the {place}: {value.item()} against "
                            f"{want_value.item()}")
                    cases, nan_cases = cases + 1, nan_cases + bool(nan.any())
        print(f"check {name} {shape} non-finite pixels at the boundary: {cases} cases ({nan_cases} with NaN "
              f"in the gradient), gradient bits and NaN positions equal, values non-finite alike ok", flush=True)

    # the same bits twice; a graph replayed on new images (the ticket counter resets)
    x, other = randn(*BIG), randn(*BIG)
    first, second = ops.tv_value_and_grad(x, scale), ops.tv_value_and_grad(x, scale)
    wants = [first, ops.tv_value_and_grad(other, scale)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ops.tv_value_and_grad(x, scale)
    replays = []
    for source in (x.clone(), other):
        x.copy_(source)
        graph.replay()
        replays.append(tuple(t.clone() for t in static))
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for got, want in [(second, first), *zip(replays, wants)] for a, b in zip(got, want)]
    print(f"check {name} {BIG} repeated launch and two graph replays: "
          f"{'ok' if all(same) else 'FAILED'}", flush=True)
    require(all(same), f"{name} gives other bits when repeated or replayed: {same}")


def check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed, slice_shape):
    """b4_adam_box_step against its plain version over three steps, with NaN and signed
    zeros planted in the gradient and a loss that improves, does not, then improves,
    so that the two best-value buffers swap and the best iterate is taken and kept."""
    dev = lo.device
    grads = [randn(*shape) for _ in range(3)]
    grads[0].view(-1)[::997] = float("nan")
    grads[1].view(-1)[::499] = -0.0
    grads[2].view(-1)[1::499] = 0.0
    start = dict(x=randn(*shape) * 2, mu=randn(*shape) * 0.1, nu=randn(*shape) ** 2 * 0.01,
                 best=randn(*shape))
    states = []
    for fused in (True, False):
        st = {k: v.clone() for k, v in start.items()}
        vals = [torch.tensor(float("inf"), device=dev), torch.empty((), device=dev)]
        seen = []
        for t, (grad, value) in enumerate(zip(grads, (0.5, 0.7, 0.3)), start=3):
            step = ops.AdamStep(lr=0.1 / t, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** t,
                                bias2=1 - 0.999 ** t)
            args = (st["x"], grad, st["mu"], st["nu"], st["best"], lo, hi,
                    torch.tensor(value, device=dev), *vals, step)
            (ops.adam_box_step if fused else image.adam_box_step_plain)(*args, signed=signed)
            vals.reverse()
            seen.append({**{k: v.clone() for k, v in st.items()}, "best_val": vals[0].reshape(1).clone()})
        states.append(seen)
    best_vals = [s["best_val"].item() for s in states[0]]
    require(best_vals == [0.5, 0.5, float(torch.tensor(0.3))],
            f"b4_adam_box_step best values over three steps: {best_vals}")
    for step, (got, want) in enumerate(zip(*states)):
        for key in ("x", "mu", "nu", "best", "best_val"):
            report_exact("b4_adam_box_step", f"{shape} signed={signed} step={step} {key}",
                         got[key], want[key], slice_shape and signed)


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
    v_again, g_again = attack_gradient(breaching, DEVICE, x0)
    # not a check: cuDNN's backward need not give the same bits twice
    print(f"reference: the card's loss and gradient computed twice: loss bits "
          f"{'equal' if v_again == v_gpu else 'differ'}, gradient bits "
          f"{'equal' if torch.equal(g_again.view(torch.int32), g_gpu.view(torch.int32)) else 'differ'} "
          f"(max |difference| {(g_again - g_gpu).abs().max().item():.3e})", flush=True)
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
    for name in SLICE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the slice")
    require(launches["b3_tv_value_and_grad"] == len(losses) and launches["b3_tv_forward"] == 0,
            f"TV was not one fused launch per step: {launches}")
    return launches


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(ops, n, image_shape):
    """Phase 6: times at the slice's shapes (inputs warm in L2, as in the attack step)."""
    from breaching_tpu_torch.ops import image, matching
    from breaching_tpu_torch.timing import time_ms

    gen = torch.Generator().manual_seed(99)
    dev = torch.device(DEVICE)
    r, d = torch.randn(n, generator=gen).to(dev), torch.randn(n, generator=gen).to(dev)
    a, b = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
    ar = a * r
    sums, upstream = ops.matching_sums(r, d), torch.tensor(0.37, device=dev)
    x = torch.randn(*image_shape, generator=gen).to(dev)
    g = torch.tensor([0.37], device=dev)
    lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
    hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
    lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
    m = x.numel()
    grad = torch.randn(*image_shape, generator=gen).to(dev)
    mu, nu, best = torch.zeros_like(x), torch.zeros_like(x), x.clone()
    value = torch.tensor(0.5, device=dev)
    # best_val stays inf: every call improves and writes best, the most bytes a step moves
    vals = (torch.tensor(float("inf"), device=dev), torch.empty((), device=dev))
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    step_args = (x, grad, mu, nu, best, lo, hi, value, *vals, step)
    cases = {
        # name: (kernel, plain, (library call, its name) or None, bytes, flops)
        "b1_matching_sums": (lambda: ops.matching_sums(r, d), lambda: matching.matching_sums_plain(r, d),
                             (lambda: (torch.dot(r, d), torch.linalg.vector_norm(r),
                                       torch.linalg.vector_norm(d)), "torch.dot + 2 vector_norm"),
                             8 * n + 12, 6 * n),
        "b2_axpby": (lambda: ops.axpby(a, r, b, d), lambda: matching.axpby_plain(a, r, b, d),
                     (lambda: torch.add(ar, d, alpha=1.3), "torch.add(alpha=)"), 12 * n + 8, 3 * n),
        # reads rec, data, the sums and g; writes one vector
        "b2_cosine_backward": (lambda: ops.cosine_backward(sums, upstream, r, d),
                               lambda: matching.cosine_backward_plain(sums, upstream, r, d),
                               None, 12 * n + 16, 3 * n),
        "b3_tv_forward": (lambda: ops.tv_forward(x), lambda: image.tv_forward_plain(x), None,
                          4 * m + 4, 8 * m),
        # reads x and the scale, writes the value and the gradient; about 20 operations
        # per element at p = q = 1
        "b3_tv_value_and_grad": (lambda: ops.tv_value_and_grad(x, g), lambda: image.tv_value_and_grad_plain(x, g),
                                 None, 8 * m + 8, 20 * m),
        "b4_box_project": (lambda: ops.box_project(x, lo, hi), lambda: image.box_project_plain(x, lo, hi),
                           (lambda: torch.clamp(x, lo4, hi4), "torch.clamp"), 8 * m + 24, 2 * m),
        # reads x, g, mu, nu, value, best_val, lo, hi; writes x, mu, nu, best (improved) and
        # the new best value; about 15 operations per element
        "b4_adam_box_step": (lambda: ops.adam_box_step(*step_args), lambda: image.adam_box_step_plain(*step_args),
                             None, 32 * m + 36, 15 * m),
    }
    # the fused TV kernel and B3 forward also at the shape slice 2 (ResNet-18, ImageNet)
    # gives them
    big = torch.randn(*BIG, generator=gen).to(dev)
    cases[f"b3_tv_value_and_grad {BIG}"] = (
        lambda: ops.tv_value_and_grad(big, g), lambda: image.tv_value_and_grad_plain(big, g),
        None, 8 * big.numel() + 8, 20 * big.numel())
    cases[f"b3_tv_forward {BIG}"] = (
        lambda: ops.tv_forward(big), lambda: image.tv_forward_plain(big), None,
        4 * big.numel() + 4, 8 * big.numel())
    # each fused kernel's second yardstick: the library call of the kernel it grew from;
    # for the fused TV kernel, B3 forward alone, the half of the pair it replaced that the
    # tree keeps (the whole pair, from the parent commit: python3 -m breaching_tpu_torch.timing)
    seconds = {"b2_cosine_backward": (*cases["b2_axpby"][2], "grew_from_library"),
               "b4_adam_box_step": (*cases["b4_box_project"][2], "grew_from_library")}
    for at in ("", f" {BIG}"):
        seconds["b3_tv_value_and_grad" + at] = (cases["b3_tv_forward" + at][0], "b3_tv_forward alone",
                                                "replaced_half")
    timings = {}
    for name, (kernel, plain, library, nbytes, flops) in cases.items():
        bound_ms, bound_by = bound(nbytes, flops)
        ms, device_ms, host_ms = time_ms(kernel)
        plain_ms, plain_device_ms, plain_host_ms = time_ms(plain)
        row = dict(ms=ms, device_ms=device_ms, host_ms=host_ms, plain_ms=plain_ms,
                   plain_device_ms=plain_device_ms, plain_host_ms=plain_host_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        yardstick = seconds.get(name, None if library is None else (*library, "library"))
        if yardstick is not None:
            lib_ms, lib_device_ms, lib_host_ms = time_ms(yardstick[0])
            prefix = yardstick[2]
            row.update({f"{prefix}_call": yardstick[1], f"{prefix}_ms": lib_ms,
                        f"{prefix}_device_ms": lib_device_ms, f"{prefix}_host_ms": lib_host_ms})
        timings[name] = row
        line = (f"time {name}: kernel {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device, "
                f"{host_ms * 1e3:.2f} us host; plain {plain_ms * 1e3:.2f} / {plain_device_ms * 1e3:.2f} / "
                f"{plain_host_ms * 1e3:.2f} us")
        if yardstick is not None:
            line += (f"; {yardstick[1]} {lib_ms * 1e3:.2f} / {lib_device_ms * 1e3:.2f} / "
                     f"{lib_host_ms * 1e3:.2f} us")
        print(f"{line}; bound {bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
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
        if f"{name} {BIG}" in timings:
            rows[-1]["at_1x3x224x224"] = timings[f"{name} {BIG}"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
