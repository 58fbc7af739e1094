"""The trained-against-random leakage gap (counterpart of ``tools/measure_asymmetry.py``).

The same attack, seeds and data, once against a random initialization and once against
the trained checkpoint that ``case.server.pretrained=True`` loads (the port's own,
written by ``python3 -m breaching_tpu_torch.train_model``, at
``<case.data.path>/checkpoints/<model>.npz``, else the repo's ``assets/checkpoints``): the
reconstruction's metrics and the user update's gradient norm, for each regime.

    python3 -m breaching_tpu_torch.measure_asymmetry [--iterations N] [--case C] [--attack A] \\
        [--out DIR] [overrides...]

Defaults: 2800 steps, ``case=2_single_imagenet``, ``attack=invertinggradients``, labels
given, one trial, seed 7. It writes ``DIR/asymmetry.md`` (the table) and the two regimes'
metrics as ``DIR/metrics_asym_<regime>.yaml``, DIR defaulting to ``outputs/asymmetry``; it
writes nothing else. ``main(argv, device="cpu")`` runs the same on the CPU. A modestly
trained checkpoint makes the gap a lower bound on the one against converged weights.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

import breaching_tpu_torch as breaching


def run_regime(case, attack, iterations, pretrained, overrides, out_dir, device):
    """One regime: its metrics, the user update's gradient norm and the attack's seconds."""
    cfg = breaching.get_config([
        f"case={case}", f"attack={attack}", f"attack.optim.max_iterations={iterations}",
        f"attack.optim.callback={min(700, iterations)}", "attack.restarts.num_trials=1",
        "case.user.provide_labels=True",  # isolates the data's leakage across the regimes
        f"case.server.pretrained={pretrained}", "seed=7", f"name=asym_{'trained' if pretrained else 'random'}",
        *overrides])
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, true_data = server.run_protocol(user)
    grad_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in shared[0]["gradients"].values())))
    start = time.perf_counter()
    rec, stats = attacker.reconstruct(payloads, shared, server.secrets)
    if setup["device"].type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    metrics = breaching.analysis.report(rec, true_data, payloads, server.model, cfg_case=cfg.case, setup=setup)
    breaching.utils.dump_metrics(cfg, metrics, out_dir=out_dir)
    return dict(metrics=metrics, grad_norm=grad_norm, wall=wall)


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=2800)
    parser.add_argument("--case", default="2_single_imagenet")
    parser.add_argument("--attack", default="invertinggradients")
    parser.add_argument("--out", default=os.path.join("outputs", "asymmetry"))
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    rows = {}
    for pretrained in (False, True):
        tag = "trained" if pretrained else "random"
        rows[tag] = run_regime(args.case, args.attack, args.iterations, pretrained, args.overrides, args.out,
                               device)
        m = rows[tag]["metrics"]
        print(f"{tag}: psnr={m['psnr']:.2f} rpsnr={m.get('rpsnr', float('nan')):.2f} "
              f"grad_norm={rows[tag]['grad_norm']:.4f}", flush=True)
    gap = rows["random"]["metrics"]["psnr"] - rows["trained"]["metrics"]["psnr"]
    lines = [
        "# Trained-against-random leakage asymmetry",
        "",
        f"Setting: `case={args.case} attack={args.attack}` at {args.iterations} steps, seed 7, labels given, one",
        f"trial, overrides `{' '.join(args.overrides)}`. The trained regime loads the checkpoint of",
        "`case.server.pretrained=True`; the random regime is a fresh initialization. Written by",
        "`python3 -m breaching_tpu_torch.measure_asymmetry`.",
        "",
        "| Regime | PSNR | R-PSNR | SSIM | MSE | user grad-norm | attack wall s |",
        "|---|---|---|---|---|---|---|",
    ]
    for tag in ("random", "trained"):
        m = rows[tag]["metrics"]
        lines.append(f"| {tag} | {m['psnr']:.2f} | {m.get('rpsnr', float('nan')):.2f} | "
                     f"{m.get('ssim', float('nan')):.4f} | {m.get('mse', float('nan')):.5f} | "
                     f"{rows[tag]['grad_norm']:.4f} | {rows[tag]['wall']:.1f} |")
    lines += ["", f"The random initialization leaks {gap:+.2f} dB PSNR more than the trained checkpoint."]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "asymmetry.md"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    return dict(rows=rows, gap=gap)


if __name__ == "__main__":
    main()
