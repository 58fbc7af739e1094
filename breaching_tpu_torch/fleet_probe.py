"""Fleet throughput at a given width and attack precision, without the full benchmark
(counterpart of ``tools/fleet_probe.py``).

    python3 -m breaching_tpu_torch.fleet_probe [FLEET] [DTYPE] [--iterations N] [--chunk C] [overrides...]

Attacks FLEET users of slice 2's workload (ResNet-18 on ImageNet shapes, Inverting
Gradients, one trial each, labels given, seed 7) as one fleet (``reconstruct_fleet``) under
``attack.impl.dtype=DTYPE`` (default 16 and bfloat16, 2800 steps read back every 700), after
a one-step warm-up fleet that builds the kernels, and prints one JSON line: the card, the
aggregate steps per second of all the fleet's users over the timed attack (which ends in a
device synchronisation), its wall seconds, and each user's PSNR (the report's, of the
denormalized images in the batch's own order, without the report's other metrics). It
prints no ratio to any other system's figure. ``main(argv, device="cpu")`` runs the same on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import torch

import breaching_tpu_torch as breaching
from .analysis.metrics import mse_psnr

BASE = ["case=2_single_imagenet", "attack=invertinggradients", "attack.restarts.num_trials=1",
        "case.user.provide_labels=True", "seed=7", "name=fleetprobe"]


def _fleet(cfg, setup, fleet):
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    payload_lists, shared_lists, truths = [], [], []
    for user_idx in range(fleet):
        cfg.case.user.user_idx = user_idx
        user = breaching.cases.construct_user(model, server.loss, cfg.case, setup)
        shared, payloads, true_data = server.run_protocol(user)
        payload_lists.append(payloads)
        shared_lists.append(shared)
        truths.append(true_data)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    return server, attacker, payload_lists, shared_lists, truths


def _psnr(rec, true, metadata) -> float:
    """The report's PSNR of the denormalized, clamped images."""
    mean = torch.as_tensor(metadata.mean, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    std = torch.as_tensor(metadata.std, dtype=torch.float32, device=rec.device).reshape(1, -1, 1, 1)
    return float(mse_psnr(torch.clamp(rec.float() * std + mean, 0, 1), torch.clamp(true.float() * std + mean, 0, 1),
                          clip=True)[1])


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("fleet", nargs="?", type=int, default=16)
    parser.add_argument("dtype", nargs="?", default="bfloat16")
    parser.add_argument("--iterations", type=int, default=2800)
    parser.add_argument("--chunk", type=int, default=700)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    previous = logging.root.manager.disable  # the INFO logs are silenced for the run alone
    logging.disable(logging.INFO)
    try:
        cfg = breaching.get_config(BASE + [f"attack.optim.max_iterations={args.iterations}",
                                           f"attack.optim.callback={args.chunk}", f"attack.impl.dtype={args.dtype}",
                                           *args.overrides])
        setup = breaching.utils.system_startup(cfg=cfg, device=device)
        server, attacker, payload_lists, shared_lists, truths = _fleet(cfg, setup, args.fleet)
        attacker.reconstruct_fleet(payload_lists, shared_lists, server.secrets, dryrun=True)  # warm-up
        cuda = setup["device"].type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        results, _ = attacker.reconstruct_fleet(payload_lists, shared_lists, server.secrets)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - start
        psnrs = [round(_psnr(rec["data"], true_data["data"], payloads[0]["metadata"]), 2)
                 for rec, true_data, payloads in zip(results, truths, payload_lists)]
        line = dict(device=torch.cuda.get_device_name(setup["device"]) if cuda else "cpu", fleet=args.fleet,
                    dtype=args.dtype, iterations=args.iterations,
                    agg_iters_per_sec=round(args.fleet * args.iterations / max(wall, 1e-9), 2), wall_s=round(wall, 2),
                    psnr_mean=round(sum(psnrs) / len(psnrs), 2), psnrs=psnrs)
    finally:
        logging.disable(previous)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
