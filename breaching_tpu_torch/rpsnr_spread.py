"""Registered PSNR of the same reconstructions in float32 and float64, on the card and on
the CPU.

    python3 -m breaching_tpu_torch.rpsnr_spread --save FILE   # slice 10's wave on the card, then register
    python3 -m breaching_tpu_torch.rpsnr_spread --load FILE   # register the saved images again
    python3 -m breaching_tpu_torch.rpsnr_spread --load FILE --cpu OUT [--threads N]

With ``--save`` it runs ``chip_smoke.py``'s slice-10 benchmark (``benchmark_breaches`` on case 2,
ResNet-18 on the repo's checkpoint at 224, one wave of 8 users, 50 fused-cosine steps) on the
card and writes every user's reconstruction and true image, denormalized and clamped to
[0, 1] as the report registers them, to FILE (``.npz``); with ``--load`` it reads them from
FILE. Then it registers each user's pair with ``analysis.metrics.registered_psnr`` (500 Adam
steps of an affine and a projective warp, as the report does) four times: on the card and
on the CPU, each in float32 and in float64. It prints one JSON line per user, with the four
figures, their gaps (``card32_cpu64``, ``cpu32_cpu64``, ``card64_cpu64``, ``card32_cpu32``) and
seconds, and one line over all users. Needs a CUDA device, but for ``--cpu OUT``, which
registers on the CPU alone (``--threads`` of them) and writes the rows as one JSON list to
OUT: ``chip_smoke.py`` runs it so beside the card's later paths.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

import breaching_tpu_torch as breaching
from breaching_tpu_torch.analysis import metrics as M

BENCHMARK = ["case=2_single_imagenet", "attack=invertinggradients", "attack.objective.type=fused-cosine-similarity",
             "num_trials=8", "fleet=8", "attack.optim.max_iterations=50", "attack.optim.callback=25", "seed=7",
             "name=fleet"]


def benchmark_images() -> dict:
    """Slice 10's wave on the card: {"rec": (8, 3, 224, 224), "true": ...} in [0, 1], float32."""
    from breaching_tpu_torch import benchmark_breaches

    outputs = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = breaching.get_config(BENCHMARK + [f"base_dir={tmp}"])
        cwd = os.getcwd()
        os.chdir(tmp)  # the averaged table goes under the working directory
        try:
            benchmark_breaches.main_process(cfg, device="cuda", outputs=outputs)
        finally:
            os.chdir(cwd)
    pairs = {"rec": [], "true": []}
    for _, _, _, rec, true, payloads in outputs["reports"]:
        metadata = payloads[0]["metadata"]
        dm, ds = (torch.as_tensor(v, device=rec["data"].device).reshape(1, -1, 1, 1) for v in (metadata.mean,
                                                                                             metadata.std))
        for key, x in (("rec", rec), ("true", true)):
            pairs[key].append(torch.clamp(x["data"].detach().float() * ds + dm, 0, 1).cpu().numpy())
    return {key: np.concatenate(v) for key, v in pairs.items()}


def registered(rec: np.ndarray, true: np.ndarray, device: str, dtype: torch.dtype) -> tuple[float, float]:
    """(registered PSNR of one image pair on ``device`` in ``dtype``, its seconds)."""
    x, y = (torch.as_tensor(v[None], device=device, dtype=dtype) for v in (rec, true))
    if device == "cuda":
        torch.cuda.synchronize()
    start = time.perf_counter()
    value = float(M.registered_psnr(x, y))
    return value, time.perf_counter() - start


def register_all(images: dict, devices) -> list[dict]:
    """Each user's registered PSNR on each of ``devices`` in float32 and float64 (``card32``,
    ``cpu64``, ...), with its seconds."""
    rows = []
    for user, (rec, true) in enumerate(zip(images["rec"], images["true"])):
        row = dict(user=user)
        for device in devices:
            for dtype in (torch.float32, torch.float64):
                name = f"{'card' if device == 'cuda' else 'cpu'}{dtype.itemsize * 8}"
                row[name], row[f"{name}_seconds"] = registered(rec, true, device, dtype)
        rows.append(row)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--save", help="run slice 10's wave on the card and write its images to this .npz")
    group.add_argument("--load", help="read the images of an earlier --save")
    parser.add_argument("--cpu", help="with --load: register on the CPU alone and write the rows to this .json")
    parser.add_argument("--threads", type=int, default=None, help="the CPU's threads (default torch's)")
    args = parser.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.cpu and not args.load:
        parser.error("--cpu registers the images of --load.")
    if args.load:
        with np.load(args.load) as blob:
            images = dict(blob)
    if args.cpu:
        with open(args.cpu, "w") as out:
            json.dump(register_all(images, ("cpu",)), out)
        return
    if not torch.cuda.is_available():
        raise SystemExit("rpsnr_spread needs a CUDA device.")
    breaching.utils.system_startup(device="cuda")  # TF32 off, as in every run of the port
    if args.save:
        images = benchmark_images()
        np.savez(args.save, **images)
    rows = register_all(images, ("cuda", "cpu"))
    keys = ("card32_cpu64", "cpu32_cpu64", "card64_cpu64", "card32_cpu32")
    for row in rows:
        row.update({key: abs(row[key.split("_")[0]] - row[key.split("_")[1]]) for key in keys})
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), users=len(rows), threads=torch.get_num_threads(),
                          **{f"max_{k}": max(r[k] for r in rows) for k in keys},
                          **{f"mean_{k}": float(np.mean([r[k] for r in rows])) for k in keys})), flush=True)


if __name__ == "__main__":
    main()
