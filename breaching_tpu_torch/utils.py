"""System start-up and the run's records for the PyTorch port (counterpart of
``breaching_tpu/utils.py``).

``system_startup`` returns the ``setup`` dict every constructor takes: the device
(the card unless the caller asks for the CPU), the compute dtype and an explicit
``torch.Generator``. The generator lives on the CPU, so weights, data and candidate
initializations drawn from one seed are the same on the CPU and on the card; they
are moved to the device after they are drawn.

The records are the JAX package's: ``save_summary`` appends a run's row to a
tab-separated table, ``dump_metrics`` writes the metrics as YAML and
``save_reconstruction`` the reconstructed images as 8-bit RGB PNGs. Without PyYAML
and PIL, the YAML comes from a small emitter of the metrics' types (it reads back
through ``yaml.safe_load`` and ``config.loader.parse_yaml`` alike) and the PNGs are
written with ``zlib``.
"""

from __future__ import annotations

import csv
import datetime
import json
import logging
import os
import re
import socket
import struct
import time
import zlib

import numpy as np
import torch

from .config.loader import _plain_scalar
from .parallel import _dist

log = logging.getLogger(__name__)

# case.impl.dtype, as the JAX package maps it (breaching_tpu/utils.py:52-60)
_DTYPES = {"float": torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64, "double": torch.float64}


def model_dtype(setup) -> torch.dtype:
    """The type of the case's model and the user's exchange: float64 under
    ``case.impl.dtype=float64``, where the JAX package switches every default type to
    float64 (x64), else float32. Under bfloat16 the JAX package's models and users stay
    float32 and only the attack's target gradients and candidate take the type."""
    return torch.float64 if setup["dtype"] == torch.float64 else torch.float32


def system_startup(process_idx=0, local_group_size=1, cfg=None, device="cuda"):
    """Configure torch for one process and return the ``setup`` dict.

    Raises if ``device`` is a CUDA device and no card is present: the port never
    falls back to the CPU on its own. Started by ``torchrun`` (``WORLD_SIZE`` > 1), the
    rank joins the process group (``parallel._dist.start_from_env``: NCCL where every rank
    of a host has a card of its own, else gloo) and takes ``cuda:LOCAL_RANK`` (modulo the
    cards); every rank draws from the same seed.
    """
    _configure_logging()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is available; pass device='cpu' to run on the CPU.")
    device = _dist.start_from_env(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    # Full float32 everywhere: TF32 keeps about three decimal digits, which the
    # simulated FL exchange and the gradient matching must not lose.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dtype = torch.float32
    if cfg is not None and "case" in cfg:
        dtype_name = str(cfg.case.impl.get("dtype", "float"))
        if dtype_name not in _DTYPES:
            raise ValueError(f"impl.dtype={dtype_name} is not supported by the port; "
                             f"choose one of {sorted(_DTYPES)}.")
        dtype = _DTYPES[dtype_name]
    if cfg is not None and cfg.get("seed") is None:
        # every rank takes rank 0's draw
        seed = int.from_bytes(os.urandom(4), "little") if _dist.is_writer() else 0
        cfg.seed = int(_dist.all_reduce_(torch.tensor([seed], dtype=torch.int64))[0])
    seed = int(cfg.seed) if cfg is not None else 0
    generator = torch.Generator(device="cpu").manual_seed(seed)

    log.info(f"Device: {device} "
             f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'CPU'}) on "
             f"{socket.gethostname()}. Python {os.sys.version.split()[0]}, torch {torch.__version__}.")
    if cfg is not None:
        log.info(f"Experiment {cfg.name} with seed {cfg.seed}.")
    rank, world_size = _dist.world()
    if world_size > 1:
        log.info(f"Rank {rank} of {world_size} over {_dist.backend()}.")
    return dict(device=device, dtype=dtype, generator=generator,
                python_rng=np.random.default_rng(seed))


def _configure_logging():
    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
    root.setLevel(logging.INFO)


def save_summary(cfg, metrics, stats, local_time, table_name="breach"):
    """Flatten the run into one row and append it to the table
    ``<base_dir>/tables/table_<table_name>_<case>.csv``."""
    summary = dict(
        name=cfg.name,
        usecase=cfg.case.name,
        model=cfg.case.model,
        datapoints=cfg.case.user.num_data_points,
        model_state=cfg.case.server.model_state,
        attack=cfg.attack.type,
        attacktype=cfg.attack.attack_type,
    )
    for key, value in metrics.items():
        if not isinstance(value, (list, dict, np.ndarray, torch.Tensor)):
            summary[key] = value
    if "opt_value" in stats:
        summary["opt_value"] = stats["opt_value"]
    summary["score"] = stats.get("score", "")
    summary["total_time"] = str(datetime.timedelta(seconds=local_time)).replace(",", "")
    for key, value in flatten(cfg.to_dict()).items():
        summary[key] = value
    save_to_table(os.path.join(cfg.get("base_dir", "outputs"), "tables"),
                  f"table_{table_name}_{cfg.case.name}", cfg.dryrun, **summary)
    return summary


def flatten(d, parent_key="", sep="_"):
    items = []
    for k, v in d.items():
        new_key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, dict):
            items.extend(flatten(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)


def save_to_table(out_dir, table_name, dryrun=False, /, **kwargs):
    """Append a row to a tab-separated file, writing the header first; a file that
    exists keeps its columns (new keys are dropped, missing ones left blank).
    Nothing is written on a dry run, nor by a rank other than 0 of a process group."""
    if dryrun or not _dist.is_writer():
        log.debug(f"Skipping table write in dryrun mode for {table_name}.")
        return
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"{table_name}.csv")
    fieldnames = list(kwargs.keys())
    exists = os.path.isfile(fname)
    if exists:
        with open(fname) as fh:
            header = fh.readline().rstrip("\n").split("\t")
        kwargs = {k: kwargs.get(k, "") for k in header}
        fieldnames = header
    with open(fname, "a", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=fieldnames, delimiter="\t")
        if not exists:
            writer.writeheader()
        writer.writerow({k: str(v) for k, v in kwargs.items()})
    log.info(f"Appended run summary to {fname}.")


def avg_n_dicts(dicts):
    """The mean of each key's finite numbers over a list of dicts."""
    means = {}
    for d in dicts:
        for key, value in d.items():
            if isinstance(value, (int, float, np.floating, np.integer)) and np.isfinite(value):
                means.setdefault(key, []).append(float(value))
    return {k: float(np.mean(v)) for k, v in means.items() if len(v) > 0}


def dump_metrics(cfg, metrics, out_dir=None):
    """Write the metrics to ``<base_dir>/metrics_<name>.yaml``: arrays as lists, numpy
    scalars as floats, keys sorted (as ``yaml.safe_dump`` writes them). Only rank 0 of a
    process group writes."""
    if not _dist.is_writer():
        return
    out_dir = out_dir or cfg.get("base_dir", "outputs")
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"metrics_{cfg.name}.yaml")
    sanitized = {}
    for k, v in metrics.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            sanitized[k] = v.tolist()
        elif isinstance(v, (np.floating, np.integer)):
            sanitized[k] = float(v)
        else:
            sanitized[k] = v
    with open(fname, "w") as fh:
        fh.write(_yaml_block(sanitized, 0))
    log.info(f"Dumped metrics to {fname}.")


_PLAIN = re.compile(r"^[A-Za-z_][A-Za-z0-9_\-. /]*$")


def _yaml_scalar(value) -> str:
    """One scalar as YAML 1.1 (PyYAML's forms for floats: ``.nan``, ``.inf``, a
    mantissa with a dot)."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    text = str(value)
    if _PLAIN.match(text) and not text.endswith(" ") and _plain_scalar(text) == text:
        return text
    return json.dumps(text, ensure_ascii=False)


def _yaml_block(value, indent: int) -> str:
    """A mapping (keys sorted) or a sequence in YAML's block style; nested
    sequences inside a sequence in flow style."""
    pad = " " * indent
    lines = []
    if isinstance(value, dict):
        for key in sorted(value, key=str):
            item = value[key]
            if isinstance(item, (dict, list)) and item:  # a sequence sits at its key's indentation
                inner = indent + 2 if isinstance(item, dict) else indent
                lines.append(f"{pad}{_yaml_scalar(key)}:\n{_yaml_block(item, inner)}")
            else:
                lines.append(f"{pad}{_yaml_scalar(key)}: {_yaml_flow(item)}\n")
    else:
        for item in value:
            lines.append(f"{pad}- {_yaml_flow(item)}\n")
    return "".join(lines)


def _yaml_flow(value) -> str:
    if isinstance(value, list):
        return "[" + ", ".join(_yaml_flow(v) for v in value) + "]"
    return "{}" if value == {} else _yaml_scalar(value)


def save_reconstruction(reconstructed_user_data, server_payload, true_user_data, cfg, user_idx=None):
    """Save the reconstructed images, denormalized, as 8-bit RGB PNGs
    ``<base_dir>/reconstructions/<name>_rec_<i>.png``, truncated as
    ``(img * 255).astype(np.uint8)`` truncates. With ``user_idx`` the names read
    ``<name>_user<user_idx>_rec_<i>.png``, so that the users of one benchmark keep
    their own files. Only rank 0 of a process group writes."""
    if not _dist.is_writer():
        return
    out_dir = os.path.join(cfg.get("base_dir", "outputs"), "reconstructions")
    os.makedirs(out_dir, exist_ok=True)
    metadata = server_payload[0]["metadata"]
    stem = cfg.name if user_idx is None else f"{cfg.name}_user{user_idx}"
    data = reconstructed_user_data["data"]
    data = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    if metadata.modality == "vision":
        dm = np.asarray(metadata.mean)[None, None, None, :]
        ds = np.asarray(metadata.std)[None, None, None, :]
        rec = np.transpose(data.astype(np.float32), (0, 2, 3, 1))
        rec = np.clip(rec * ds + dm, 0, 1)
        for idx, img in enumerate(rec):
            write_png(os.path.join(out_dir, f"{stem}_rec_{idx}.png"), (img * 255).astype(np.uint8))
    else:
        with open(os.path.join(out_dir, f"{stem}_rec.txt"), "w") as fh:
            fh.write(str(data.tolist()))
    log.info(f"Saved reconstruction to {out_dir}.")


def write_png(path, rgb):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (no filter, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, not {rgb.shape}.")
    height, width = rgb.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), rgb.reshape(height, width * 3)], axis=1)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + chunk(b"IEND", b""))


class Timer:
    """Wall-clock timer for per-phase profiling: ``lap()`` returns the seconds since
    the last lap (or the start)."""

    def __init__(self):
        self.t0 = time.time()

    def lap(self):
        now = time.time()
        delta, self.t0 = now - self.t0, now
        return delta
