"""System start-up for the PyTorch port (counterpart of ``breaching_tpu/utils.py``).

``system_startup`` returns the ``setup`` dict every constructor takes: the device
(the card unless the caller asks for the CPU), the compute dtype and an explicit
``torch.Generator``. The generator lives on the CPU, so weights, data and candidate
initializations drawn from one seed are the same on the CPU and on the card; they
are moved to the device after they are drawn.
"""

from __future__ import annotations

import logging
import os
import socket

import numpy as np
import torch

log = logging.getLogger(__name__)

_DTYPES = {"float": torch.float32, "float32": torch.float32}


def system_startup(process_idx=0, local_group_size=1, cfg=None, device="cuda"):
    """Configure torch for one process and return the ``setup`` dict.

    Raises if ``device`` is a CUDA device and no card is present: the port never
    falls back to the CPU on its own.
    """
    _configure_logging()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("No CUDA device is available; pass device='cpu' to run on the CPU.")
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
        cfg.seed = int.from_bytes(os.urandom(4), "little")
    seed = int(cfg.seed) if cfg is not None else 0
    generator = torch.Generator(device="cpu").manual_seed(seed)

    log.info(f"Device: {device} "
             f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'CPU'}) on "
             f"{socket.gethostname()}. Python {os.sys.version.split()[0]}, torch {torch.__version__}.")
    if cfg is not None:
        log.info(f"Experiment {cfg.name} with seed {cfg.seed}.")
    return dict(device=device, dtype=dtype, generator=generator,
                python_rng=np.random.default_rng(seed))


def _configure_logging():
    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        root.addHandler(handler)
    root.setLevel(logging.INFO)
