"""Candidate initialization (counterpart of ``breaching_tpu/attacks/auxiliaries/initializations.py``).

Values live in the normalized space; shapes are NCHW. Draws come from the explicit
CPU generator and then move to the device.
"""

from __future__ import annotations

import torch


def init_candidate(generator, init_type: str, data_shape, dtype=torch.float32, device="cpu"):
    if init_type == "randn":
        x = torch.randn(data_shape, generator=generator, dtype=dtype)
    elif init_type == "randn-trunc":
        x = torch.clamp(torch.randn(data_shape, generator=generator, dtype=dtype) * 0.1, -0.1, 0.1)
    elif init_type == "rand":
        x = torch.rand(data_shape, generator=generator, dtype=dtype) * 2 - 1.0
    elif init_type == "zeros":
        x = torch.zeros(data_shape, dtype=dtype)
    else:
        raise NotImplementedError(f"Initialization {init_type} is not ported yet.")
    return x.to(device)
