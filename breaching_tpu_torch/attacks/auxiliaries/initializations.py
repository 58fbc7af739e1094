"""Candidate initialization (counterpart of ``breaching_tpu/attacks/auxiliaries/initializations.py``).

Values live in the normalized space; shapes are NCHW, with any leading axes (trials)
before N. Draws come from the explicit CPU generator and then move to the device.

- ``randn``, ``randn-trunc`` (clipped to 0.1), ``rand`` (uniform in [-1, 1)), ``zeros``;
- a colour (``red``, ``green``, ``blue``, ``dark``, ``light``): zeros with that channel
  at 1 (``dark`` all 0, ``light`` all 1), with ``-true`` taken through the data's
  normalization (x - mean) / std;
- ``patterned-N`` (``wei`` too): one N x N tile per image, normal (uniform in [-1, 1)
  for ``patterned-rand-N``), repeated over the image and cut to its size; N is 4
  when the name has no digits.
A text candidate, embeddings (..., T, D) (``text=True``), takes only ``randn``,
``randn-trunc``, ``rand`` and ``zeros``.
"""

from __future__ import annotations

import torch


def tile_pattern(seed: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Repeat the (..., C, w, w) tiles of ``seed`` over (height, width) and cut them to it."""
    w = seed.shape[-1]
    reps = (1,) * (seed.dim() - 2) + (-(-height // w), -(-width // w))
    return seed.repeat(reps)[..., :height, :width]


def init_candidate(generator, init_type: str, data_shape, dtype=torch.float32, device="cpu",
                   mean=None, std=None, text=False):
    """A candidate of ``data_shape`` (..., C, H, W), or with ``text`` (..., T, D), drawn in
    float32 and cast to ``dtype``; ``mean`` and ``std`` (C,) are the data's normalization,
    read by the ``-true`` colours."""
    if text and init_type not in ("randn", "randn-trunc", "rand", "zeros"):
        raise ValueError(f"Initialization {init_type} undefined for shape {tuple(data_shape)}.")
    if len(data_shape) < 4 and not text:
        raise ValueError(f"Image candidates are (..., C, H, W), not {tuple(data_shape)}.")
    # a candidate of another floating type is drawn in float32 and cast: the float32 run's start
    target, dtype = dtype, torch.float32
    if init_type == "randn":
        x = torch.randn(data_shape, generator=generator, dtype=dtype)
    elif init_type == "randn-trunc":
        x = torch.clamp(torch.randn(data_shape, generator=generator, dtype=dtype) * 0.1, -0.1, 0.1)
    elif init_type == "rand":
        x = torch.rand(data_shape, generator=generator, dtype=dtype) * 2 - 1.0
    elif init_type == "zeros":
        x = torch.zeros(data_shape, dtype=dtype)
    elif any(color in init_type for color in ("red", "green", "blue", "dark", "light")):
        x = torch.ones(data_shape, dtype=dtype) if "light" in init_type else torch.zeros(data_shape, dtype=dtype)
        if "light" not in init_type and "dark" not in init_type:
            x[..., 0 if "red" in init_type else 1 if "green" in init_type else 2, :, :] = 1.0
        if "-true" in init_type and mean is not None:
            shape = (-1, 1, 1)
            x = (x - mean.to(dtype).cpu().reshape(shape)) / std.to(dtype).cpu().reshape(shape)
    elif "patterned" in init_type or "wei" in init_type:
        width = int("".join(filter(str.isdigit, init_type)) or "4")
        seed_shape = (*data_shape[:-2], width, width)
        if "rand" in init_type and "randn" not in init_type:
            seed = torch.rand(seed_shape, generator=generator, dtype=dtype) * 2 - 1
        else:
            seed = torch.randn(seed_shape, generator=generator, dtype=dtype)
        x = tile_pattern(seed, *data_shape[-2:])
    else:
        raise NotImplementedError(f"Initialization {init_type} is not ported yet.")
    return x.to(device=device, dtype=target)
