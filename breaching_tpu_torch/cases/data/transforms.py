"""Config-driven data transforms, a copy of ``breaching_tpu/cases/data/transforms.py``
(reference _parse_data_augmentations, breaching/cases/data/datasets_vision.py:200-221).

The reference instantiates torchvision transforms by name from the
`augmentations_train` / `augmentations_val` config dicts. This numpy
counterpart supports the vocabulary the config tree actually uses —
RandomCrop(size, pad) / RandomHorizontalFlip(p) / RandomResizedCrop(size) /
Resize(short_side) / CenterCrop(size) — on float [0,1] HWC arrays, driven by
an explicit np.random.Generator so the victim's batch stays deterministic per
(dataset, split, index): reproducibility is seed-discipline here, not global
torch state (reference utils.py:159-167).
"""

from __future__ import annotations

import numpy as np


def _as_args(value):
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    from .datasets_vision import _bilinear_upsample

    if img.shape[:2] == (h, w):
        return img
    return _bilinear_upsample(img, h, w)


def _resize_short_side(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    scale = size / min(h, w)
    return _resize_bilinear(img, max(int(round(h * scale)), size),
                            max(int(round(w * scale)), size))


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top, left = max((h - size) // 2, 0), max((w - size) // 2, 0)
    return img[top:top + size, left:left + size]


def _random_crop(img: np.ndarray, size: int, pad: int, rng) -> np.ndarray:
    if pad:
        img = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top:top + size, left:left + size]


def _random_resized_crop(img: np.ndarray, size: int, rng) -> np.ndarray:
    """torchvision semantics: area scale U(0.08, 1), log-uniform aspect in
    [3/4, 4/3], 10 attempts then center-crop fallback."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return _resize_bilinear(img[top:top + ch, left:left + cw], size, size)
    return _resize_bilinear(_center_crop(_resize_short_side(img, size), size),
                            size, size)


def parse_data_augmentations(cfg_dict):
    """Build `transform(img, rng) -> img` from an augmentations config dict.
    Returns None when the dict is empty (the common validation-split case)."""
    if not cfg_dict or not hasattr(cfg_dict, "keys"):
        return None
    steps = []
    for key in cfg_dict.keys():
        args = _as_args(cfg_dict[key])
        if key == "RandomCrop":
            size, pad = int(args[0]), int(args[1]) if len(args) > 1 else 0
            steps.append(lambda img, rng, s=size, p=pad: _random_crop(img, s, p, rng))
        elif key == "RandomHorizontalFlip":
            p = float(args[0]) if args else 0.5
            steps.append(lambda img, rng, p=p:
                         img[:, ::-1] if rng.uniform() < p else img)
        elif key == "RandomResizedCrop":
            size = int(args[0])
            steps.append(lambda img, rng, s=size: _random_resized_crop(img, s, rng))
        elif key == "Resize":
            steps.append(lambda img, rng, s=int(args[0]): _resize_short_side(img, s))
        elif key == "CenterCrop":
            steps.append(lambda img, rng, s=int(args[0]): _center_crop(img, s))
        else:
            raise ValueError(f"Unsupported augmentation {key}; extend "
                             f"breaching_tpu_torch/cases/data/transforms.py.")
    if not steps:
        return None

    def transform(img, rng):
        for step in steps:
            img = step(img, rng)
        return np.ascontiguousarray(img)

    return transform
