"""Dataloader factory, a copy of ``breaching_tpu/cases/data/data_preparation.py``
(reference: breaching/cases/data/data_preparation.py:17-73) for vision data.

Returns a lightweight numpy-batch loader over the user's partition. Batches are
dicts of host numpy arrays, images NCHW; the user moves them to its device.
"""

from __future__ import annotations

import numpy as np

from .datasets_vision import VisionDataset, split_dataset


class DataLoader:
    """Minimal deterministic batch iterator over a dataset producing dict batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.name = getattr(dataset, "name", "dataset")

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng(self.seed).permutation(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            samples = [self.dataset[int(i)] for i in chunk]
            yield {
                key: np.stack([s[key] for s in samples])
                for key in samples[0]
            }


def construct_dataloader(cfg_data, cfg_impl, user_idx: int = 0, return_full_dataset: bool = False):
    """Build the dataset for `user_idx` under the configured federated partition."""
    if cfg_data.modality == "vision":
        full = VisionDataset(cfg_data, split=cfg_data.examples_from_split)
        dataset = split_dataset(full, cfg_data, user_idx, return_full_dataset)
    else:
        raise NotImplementedError(f"Data modality {cfg_data.modality} is not ported yet.")

    return DataLoader(
        dataset,
        batch_size=min(int(cfg_data.batch_size), max(len(dataset), 1)),
        shuffle=bool(getattr(cfg_impl, "shuffle", False)),
    )
