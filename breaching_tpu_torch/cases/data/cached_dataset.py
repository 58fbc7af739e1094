"""RAM-cached dataset wrapper (counterpart of ``breaching_tpu/cases/data/cached_dataset.py``;
reference: breaching/cases/data/cached_dataset.py:9-54).

Materializes a dataset into contiguous numpy arrays once; afterwards ``__getitem__``
is an array slice, which pays off over repeated benchmark sweeps of the same users.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


class CachedDataset:
    def __init__(self, dataset):
        self.dataset = dataset
        self.name = getattr(dataset, "name", "dataset")
        self.mean = getattr(dataset, "mean", None)
        self.std = getattr(dataset, "std", None)
        self.classes = getattr(dataset, "classes", None)
        log.info(f"Caching {len(dataset)} examples of {self.name} into RAM...")
        first = dataset[0]
        self._cache = {key: np.empty((len(dataset), *np.asarray(val).shape), np.asarray(val).dtype)
                       for key, val in first.items()}
        for idx in range(len(dataset)):
            for key, val in dataset[idx].items():
                self._cache[key][idx] = val
        log.info("Dataset cached.")

    def __len__(self):
        return len(next(iter(self._cache.values())))

    def __getitem__(self, idx):
        return {key: arr[idx] for key, arr in self._cache.items()}

    @property
    def labels(self):
        return self._cache.get("labels")
