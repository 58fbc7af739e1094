"""LMDB-backed dataset cache, a copy of ``breaching_tpu/cases/data/lmdb_datasets.py``
(reference: breaching/cases/data/lmdb_datasets.py:22-217).

Optional: it needs the ``lmdb`` package, imported when a dataset is built;
construction raises ``ImportError`` where it is missing. As in the JAX package,
``construct_dataloader`` never wraps a dataset in it (``data.db=LMDB`` only names its
settings).
"""

from __future__ import annotations

import logging
import os
import pickle

log = logging.getLogger(__name__)


class LMDBDataset:
    """Wraps (and lazily builds) an LMDB database of a dataset's samples."""

    def __init__(self, dataset, cfg_db, name: str = "train", can_create: bool = True):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("LMDBDataset requires the optional `lmdb` package; use data.db=none "
                              "in this environment.") from e

        self.dataset = dataset
        self.name = getattr(dataset, "name", "dataset")
        self.mean = getattr(dataset, "mean", None)
        self.std = getattr(dataset, "std", None)
        path = os.path.expanduser(os.path.join(str(cfg_db.path), f"{self.name}_{name}.lmdb"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if (not os.path.exists(path) or cfg_db.get("rebuild_existing_database")) and can_create:
            self._build(path, dataset)
        self.env = lmdb.open(path, readonly=True, lock=False, readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.length = pickle.loads(txn.get(b"__len__"))

    @staticmethod
    def _build(path, dataset):
        import lmdb

        log.info(f"Building LMDB database at {path} with {len(dataset)} samples...")
        env = lmdb.open(path, map_size=1 << 40)
        with env.begin(write=True) as txn:
            for idx in range(len(dataset)):
                txn.put(f"{idx}".encode(), pickle.dumps(dataset[idx]))
            txn.put(b"__len__", pickle.dumps(len(dataset)))
        env.close()

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        with self.env.begin(write=False) as txn:
            return pickle.loads(txn.get(f"{int(idx)}".encode()))
