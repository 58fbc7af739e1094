"""The port's ``LMDBDataset`` against the JAX package's, under a dict-backed stand-in for
the ``lmdb`` package (neither machine has it): the same length and the same items
(exactly: both pickle the dataset's numpy items) on the same synthetic vision split,
a rebuild under ``rebuild_existing_database``, and the same ``ImportError`` text where
the package is missing.
"""

import contextlib
import os
import sys
import types

import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.data.datasets_vision import VisionDataset as JaxVisionDataset
from breaching_tpu.cases.data.lmdb_datasets import LMDBDataset as JaxLMDBDataset
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.data.datasets_vision import VisionDataset
from breaching_tpu_torch.cases.data.lmdb_datasets import LMDBDataset

torch.set_num_threads(1)
OVERRIDES = ["case=1_single_image_small", "case.data.shape=[3, 16, 16]", "case.data.augmentations_train=None"]
ITEMS = 12


class _Transaction:
    def __init__(self, store, write, puts):
        self.store, self.write, self.puts = store, write, puts

    def put(self, key, value):
        assert self.write, "put in a read-only transaction"
        self.store[key] = value
        self.puts.append(key)

    def get(self, key):
        return self.store.get(key)


class _Environment:
    def __init__(self, store, puts):
        self.store, self.puts = store, puts
        self.closed = False

    @contextlib.contextmanager
    def begin(self, write=False):
        assert not self.closed
        yield _Transaction(self.store, write, self.puts)

    def close(self):
        self.closed = True


def _stand_in():
    """A module with ``lmdb``'s ``open``: one dict per database path, kept in the module,
    the path made a directory as lmdb makes it; every ``put`` recorded in ``puts``."""
    module = types.ModuleType("lmdb")
    module.stores, module.puts = {}, []

    def open_(path, readonly=False, **kwargs):
        os.makedirs(path, exist_ok=True)
        return _Environment(module.stores.setdefault(path, {}), module.puts)

    module.open = open_
    return module


@pytest.fixture
def lmdb(monkeypatch):
    module = _stand_in()
    monkeypatch.setitem(sys.modules, "lmdb", module)
    return module


def _datasets():
    jax_cfg = jax_breaching.get_config(OVERRIDES).case.data
    cfg = breaching.get_config(OVERRIDES).case.data
    jax_full = JaxVisionDataset(jax_cfg, split="validation")
    full = VisionDataset(cfg, split="validation")
    return jax_full.subset(np.arange(ITEMS)), full.subset(np.arange(ITEMS)), jax_cfg, cfg


def _db(cfg_data, path, rebuild=False):
    db = cfg_data.db
    db.path, db.rebuild_existing_database = str(path), rebuild
    return db


def test_both_packages_give_the_same_items(lmdb, tmp_path):
    jax_data, data, jax_cfg, cfg = _datasets()
    jax_db = JaxLMDBDataset(jax_data, _db(jax_cfg, tmp_path / "jax"))
    db = LMDBDataset(data, _db(cfg, tmp_path / "port"))
    assert len(db) == len(jax_db) == ITEMS
    assert db.name == jax_db.name
    np.testing.assert_array_equal(db.mean, jax_db.mean)
    np.testing.assert_array_equal(db.std, jax_db.std)
    for i in range(ITEMS):
        got, want = db[i], jax_db[i]
        assert set(got) == set(want) == {"inputs", "labels"}
        # the port's items are CHW, the JAX package's HWC: the same float32 values
        np.testing.assert_array_equal(got["inputs"], np.transpose(want["inputs"], (2, 0, 1)))
        assert int(got["labels"]) == int(want["labels"])
        # and each is what its own dataset gives, through pickle
        np.testing.assert_array_equal(got["inputs"], data[i]["inputs"])


def test_an_existing_database_is_reused_and_rebuilt_on_request(lmdb, tmp_path):
    _, data, _, cfg = _datasets()
    LMDBDataset(data, _db(cfg, tmp_path))
    assert len(lmdb.puts) == ITEMS + 1  # the items and the length
    LMDBDataset(data, _db(cfg, tmp_path))
    assert len(lmdb.puts) == ITEMS + 1  # opened, not built again
    db = LMDBDataset(data.subset(np.arange(5)), _db(cfg, tmp_path, rebuild=True))
    assert len(lmdb.puts) == ITEMS + 1 + 5 + 1  # rebuilt from the 5-item dataset
    assert len(db) == 5


def test_without_the_package_both_raise_the_same_import_error(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # import lmdb raises ImportError
    jax_data, data, jax_cfg, cfg = _datasets()
    with pytest.raises(ImportError) as jax_error:
        JaxLMDBDataset(jax_data, _db(jax_cfg, tmp_path))
    with pytest.raises(ImportError) as error:
        LMDBDataset(data, _db(cfg, tmp_path))
    assert str(error.value) == str(jax_error.value)
    assert "lmdb" in str(error.value)
