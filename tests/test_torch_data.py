"""The port's data pipeline against the JAX package's: the same synthetic images and
labels, bit for bit, after the one NHWC -> NCHW transpose."""

import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.data.datasets_vision import VisionDataset as JaxVisionDataset
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.data.datasets_vision import VisionDataset

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["1_single_image_small", "2_single_imagenet"])
@pytest.mark.parametrize("user_idx", [0, 1, 2, 3])
def test_user_batches_match_bit_for_bit(case, user_idx):
    overrides = [f"case={case}", f"case.user.user_idx={user_idx}"]
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    loader = breaching.cases.construct_dataloader(cfg.case.data, cfg.case.impl, user_idx=user_idx)
    jax_loader = jax_breaching.cases.construct_dataloader(jax_cfg.case.data, jax_cfg.case.impl,
                                                          user_idx=user_idx)
    assert len(loader) == len(jax_loader)
    batch, jax_batch = next(iter(loader)), next(iter(jax_loader))
    np.testing.assert_array_equal(batch["labels"], jax_batch["labels"])
    assert batch["inputs"].shape[1:] == tuple(cfg.case.data.shape)
    np.testing.assert_array_equal(batch["inputs"], np.transpose(jax_batch["inputs"], (0, 3, 1, 2)))


def test_augmented_training_samples_match():
    """The training split runs RandomCrop + RandomHorizontalFlip before normalization."""
    cfg = breaching.get_config(["case=1_single_image_small"]).case.data
    jax_cfg = jax_breaching.get_config(["case=1_single_image_small"]).case.data
    ds, jax_ds = VisionDataset(cfg, "training"), JaxVisionDataset(jax_cfg, "training")
    assert ds.transform is not None
    for idx in (0, 7, 123):
        np.testing.assert_array_equal(ds[idx]["inputs"], np.transpose(jax_ds[idx]["inputs"], (2, 0, 1)))
        assert ds[idx]["labels"] == jax_ds[idx]["labels"]


def test_user_update_data_reaches_the_model_in_nchw():
    cfg = breaching.get_config(["case=1_single_image_small", "case.model=ConvNet4", "seed=0"])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    _, true_user_data = user.compute_local_updates(server.distribute_payload())
    assert tuple(true_user_data["data"].shape) == (1, 3, 32, 32)
    assert true_user_data["data"].dtype == torch.float32
