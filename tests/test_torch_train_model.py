"""The port's trainer (``breaching_tpu_torch/train_model.py``) and its checkpoint layout
against the JAX package's (``tools/train_model.py``), on the CPU at small sizes.

- ``dump_flat_state`` gives the JAX package's keys and arrays, bit for bit, for the same
  weights carried over by the bridge (``load_flat_state``), and both packages load each
  other's dump strictly: ConvNetSmall16, a BatchNorm ResNet-20, a GroupNorm ResNet-20
  and a tiny ``transformer3``.
- ``_apply_res`` gives the JAX package's data config; ``_materialize_vision`` its uint8
  bytes (NCHW against NHWC) and labels exactly.
- ``train()`` against ``tools.train_model.train`` from the same weights: the JAX
  package's fresh model written to an npz, both trainers resumed from copies of it, 1
  epoch of 64 examples in batches of 32 (2 steps). SGD and AdamW on ConvNetSmall16 at
  3x16x16, the device augmentation with mixup 0.4 on the JAX package's draws (replayed
  from its ``PRNGKey(epoch)`` schedule), SGD on the BatchNorm ConvNet8 (its statistics
  recalibrated), and the loader path on a tiny ``transformer3``. Every parameter and
  buffer is held to 1e-5 of its leaf's largest entry (measured at most 8.9e-8 on SGD,
  the augmented run and ConvNetSmall16's, 5.5e-7 on the text model), the count of
  batches exactly, and the epoch's mean loss to the JAX package's printed four
  decimals (5e-5 and 1e-5 of the loss). Two runs are coarser than that in float32 on
  either side, so both packages are held to the port's float64 run there: AdamW's
  first steps divide small gradients by their own magnitude (JAX 3.4e-5 from float64,
  the port's float32 6.5e-5; held to 3e-4), and BatchNorm's batch variance E[x^2] -
  E[x]^2 cancels on the smooth synthetic images (JAX 1.36e-3, the port's float32
  1.8e-4; held to 5e-3).
- The JAX package loads a port-trained npz and gives the same logits (1e-5 of the
  largest; measured 1.35e-7).
- The six checks of ``tests/test_train_model.py`` on the port's trainer, from the JAX
  test's initial weights: a checkpoint with parameters, a falling loss, the pretrained path loads it, the warning without
  one, the fit on its own split beats chance (> 0.2), a resumed epoch at lr 0 keeps
  the weights (1e-6), and the repo's assets fallback (``model_preparation.REPO``
  monkeypatched to a temporary directory: nothing is written into the checkout).
- ``train()`` without ``device="cpu"`` raises where there is no card.
"""

import contextlib
import io
import logging
import os
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.models.model_preparation import construct_model as jax_construct_model
from breaching_tpu.cases.models.model_preparation import load_flat_state as jax_load_flat_state
import breaching_tpu_torch as breaching
from breaching_tpu_torch import train_model
from breaching_tpu_torch.cases.models import model_preparation
from breaching_tpu_torch.cases.models.model_preparation import construct_model, dump_flat_state, load_flat_state

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import train_model as jax_train_model  # noqa: E402

torch.set_num_threads(1)
VISION = ["case=1_single_image_small", "case.data.shape=[3, 16, 16]", "case.data.augmentations_train=None"]
TEXT = ["case=10_causal_lang_training", "case.data.vocab_size=128", "case.data.shape=[8]"]
STEP_TOL = 1e-5  # of each leaf's largest entry
# the runs whose float32 steps lie farther than STEP_TOL from float64 on both sides: both
# packages are held to the port's float64 run, at these fractions of each leaf's largest entry
F64_TOL = {"adamw": 3e-4, "batchnorm_sgd": 5e-3}
LOGITS_TOL = 1e-5


def _configs(overrides, path):
    """The JAX package's and the port's config of the same case, data under ``path``."""
    overrides = overrides + [f"case.data.path={path}"]
    return jax_breaching.get_config(overrides), breaching.get_config(overrides)


def _close_leaves(got: dict, want: dict, tol):
    """Every key of ``want`` in ``got`` within ``tol`` of the leaf's largest entry; the
    largest relative distance."""
    assert set(got) == set(want)
    worst = 0.0
    for key, value in want.items():
        scale = max(float(np.abs(value).max()), 1e-30)
        err = float(np.abs(np.asarray(got[key], np.float64) - value).max())
        assert err <= tol * scale, f"{key}: {err} > {tol} * {scale}"
        worst = max(worst, err / scale)
    return worst


@pytest.mark.parametrize("name,overrides", [
    ("ConvNetSmall16", VISION), ("resnet20", VISION), ("resnetgn20", VISION), ("transformer3", TEXT)])
def test_dump_flat_state_is_the_jax_layout_both_ways(name, overrides, tmp_path):
    jax_cfg, cfg = _configs(overrides, tmp_path)
    jax_model, _ = jax_construct_model(name, jax_cfg.case.data, key=jax.random.PRNGKey(3))
    want = jax_train_model.dump_flat_state(jax_model)
    port, _ = construct_model(name, cfg.case.data)
    assert load_flat_state(port, want, strict=True) == len(want)
    got = dump_flat_state(port)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the port's own draw through the JAX package and back
    fresh, _ = construct_model(name, cfg.case.data, generator=torch.Generator().manual_seed(5))
    dumped = dump_flat_state(fresh)
    other, _ = jax_construct_model(name, jax_cfg.case.data, key=jax.random.PRNGKey(4))
    assert jax_load_flat_state(other, dumped, strict=True) == len(dumped)
    back = jax_train_model.dump_flat_state(other)
    for key in dumped:
        np.testing.assert_array_equal(back[key], dumped[key], err_msg=key)


@pytest.mark.parametrize("case", ["1_single_image_small", "2_single_imagenet", "5_small_batch_imagenet"])
def test_apply_res_gives_the_jax_config(case):
    jax_cfg = jax_breaching.get_config([f"case={case}"]).case.data
    cfg = breaching.get_config([f"case={case}"]).case.data
    jax_train_model._apply_res(jax_cfg, 112)
    train_model._apply_res(cfg, 112)
    keys = ("shape", "augmentations_train", "augmentations_val")
    assert {k: cfg.to_dict()[k] for k in keys} == {k: jax_cfg.to_dict()[k] for k in keys}
    assert cfg.shape == [3, 112, 112]


def test_materialize_vision_gives_the_jax_bytes(tmp_path):
    from breaching_tpu.cases.data.data_preparation import construct_dataloader as jax_loader

    from breaching_tpu_torch.cases.data.data_preparation import construct_dataloader

    jax_cfg, cfg = _configs(["case=1_single_image_small"], tmp_path)
    for c in (jax_cfg, cfg):  # the training split with its config augmentations, at 16x16
        c.case.data.examples_from_split, c.case.data.partition = "training", "none"
    jax_train_model._apply_res(jax_cfg.case.data, 16)
    train_model._apply_res(cfg.case.data, 16)
    jax_data = jax_loader(jax_cfg.case.data, jax_cfg.case.impl, 0, return_full_dataset=True).dataset
    data = construct_dataloader(cfg.case.data, cfg.case.impl, 0, return_full_dataset=True).dataset
    with contextlib.redirect_stdout(io.StringIO()):
        want_imgs, want_labels = jax_train_model._materialize_vision(jax_data.subset(np.arange(48)))
        imgs, labels = train_model._materialize_vision(data.subset(np.arange(48)))
    assert imgs.dtype == np.uint8 and imgs.shape == (48, 3, 16, 16)
    np.testing.assert_array_equal(imgs, np.transpose(want_imgs, (0, 3, 1, 2)))
    np.testing.assert_array_equal(labels, want_labels)


def _jax_draws(epoch, steps, batch, pad, mixup):
    """The JAX trainer's draws of one epoch, as its ``run_epoch`` makes them: a key per
    step from ``PRNGKey(epoch)``, the flips and offsets from its two halves, the Beta
    value from the key folded with 1."""
    draws = []
    for k in jax.random.split(jax.random.PRNGKey(epoch), steps):
        kf, ks = jax.random.split(k)
        flips = np.asarray(jax.random.bernoulli(kf, shape=(batch,)))
        offsets = np.asarray(jax.random.randint(ks, (batch, 2), 0, 2 * pad + 1))
        beta = np.asarray(jax.random.beta(jax.random.fold_in(k, 1), mixup, mixup)) if mixup > 0 else None
        draws.append((torch.tensor(flips), torch.tensor(offsets).long(),
                      None if beta is None else torch.tensor(float(beta))))
    return draws


def _printed_losses(text):
    return [float(x) for x in re.findall(r"epoch \d+/\d+: loss ([0-9.]+)", text)]


TRAINERS = {  # name -> (model, case overrides, train.* settings)
    "sgd": ("ConvNetSmall16", VISION, dict(optimizer="sgd", lr=0.05)),
    "adamw": ("ConvNetSmall16", VISION, dict(optimizer="adamw", lr=1e-3, weight_decay=1e-2)),
    "device_aug_mixup": ("ConvNetSmall16", VISION, dict(optimizer="sgd", lr=0.05, device_aug=1, mixup=0.4)),
    "batchnorm_sgd": ("ConvNet8", VISION, dict(optimizer="sgd", lr=0.05)),
    "loader_text": ("transformer3", TEXT, dict(optimizer="sgd", lr=0.05, batch_size=16)),
}


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_train_matches_the_jax_trainer_from_the_same_weights(trainer, tmp_path, monkeypatch):
    name, overrides, settings = TRAINERS[trainer]
    jax_cfg, cfg = _configs(overrides + [f"case.model={name}"], tmp_path / "data")
    jax_model, _ = jax_construct_model(name, jax_cfg.case.data)
    start = jax_train_model.dump_flat_state(jax_model)
    jax_out, out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    np.savez(jax_out, **start)
    shutil.copy(jax_out, out)
    tr = dict(jax_train_model.TRAIN_DEFAULTS, epochs=1, limit=64, batch_size=32, eval_batches=1, resume=1)
    tr.update(settings)
    if tr["device_aug"] or tr["mixup"]:
        draws = iter(_jax_draws(0, 2, 32, 2, tr["mixup"]))
        monkeypatch.setattr(train_model, "draw_augmentation", lambda *args: next(draws))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        jax_train_model.train(jax_cfg, dict(tr, out=jax_out))
    result = train_model.train(cfg, dict(tr, out=out), device="cpu")
    if tr["device_aug"] or tr["mixup"]:
        assert next(draws, None) is None  # one draw a step, every draw taken
    want, got = dict(np.load(jax_out)), dict(np.load(out))
    assert any(not np.array_equal(want[k], start[k]) for k in want if k.startswith("params/"))
    if trainer in F64_TOL:
        out64 = str(tmp_path / "port64.npz")
        np.savez(out64, **start)
        cfg64 = breaching.get_config(overrides + [f"case.model={name}", f"case.data.path={tmp_path / 'data'}",
                                                  "case.impl.dtype=float64"])
        train_model.train(cfg64, dict(tr, out=out64), device="cpu")
        reference = dict(np.load(out64))
        assert all(reference[k].dtype == np.float64 for k in reference)
        worst = _close_leaves(want, reference, F64_TOL[trainer])
        ours = _close_leaves(got, reference, F64_TOL[trainer])
        print(f"{trainer}: the JAX package {worst:.3g} and the port {ours:.3g} from the port's float64 run")
        worst = max(worst, ours)
    else:
        worst = _close_leaves(got, want, STEP_TOL)
    for key in (k for k in want if k.endswith("num_batches_tracked")):
        assert got[key] == want[key] == 2, key  # recalibrated over both batches
    (jax_loss,), (epoch,) = _printed_losses(printed.getvalue()), result["epochs"]
    assert abs(epoch["loss"] - jax_loss) <= 5e-5 + 1e-5 * abs(jax_loss)
    print(f"{trainer}: largest distance {worst:.3g} of a leaf's largest entry; loss {epoch['loss']:.6f} "
          f"(JAX {jax_loss:.4f})")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's counterpart of ``tests/test_train_model.py``'s fixture: 2 epochs on 256
    examples of ConvNetSmall16 at 16x16, written to an explicit ``out``, from the weights
    the JAX test trains (the JAX package's init from its default key 0, resumed): how far
    16 steps get depends on the draw, and from other initial weights either trainer can
    stay under the check's 0.2; from key 0 the port reaches 0.328 on the split's first 64
    images, as the JAX trainer does."""
    data_dir, out_dir = tmp_path_factory.mktemp("data"), tmp_path_factory.mktemp("ckpt")
    cfg = breaching.get_config(VISION + ["case.model=ConvNetSmall16", "case.data.classes=10",
                                         f"case.data.path={data_dir}"])
    out = str(out_dir / "ConvNetSmall16.npz")
    jax_model, _ = jax_construct_model("ConvNetSmall16", jax_breaching.get_config(VISION).case.data)
    np.savez(out, **jax_train_model.dump_flat_state(jax_model))
    tr = dict(train_model.TRAIN_DEFAULTS, epochs=2, batch_size=32, limit=256, lr=0.05, eval_batches=2, out=out,
              resume=1)
    result = train_model.train(cfg, tr, device="cpu")
    return cfg, result


def test_training_writes_a_checkpoint_and_reduces_the_loss(trained):
    _, result = trained
    assert os.path.exists(result["out"])
    flat = dict(np.load(result["out"]))
    assert any(k.startswith("params/") for k in flat)
    first, second = (epoch["loss"] for epoch in result["epochs"])
    assert second < first


def test_checkpoint_loads_via_pretrained_path(trained):
    cfg, result = trained
    ckpt_dir = os.path.expanduser(os.path.join(str(cfg.case.data.path), "checkpoints"))
    os.makedirs(ckpt_dir, exist_ok=True)
    staged = os.path.join(ckpt_dir, "ConvNetSmall16.npz")
    shutil.copy(result["out"], staged)
    try:
        fresh, _ = construct_model("ConvNetSmall16", cfg.case.data)
        loaded, _ = construct_model("ConvNetSmall16", cfg.case.data, pretrained=True)
        flat = dict(np.load(result["out"]))
        flat_loaded, flat_fresh = dump_flat_state(loaded), dump_flat_state(fresh)
        assert all(np.array_equal(flat_loaded[k], flat[k]) for k in flat)
        assert any(not np.allclose(flat_fresh[k], flat[k]) for k in flat if k.startswith("params/"))
    finally:
        os.remove(staged)


def test_pretrained_without_checkpoint_warns(trained, caplog):
    cfg, _ = trained
    with caplog.at_level(logging.WARNING):
        construct_model("ConvNetSmall16", cfg.case.data, pretrained=True)
    assert any("keeping random init" in r.message for r in caplog.records)


def test_trained_model_fits_train_split(trained):
    from breaching_tpu_torch.cases.data.data_preparation import construct_dataloader

    cfg, result = trained
    model, _ = construct_model("ConvNetSmall16", cfg.case.data)
    load_flat_state(model, dict(np.load(result["out"])), strict=True)
    cfg.case.data.examples_from_split, cfg.case.data.partition, cfg.case.data.batch_size = "training", "none", 64
    batch = next(iter(construct_dataloader(cfg.case.data, cfg.case.impl, 0, return_full_dataset=True)))
    acc = float(train_model.score(model, torch.from_numpy(batch["inputs"]).float(), torch.from_numpy(batch["labels"])))
    assert acc > 0.2, f"trained model at chance level ({acc:.3f})"
    print(f"accuracy on the training split's first 64 images: {acc:.3f}")


def test_the_jax_package_loads_a_port_trained_checkpoint(trained):
    cfg, result = trained
    flat = dict(np.load(result["out"]))
    jax_cfg = jax_breaching.get_config(VISION + ["case.model=ConvNetSmall16"])
    jax_model, _ = jax_construct_model("ConvNetSmall16", jax_cfg.case.data, key=jax.random.PRNGKey(1))
    assert jax_load_flat_state(jax_model, flat, strict=True) == len(flat)
    model, _ = construct_model("ConvNetSmall16", cfg.case.data)
    load_flat_state(model, flat, strict=True)
    x = np.random.default_rng(0).normal(size=(8, 16, 16, 3)).astype(np.float32)
    want, _ = jax_model.apply(jax_model.params, jax_model.buffers, jax.numpy.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGITS_TOL * float(np.abs(want).max()), err
    print(f"logits of a port-trained checkpoint in both packages: {err / float(np.abs(want).max()):.3g} of the largest")


def test_resume_continues_from_checkpoint(trained):
    """train.resume=1 starts from the saved weights: a resumed epoch at lr 0 and no
    weight decay keeps them."""
    cfg, result = trained
    before = dict(np.load(result["out"]))
    tr = dict(train_model.TRAIN_DEFAULTS, epochs=1, batch_size=32, limit=64, lr=0.0, eval_batches=0,
              out=result["out"], resume=1, weight_decay=0.0, momentum=0.0)
    train_model.train(cfg, tr, device="cpu")
    after = dict(np.load(result["out"]))
    for k in before:
        if k.startswith("params/"):
            np.testing.assert_allclose(after[k], before[k], atol=1e-6, err_msg=k)


def test_checkpoint_loads_via_assets_fallback(trained, tmp_path, monkeypatch):
    """Without ``<data.path>/checkpoints/<name>.npz`` the pretrained path falls back to
    ``<repo>/assets/checkpoints/``; the repo is a temporary directory here."""
    cfg, result = trained
    monkeypatch.setattr(model_preparation, "REPO", str(tmp_path))
    os.makedirs(tmp_path / "assets" / "checkpoints")
    shutil.copy(result["out"], tmp_path / "assets" / "checkpoints" / "ConvNetSmall16.npz")
    loaded, _ = construct_model("ConvNetSmall16", cfg.case.data, pretrained=True)
    flat, flat_loaded = dict(np.load(result["out"])), dump_flat_state(loaded)
    assert all(np.array_equal(flat_loaded[k], flat[k]) for k in flat)


def test_train_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    cfg = breaching.get_config(VISION + ["case.model=ConvNetSmall16", f"case.data.path={tmp_path}"])
    with pytest.raises(RuntimeError, match="No CUDA device"):
        train_model.train(cfg, dict(train_model.TRAIN_DEFAULTS, epochs=1, limit=32, batch_size=32))
    assert not os.path.exists(tmp_path / "checkpoints")


def test_main_refuses_an_unknown_train_key():
    with pytest.raises(SystemExit, match="Unknown train key 'epoch'"):
        train_model.main(["case=1_single_image_small", "train.epoch=1"])
