"""Train a case's model on the case's own training split and save it as a checkpoint
npz that ``case.server.pretrained=True`` loads.

Counterpart of the JAX package's ``tools/train_model.py``, with its ``train.*`` keys
and defaults. The checkpoint goes to ``<case.data.path>/checkpoints/<model>.npz`` (or
``train.out``) in the JAX package's flat layout (``model_preparation.dump_flat_state``),
so either package loads what the other trained. Runs on the card; ``train(cfg, tr,
device="cpu")`` runs on the CPU.

    python3 -m breaching_tpu_torch.train_model case=1_single_image_small train.epochs=10 train.lr=0.05
    python3 -m breaching_tpu_torch.simulate_breach case=1_single_image_small \\
        attack=invertinggradients case.server.pretrained=True

train.* keys (consumed here, not part of the case config):
    epochs (10), lr (0.1), batch_size (128), weight_decay (5e-4), momentum (0.9),
    optimizer (sgd: Nesterov momentum after decayed weights | adamw), both on optax's
    closed-form cosine decay over epochs x ceil(examples / batch) steps; limit (cap on
    training examples, 0 = all); eval_batches (validation batches scored each epoch);
    out (an explicit output path); res (train at a reduced square resolution, 0 = the
    case's shape); resume (continue from the output file: its weights and statistics,
    a fresh optimizer, the schedule from its start); materialize (vision: the whole
    split on the card as uint8, normalized there, each epoch a permutation of it in
    full batches); device_aug (with materialize: a random flip and an edge-padded
    shifted crop per image and epoch, drawn on the card); mixup (with materialize: the
    Beta(a, a) parameter of mixup of each batch with itself reversed, 0 = off).

The model trains in float32, as the JAX package's trainer does, or in float64 under
``case.impl.dtype=float64`` (the port's other entry points' model type), which the
checks of float32 rounding compare against.

Every epoch ends by recalibrating BatchNorm: its statistics are reset to the fresh
model's and averaged over the first min(16, steps) training batches under the trained
weights; then the checkpoint is written.
"""

from __future__ import annotations

import copy
import os
import sys
import time

import numpy as np
import torch

from . import get_config
from .attacks.auxiliaries.optimizers import make_schedule
from .cases.data.data_preparation import construct_dataloader
from .cases.models.model_preparation import _flat_entries, construct_model, dump_flat_state, load_flat_state
from .utils import system_startup

TRAIN_DEFAULTS = dict(epochs=10, lr=0.1, batch_size=128, weight_decay=5e-4, momentum=0.9, optimizer="sgd", limit=0,
                      eval_batches=8, out="", res=0, resume=0, materialize=1, device_aug=0, mixup=0.0)
RECALIBRATION_BATCHES = 16


def _batch_arrays(batch, modality, device, dtype=torch.float32):
    inputs = torch.as_tensor(batch["input_ids" if modality == "text" else "inputs"], device=device)
    if inputs.is_floating_point():
        inputs = inputs.to(dtype)
    return inputs, torch.as_tensor(batch["labels"], device=device).long()


def _materialize_vision(dataset) -> tuple[np.ndarray, np.ndarray]:
    """The whole (lazy) vision split generated once as uint8 [0, 255] NCHW and its
    labels: the dataset's normalization inverted, times 255, rounded and clipped. The
    config's augmentations are seeded per image, the same every epoch, so training on
    these frozen arrays is the same run as drawing the items anew."""
    n = len(dataset)
    sample = dataset[0]["inputs"]
    imgs = np.empty((n,) + sample.shape, np.uint8)
    labels = np.empty((n,), np.int64)
    mean, std = dataset.mean.reshape(-1, 1, 1), dataset.std.reshape(-1, 1, 1)
    began = time.time()
    for i in range(n):
        item = dataset[i]
        raw = item["inputs"] * std + mean
        imgs[i] = np.clip(np.rint(raw * 255.0), 0, 255).astype(np.uint8)
        labels[i] = item["labels"]
    print(f"Materialized {n} images in {time.time() - began:.0f}s.", flush=True)
    return imgs, labels


def _apply_res(cfg_data, res: int) -> None:
    """Scale the data config to a reduced square training resolution."""
    cfg_data.shape = [int(cfg_data.shape[0]), res, res]
    for aug_key in ("augmentations_train", "augmentations_val"):
        aug = cfg_data.get(aug_key)
        if not aug:
            continue
        for name in list(aug.keys()):
            if name in ("RandomResizedCrop", "CenterCrop"):
                aug[name] = res
            elif name == "Resize":
                aug[name] = round(res * 256 / 224)
            elif name == "RandomCrop":
                pad = aug[name][1] if isinstance(aug[name], (list, tuple)) else 0
                aug[name] = [res, pad]


def make_optimizer(model, tr) -> torch.optim.Optimizer:
    """optax's ``adamw`` or ``chain(add_decayed_weights, sgd(nesterov=True))``, one group
    over every parameter (norms included, as ``add_decayed_weights`` decays every leaf);
    the step size is set before each step from the schedule."""
    params, decay = list(model.parameters()), float(tr["weight_decay"])
    if str(tr["optimizer"]) == "adamw":
        return torch.optim.AdamW(params, lr=float(tr["lr"]), betas=(0.9, 0.999), eps=1e-8, weight_decay=decay)
    momentum = float(tr["momentum"])
    return torch.optim.SGD(params, lr=float(tr["lr"]), momentum=momentum, nesterov=momentum > 0,
                           weight_decay=decay)


def train_step(model, loss_fn, optimizer, lr, inputs, labels, lam=None) -> torch.Tensor:
    """One step on the task loss in train mode (BatchNorm's running statistics advance);
    with ``lam`` the mixup loss lam CE(y) + (1 - lam) CE(y reversed). The loss, on the
    model's device."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    logits = model(inputs, train=True)
    if lam is None:
        loss = loss_fn(logits, labels)
    else:
        loss = lam * loss_fn(logits, labels) + (1 - lam) * loss_fn(logits, labels.flip(0))
    loss.backward()
    optimizer.step()
    return loss.detach()


def draw_augmentation(batch: int, pad: int, mixup: float, generator: torch.Generator):
    """One step's draws on the generator's device: a flip per image, a (row, column)
    offset per image in [0, 2 pad], and with ``mixup`` a Beta(mixup, mixup) value (else
    None)."""
    device = generator.device
    flips = torch.rand(batch, generator=generator, device=device) < 0.5
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=generator, device=device)
    beta = None
    if mixup > 0:
        gammas = torch._standard_gamma(torch.full((2,), mixup, device=device), generator=generator)
        beta = gammas[0] / gammas.sum()
    return flips, offsets, beta


def augment(x_u8: torch.Tensor, flips: torch.Tensor, offsets: torch.Tensor, pad: int) -> torch.Tensor:
    """Flip the images where ``flips`` says so, pad them by ``pad`` with their edge
    values and crop them back to their size at ``offsets``: one gather of uint8 NCHW."""
    n, _, h, w = x_u8.shape
    rows = (torch.arange(h, device=x_u8.device) + offsets[:, :1] - pad).clamp(0, h - 1)
    cols = (torch.arange(w, device=x_u8.device) + offsets[:, 1:] - pad).clamp(0, w - 1)
    cols = torch.where(flips[:, None], w - 1 - cols, cols)
    images = torch.arange(n, device=x_u8.device)[:, None, None]
    return x_u8[images, :, rows[:, :, None], cols[:, None, :]].permute(0, 3, 1, 2)


@torch.no_grad()
def score(model, inputs, labels) -> torch.Tensor:
    """Accuracy in eval mode: next-token accuracy for a causal LM's (B, T, V) logits,
    argmax accuracy otherwise."""
    logits = model(inputs, train=False)
    if logits.dim() == 3:
        hits = logits[:, :-1].argmax(-1) == labels[:, 1:]
    else:
        hits = logits.argmax(-1) == labels
    return hits.float().mean()


class DeviceSplit:
    """A materialized vision split on the device: uint8 NCHW images and their labels,
    normalized on the device in the model's type."""

    def __init__(self, imgs: np.ndarray, labels: np.ndarray, mean, std, dtype, device):
        self.data = torch.as_tensor(imgs, device=device)
        self.labels = torch.as_tensor(labels, device=device)
        self.dtype = dtype
        self.mean = torch.as_tensor(mean, dtype=dtype, device=device).reshape(1, -1, 1, 1)
        self.std = torch.as_tensor(std, dtype=dtype, device=device).reshape(1, -1, 1, 1)
        self.pad = max(int(imgs.shape[2]) // 16, 2)  # of the shifted crop

    def __len__(self):
        return len(self.labels)

    def norm(self, x_u8: torch.Tensor) -> torch.Tensor:
        return (x_u8.to(self.dtype) / 255.0 - self.mean) / self.std


def materialized_epoch(model, loss_fn, optimizer, schedule, step: int, split: DeviceSplit, idxs: torch.Tensor,
                       device_aug: bool, mixup: float, generator: torch.Generator):
    """One epoch over ``split`` in the batches ``idxs`` (steps, batch), from schedule
    step ``step``: each batch augmented on the device (``device_aug``) and mixed with
    itself reversed (``mixup``), from ``generator``'s draws. Returns the sum of the
    losses (on the device) and the next step."""
    batch = idxs.shape[1]
    loss_sum = torch.zeros((), dtype=split.dtype, device=split.data.device)
    for idx in idxs:
        x, y, lam = split.data[idx], split.labels[idx], None
        if device_aug or mixup > 0:
            flips, offsets, beta = draw_augmentation(batch, split.pad, mixup, generator)
            if device_aug:
                x = augment(x, flips, offsets, split.pad)
            if beta is not None:
                lam = torch.maximum(beta, 1 - beta)  # y stays the major label
        inputs = split.norm(x)
        if lam is not None:
            inputs = lam * inputs + (1 - lam) * inputs.flip(0)
        loss_sum += train_step(model, loss_fn, optimizer, schedule(step), inputs, y, lam)
        step += 1
    return loss_sum, step


class Recalibration:
    """BatchNorm's statistics (the model's ``buffers/`` entries) as the fresh model had
    them, and their re-estimate under the current weights."""

    def __init__(self, model):
        self.model = model
        self.fresh = {key: tensor.detach().clone() for key, tensor, _ in _flat_entries(model)
                      if key.startswith("buffers/")}

    @torch.no_grad()
    def __call__(self, batches) -> None:
        """Reset to the fresh statistics, then run ``batches`` (inputs) in train mode:
        the cumulative statistics become the exact mean of those batches'."""
        if not self.fresh:
            return
        for key, tensor, _ in _flat_entries(self.model):
            if key in self.fresh:
                tensor.copy_(self.fresh[key])
        for inputs in batches:
            self.model(inputs, train=True)


def train(cfg, tr, device="cuda") -> dict:
    """Train ``cfg.case.model`` with the ``train.*`` settings ``tr``, writing the
    checkpoint after every epoch. Raises where ``device`` is a card and none is present.
    Returns the checkpoint's path (``out``) and each epoch's mean loss, seconds, steps
    and validation accuracy (``epochs``)."""
    setup = system_startup(device=device)  # the weights from seed 0, as the JAX package's from key 0
    device = setup["device"]
    dtype = torch.float64 if str(cfg.case.impl.get("dtype", "float")) in ("float64", "double") else torch.float32
    cfg_data = cfg.case.data
    cfg_data.examples_from_split = "training"
    cfg_data.batch_size = int(tr["batch_size"])
    cfg_data.partition = "none"  # the full split, as central training takes it
    if tr["res"]:
        _apply_res(cfg_data, int(tr["res"]))

    loader = construct_dataloader(cfg_data, cfg.case.impl, user_idx=0, return_full_dataset=True)
    if tr["limit"]:
        loader.dataset = loader.dataset.subset(np.arange(min(int(tr["limit"]), len(loader.dataset))))
    loader.shuffle = True

    model, loss_fn = construct_model(cfg.case.model, cfg_data, generator=setup["generator"])
    model.to(device, dtype)
    modality = cfg_data.modality
    recalibrate = Recalibration(model)  # the fresh statistics, before any resume
    optimizer = make_optimizer(model, tr)
    steps_per_epoch = max(len(loader), 1)
    # ceil(examples / batch) steps an epoch, also where the materialized epoch drops the last
    # partial batch, as the JAX package's schedule counts them
    schedule = make_schedule(float(tr["lr"]), "cosine-decay", 0, int(tr["epochs"]) * steps_per_epoch)

    val_loader = None
    if tr["eval_batches"]:
        cfg_val = copy.deepcopy(cfg_data)
        cfg_val.examples_from_split = "validation"
        val_loader = construct_dataloader(cfg_val, cfg.case.impl, user_idx=0, return_full_dataset=True)

    materialized = bool(tr["materialize"]) and modality == "vision"
    batch = int(tr["batch_size"])
    if materialized:
        split = DeviceSplit(*_materialize_vision(loader.dataset), loader.dataset.mean, loader.dataset.std, dtype,
                            device)
        steps_per_epoch = max(len(split) // batch, 1)
        val_split = None
        if val_loader is not None:
            n_eval = min(len(val_loader.dataset), int(tr["eval_batches"]) * batch)
            val_split = DeviceSplit(*_materialize_vision(val_loader.dataset.subset(np.arange(n_eval))),
                                    loader.dataset.mean, loader.dataset.std, dtype, device)

    out = str(tr["out"]) or os.path.expanduser(os.path.join(str(cfg_data.path), "checkpoints", f"{model.name}.npz"))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if tr["resume"] and os.path.exists(out):
        with np.load(out) as blob:
            replaced = load_flat_state(model, dict(blob), strict=True)
        print(f"Resumed {replaced} tensors from {out}.", flush=True)

    print(f"Training {model.name} on {loader.name} ({len(loader.dataset)} examples, {steps_per_epoch} steps/epoch).",
          flush=True)
    shuffle_rng = np.random.default_rng(0)
    step, epochs = 0, []
    for epoch in range(int(tr["epochs"])):
        began = time.time()
        if materialized:
            perm = shuffle_rng.permutation(len(split))[: steps_per_epoch * batch]
            idxs = torch.as_tensor(perm.reshape(steps_per_epoch, batch), device=device)
            loss_sum, step = materialized_epoch(model, loss_fn, optimizer, schedule, step, split, idxs,
                                                bool(tr["device_aug"]), float(tr["mixup"]),
                                                torch.Generator(device=device).manual_seed(epoch))
            recalibrate(split.norm(split.data[idx]) for idx in idxs[:RECALIBRATION_BATCHES])
            mean_loss = float(loss_sum) / steps_per_epoch
        else:
            loader.seed = epoch  # a new order each epoch, the same in every run
            losses = []
            for b in loader:
                inputs, y = _batch_arrays(b, modality, device, dtype)
                losses.append(train_step(model, loss_fn, optimizer, schedule(step), inputs, y))
                step += 1
            recalibrate(_batch_arrays(b, modality, device, dtype)[0]
                        for b, _ in zip(loader, range(RECALIBRATION_BATCHES)))
            mean_loss = float(np.mean(torch.stack(losses).tolist()))
        seconds = time.time() - began
        msg = f"epoch {epoch + 1}/{tr['epochs']}: loss {mean_loss:.4f} ({seconds:.1f}s)"
        val_acc = None
        if materialized and val_split is not None:
            val_acc = float(np.mean([float(score(model, val_split.norm(val_split.data[i:i + batch]),
                                                 val_split.labels[i:i + batch]))
                                     for i in range(0, len(val_split), batch)]))
        elif val_loader is not None:
            val_acc = float(np.mean([float(score(model, *_batch_arrays(b, modality, device, dtype)))
                                     for b, _ in zip(val_loader, range(int(tr["eval_batches"])))]))
        if val_acc is not None:
            msg += f", val acc {val_acc:.4f}"
        print(msg, flush=True)
        epochs.append(dict(loss=mean_loss, seconds=seconds, steps=steps_per_epoch, val_acc=val_acc))
        np.savez(out, **dump_flat_state(model))  # every epoch, so an interrupted run still leaves a model

    print(f"Saved trained checkpoint to {out} (load with case.server.pretrained=True).", flush=True)
    return dict(out=out, epochs=epochs)


def main(argv=None):
    tr = dict(TRAIN_DEFAULTS)
    case_overrides = []
    for ov in sys.argv[1:] if argv is None else argv:
        key, _, val = ov.partition("=")
        if key.startswith("train."):
            name = key[len("train."):]
            if name not in tr:
                raise SystemExit(f"Unknown train key '{name}'; known: {sorted(tr)}")
            tr[name] = type(TRAIN_DEFAULTS[name])(val) if name != "out" else val
        else:
            case_overrides.append(ov)
    return train(get_config(case_overrides), tr)


if __name__ == "__main__":
    main()
