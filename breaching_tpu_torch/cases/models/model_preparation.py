"""Model factory: name -> (nn.Module, loss_fn), for the ConvNet family.

Counterpart of ``breaching_tpu/cases/models/model_preparation.py``. Weights are
drawn from the ``setup`` generator. With ``pretrained=True`` a converted checkpoint
``<data.path>/checkpoints/<name>.npz`` in the JAX package's flat layout
(``params/conv0/conv/kernel``, ``buffers/bn0/mean``, ...) is loaded through
``ConvNet.from_jax_state`` where one exists; otherwise the random init stays.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from .losses import LOSSES, CrossEntropyLoss
from .vision_nets import ConvNet

log = logging.getLogger(__name__)


def construct_model(cfg_model, cfg_data, pretrained: bool = False, generator=None):
    """Build (model, loss_fn) on the CPU from a model name and a data config."""
    if cfg_data.modality != "vision":
        raise NotImplementedError(f"{cfg_data.modality} models are not ported yet.")
    name = str(cfg_model)
    lname = name.lower()
    if lname.startswith("convnet") and lname[len("convnet"):].isdigit():
        width = int(lname[len("convnet"):])
    elif lname == "convnet":
        width = 64
    else:
        raise NotImplementedError(f"Model {name} is not ported yet; the port has the ConvNet family.")
    model = ConvNet(width=width, num_classes=int(cfg_data.classes), shape=tuple(cfg_data.shape),
                    generator=generator)
    model.name = name
    if pretrained:
        _maybe_load_pretrained(model, cfg_data)
    loss_cls = LOSSES.get(getattr(cfg_data, "task", "classification"), CrossEntropyLoss)
    return model, loss_cls()


def _unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _maybe_load_pretrained(model: ConvNet, cfg_data) -> None:
    path = os.path.expanduser(os.path.join(str(cfg_data.path), "checkpoints", f"{model.name}.npz"))
    if not os.path.exists(path):
        log.warning(f"pretrained=True but no checkpoint at {path}; keeping random init.")
        return
    with np.load(path) as blob:
        flat = dict(blob)
    model.from_jax_state(_unflatten(flat, "params/"), _unflatten(flat, "buffers/"))
    log.info(f"Loaded pretrained {model.name} from {path}.")
