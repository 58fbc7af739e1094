"""Model factory: name -> (nn.Module, loss_fn), for the text models of
``language_models.py`` and every vision name of the JAX package's dispatch: the ResNets
(BatchNorm and GroupNorm; the WSL, SWSL, SSL and MoCo names as the ResNet-50 or -101 they
are built on), DenseNet, VGG, NFNet, the ConvNets, ``ConvNetSmall``, LeNet, CNN6 (with
R-GAP's ``rgap_layers``), MLP, ``linear``, ``none`` and the ViTs (with APRIL's
``april_refs`` and ``april_retile``).

Counterpart of ``breaching_tpu/cases/models/model_preparation.py``. Weights are
drawn from the ``setup`` generator. With ``pretrained=True`` a checkpoint in the
JAX package's flat layout (``params/conv0/conv/kernel``, ``buffers/bn0/mean``, ...)
is loaded through ``load_flat_state``: ``<data.path>/checkpoints/<name>.npz`` first,
then the repo's ``assets/checkpoints/<name>.npz``; without one, or if a shape does
not fit, a warning is logged and the random init stays.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch import nn

from .layers import BatchNorm
from .losses import LOSSES, CrossEntropyLoss
from .resnets import build_resnet
from .vision_nets import (CNN6, MLP, ConvNet, ConvNetBeyond, ConvNetSmall, ConvNetTrivial, LeNetZhu, LinearModel,
                          NoneModel)

log = logging.getLogger(__name__)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def construct_model(cfg_model, cfg_data, pretrained: bool = False, generator=None):
    """Build (model, loss_fn) on the CPU from a model name and a data config."""
    if cfg_data.modality == "text":
        from .language_models import construct_text_model

        model, loss_cls = construct_text_model(cfg_model, cfg_data, generator=generator)
        if not hasattr(model, "name"):  # the HuggingFace architectures carry the JAX package's name
            model.name = str(cfg_model)
        if pretrained:
            _maybe_load_pretrained(model, cfg_data)
        return model, loss_cls()
    if cfg_data.modality != "vision":
        raise NotImplementedError(f"{cfg_data.modality} models are not ported yet.")
    name = str(cfg_model)
    lname = name.lower()
    classes, shape = int(cfg_data.classes), tuple(cfg_data.shape)
    imagenet = "ImageNet" in str(cfg_data.name)
    pretrained_tags = ("wsl", "swsl", "ssl", "moco")
    small = dict(num_classes=classes, shape=shape, generator=generator)
    if "resnet" in lname and not any(tag in lname for tag in pretrained_tags):
        model = build_resnet(name, classes, imagenet, shape=shape, generator=generator)
    elif any(tag in lname for tag in pretrained_tags):
        # the JAX package builds the torch.hub WSL/SWSL/SSL/MoCo names as the ImageNet
        # ResNet they are made from (no download): ResNet-101 where the name says so
        depth = "101" if "101" in lname else "50"
        model = build_resnet(f"resnet{depth}", classes, True, shape=shape, generator=generator)
    elif "densenet" in lname:
        from .densenets import DenseNet, densenet_depths_to_config

        growth, blocks, init_feats = densenet_depths_to_config(int("".join(filter(str.isdigit, lname))))
        model = DenseNet(growth_rate=growth, block_config=blocks, num_init_features=init_feats,
                         stem="ImageNet" if imagenet else "CIFAR", **small)
    elif "vgg" in lname:
        from .vgg import VGG

        model = VGG(plan_name=name, head="ImageNet" if imagenet else "CIFAR", **small)
    elif "nfnet" in lname:
        from .nfnets import NFNet, nfnet_params

        variant = next((v for v in nfnet_params if v.lower() in lname), "F0")
        model = NFNet(variant=variant, stem="ImageNet" if imagenet else "CIFAR", **small)
    elif lname == "convnet-trivial":
        model = ConvNetTrivial(**small)
    elif lname == "convnet_beyond":
        model = ConvNetBeyond(**small)
    elif lname.startswith("convnetsmall"):  # ConvNetSmall is 256 wide, ConvNetSmall16 16
        digits = "".join(filter(str.isdigit, lname))
        model = ConvNetSmall(width=int(digits) if digits else 256, **small)
    elif lname.startswith("convnet"):  # ConvNet is 64 wide, ConvNet8 8
        digits = "".join(filter(str.isdigit, lname))
        model = ConvNet(width=int(digits) if digits else 64, **small)
    elif lname in ("lenet_zhu", "lenetzhu"):
        model = LeNetZhu(**small)
    elif lname == "cnn6":
        model = CNN6(**small)
    elif lname == "mlp":
        model = MLP(**small)
    elif lname in ("linear", "none"):
        model = (LinearModel if lname == "linear" else NoneModel)(**small)
    elif "vit" in lname:
        from .vit import build_vit

        model = build_vit(name, classes, shape=shape, generator=generator)
    else:
        raise ValueError(f"Unknown vision model {cfg_model}.")
    model.name = name
    if pretrained:
        _maybe_load_pretrained(model, cfg_data)
    loss_cls = LOSSES.get(getattr(cfg_data, "task", "classification"), CrossEntropyLoss)
    return model, loss_cls()


def head_name(model) -> str:
    """The module name of ``model``'s classification head: ``head`` in every model of the
    port, ``victim.head`` behind an imprint block (``ImprintedModel.head_name``)."""
    return getattr(model, "head_name", "head")


def head_keys(model) -> tuple[str, str | None]:
    """The parameter names (weight, bias) of ``model``'s classification head; a text
    model names its own (``head_param_keys``: a tied decoder's weight is the embedding,
    and the HuggingFace LM heads name no bias, as the JAX package's ``head_grads`` finds
    none)."""
    if hasattr(model, "head_param_keys"):
        return model.head_param_keys
    head = head_name(model)
    return f"{head}.weight", f"{head}.bias"


def head_grads(gradients: dict, model):
    """(weight gradient (out, in), bias gradient (out,)) of ``model``'s classification
    head, from ``gradients`` by parameter name; zeros for a head without a bias."""
    weight, bias = head_keys(model)
    if bias is None:
        return gradients[weight], gradients[weight].new_zeros(gradients[weight].shape[0])
    return gradients[weight], gradients[bias]


def _flat_entries(model: nn.Module):
    """(flat key, tensor, transform) for every parameter and buffer of the model, the
    flat key in the JAX package's layout and the transform taking its array to the
    tensor's layout (HWIO -> OIHW for convolutions, (in, out) -> (out, in) for dense).
    A Conv2d or Linear is the JAX package's ``Conv`` or ``Dense`` wrapper
    (``<name>/conv/kernel``), or with ``layers.direct`` a flax layer used directly
    (``<name>/kernel``). The dense layers of an imprint block (``flat_param_suffixes``)
    are the JAX block's ``<name>_kernel`` and ``<name>_bias``. A module with a layout of
    its own (a norm, the ViT's tokens, NFNet's WSConv) gives its entries through
    ``flax_entries(prefix)``."""
    for path, module in model.named_modules():
        prefix = path.replace(".", "/")
        parent = path.rpartition(".")[0]
        if hasattr(module, "flax_entries"):
            yield from module.flax_entries(prefix)
        elif isinstance(module, nn.Linear) and getattr(model.get_submodule(parent), "flat_param_suffixes", False):
            yield f"params/{prefix}_kernel", module.weight, np.transpose
            yield f"params/{prefix}_bias", module.bias, None
        elif isinstance(module, (nn.Conv2d, nn.Linear)):
            key = f"params/{prefix}" if getattr(module, "flax_direct", False) else \
                f"params/{prefix}/{'conv' if isinstance(module, nn.Conv2d) else 'dense'}"
            yield f"{key}/kernel", module.weight, conv_kernel if isinstance(module, nn.Conv2d) else np.transpose
            if module.bias is not None:
                yield f"{key}/bias", module.bias, None
        elif isinstance(module, BatchNorm):
            yield f"params/{prefix}/scale", module.weight, None
            yield f"params/{prefix}/bias", module.bias, None
            yield f"buffers/{prefix}/mean", module.running_mean, None
            yield f"buffers/{prefix}/var", module.running_var, None
            yield f"buffers/{prefix}/num_batches_tracked", module.num_batches_tracked, None


def conv_kernel(kernel: np.ndarray) -> np.ndarray:
    """A flax convolution kernel (H, W, I, O) in PyTorch's layout (O, I, H, W)."""
    return np.transpose(kernel, (3, 2, 0, 1))


def jax_leaf_ranks(model: nn.Module) -> list[int]:
    """For each parameter of ``model`` in ``named_parameters`` order, its place in the
    JAX package's pytree leaf order of the same model's parameters (dict keys sorted at
    every level)."""
    paths = {id(tensor): tuple(key.split("/")) for key, tensor, _ in _flat_entries(model)}
    keyed = [paths[id(p)] for _, p in model.named_parameters()]
    order = sorted(range(len(keyed)), key=lambda i: keyed[i])
    ranks = [0] * len(keyed)
    for rank, i in enumerate(order):
        ranks[i] = rank
    return ranks


def load_flat_state(model: nn.Module, flat: dict, strict: bool = False) -> int:
    """Load a flat ``{"params/a/b/kernel": array}`` mapping in the JAX package's layout
    into the model. Returns the number of tensors replaced. Every shape is checked
    before anything is written: a shape that does not fit raises ValueError and leaves
    the model as it was. With ``strict``, a tensor without an entry raises KeyError."""
    updates = []
    for key, tensor, transform in _flat_entries(model):
        if key not in flat:
            if strict:
                raise KeyError(f"Checkpoint has no entry for {key}.")
            continue
        value = np.asarray(flat[key])
        value = transform(value) if transform is not None else value
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"Checkpoint entry {key} has shape {tuple(value.shape)}, the model "
                             f"expects {tuple(tensor.shape)}.")
        updates.append((tensor, value))
    with torch.no_grad():
        for tensor, value in updates:
            tensor.copy_(torch.tensor(np.array(value), dtype=tensor.dtype))
    return len(updates)


def _maybe_load_pretrained(model: nn.Module, cfg_data) -> None:
    candidates = [os.path.expanduser(os.path.join(str(cfg_data.path), "checkpoints", f"{model.name}.npz")),
                  os.path.join(REPO, "assets", "checkpoints", f"{model.name}.npz")]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        log.warning(f"pretrained=True but no checkpoint at {candidates[0]} (nor the repo fallback "
                    f"{candidates[1]}); keeping random init.")
        return
    with np.load(path) as blob:
        flat = dict(blob)
    try:
        replaced = load_flat_state(model, flat)
    except ValueError as err:
        log.warning(f"Checkpoint at {path} does not fit this model ({err}); keeping random init.")
        return
    log.info(f"Loaded {replaced} pretrained tensors for {model.name} from {path}.")
