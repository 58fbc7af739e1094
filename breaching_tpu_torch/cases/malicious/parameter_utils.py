"""Parameter utilities for model surgery (counterpart of
``breaching_tpu/cases/malicious/parameter_utils.py``).

The JAX package addresses a parameter by its pytree path; the port addresses it by its
``named_parameters()`` name (``victim.head.weight``), in a module or in a dict of
tensors keyed by those names (a payload's parameters, a user's gradients).
"""

from __future__ import annotations

import torch
from torch import nn


def fetch(tree, name: str) -> torch.Tensor:
    """The tensor named ``name`` of a module (its parameters and buffers) or of a dict of
    tensors keyed by parameter name."""
    if isinstance(tree, nn.Module):
        return tree.get_parameter(name) if name in dict(tree.named_parameters()) else tree.get_buffer(name)
    return tree[name]


def set_tensor(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Copy ``value`` into the parameter or buffer ``name`` of ``module``, in place."""
    with torch.no_grad():
        fetch(module, name).copy_(value)


def replace_module(model: nn.Module, name: str, new_module: nn.Module) -> None:
    """Swap the submodule ``name`` (dotted) of ``model`` for ``new_module``
    (reference replace_module_by_instance, parameter_utils.py:32-40)."""
    parent, _, child = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, child, new_module)


def introspect_model(model: nn.Module, input_shape, **forward_kwargs) -> dict:
    """The output shape of every submodule on one zero input of ``input_shape`` (C, H, W),
    by module name, and the model's under ``__output__`` (reference shape probes with
    forward hooks, parameter_utils.py:6-29)."""
    shapes, hooks = {}, []

    def record(name):
        def hook(module, inputs, output):
            shapes.setdefault(name, tuple(output.shape))
        return hook

    for name, module in model.named_modules():
        if name:
            hooks.append(module.register_forward_hook(record(name)))
    param = next(model.parameters(), None)
    example = torch.zeros((1, *input_shape), device=None if param is None else param.device)
    try:
        with torch.no_grad():
            output = model(example, **forward_kwargs)
    finally:
        for hook in hooks:
            hook.remove()
    shapes["__output__"] = tuple(output.shape)
    return shapes


def param_names(tree, predicate=None) -> list[str]:
    """Every parameter name of a module or of a dict of tensors, optionally filtered by
    ``predicate(name, tensor)``."""
    items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
    return [name for name, tensor in items if predicate is None or predicate(name, tensor)]
