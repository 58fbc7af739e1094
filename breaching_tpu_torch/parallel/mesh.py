"""Meshes of ranks and the parameter partition rule (counterpart of
``breaching_tpu/parallel/mesh.py``).

A mesh has the JAX package's two axes: ``restarts`` (independent attack trials, or
users, one slice per rank) and ``model`` (the candidate batch in ``attack.impl.sharding=
"batch"``). Over a process group it is a ``torch.distributed.device_mesh.DeviceMesh`` of
the first ``restarts x model`` ranks, whose dims' groups carry the collectives; ranks
beyond it are idle (they hold no coordinate, and join every group's creation and the
final gathers). A mesh of one shape is built once for the life of the process group and
reused, so that an attack per wave adds no process groups. Without a process group the
mesh is 1 x 1 and every collective is the identity, as "on one chip the same code runs
with a trivial 1x1 mesh" in the JAX package.

The shapes are the JAX package's (``mesh.py:26-52``): ``make_mesh`` factors n as
(n / k, k) for the largest k <= sqrt(n) that divides n; ``make_attack_mesh`` takes the
largest restarts count that divides both n and the number of trials, with a model axis
(the rest of the ranks) only in the ``"2d"``/``"model"`` modes. ``mesh_shape`` and
``attack_mesh_shape`` are that arithmetic alone.

``params_partition_specs`` is the JAX package's out-channel rule seen through the weight
bridge: the JAX package shards the last dimension of a leaf where the mesh axis divides it
(the out-channels of HWIO and (in, out) kernels); the port's leaves are OIHW and (out, in)
(``model_preparation._flat_entries``), so the same logical axis is dim 0 there. A spec is
a tuple in the manner of a ``PartitionSpec``: the axis name at the sharded dim, None
elsewhere; ``()`` for a replicated leaf. The JAX package places the parameters by these
specs (GSPMD); the port's attack keeps them whole on every rank (``sharded_attack_step``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from . import _dist

AXES = ("restarts", "model")


def mesh_shape(n: int) -> tuple[int, int]:
    """(n / k, k) for the largest k <= sqrt(n) that divides n."""
    k = max(c for c in range(1, math.isqrt(n) + 1) if n % c == 0)
    return n // k, k


def attack_mesh_shape(n: int, num_trials: int, mode: str = "restarts") -> tuple[int, int]:
    """(restarts, model): the largest restarts count that divides n and ``num_trials``;
    the model axis takes the rest of the n ranks in the ``"2d"``/``"model"`` modes, else 1."""
    rest = next(d for d in range(n, 0, -1) if n % d == 0 and num_trials % d == 0)
    return rest, (n // rest if mode in ("2d", "model") else 1)


class Mesh:
    """A (restarts, model) mesh over the first restarts x model ranks. ``shape`` maps the
    axis names to their sizes, ``coordinate`` is this rank's (i, j) (None on an idle rank),
    ``group(axis)`` the process group of this rank's line along ``axis`` (None where there
    is no process group), ``active`` the group of every rank in the mesh."""

    def __init__(self, restarts: int, model: int):
        rank, world = _dist.world()
        if restarts * model > world:
            raise ValueError(f"A {restarts} x {model} mesh needs {restarts * model} ranks; the world has {world}.")
        self.shape = dict(restarts=restarts, model=model)
        self.size = restarts * model
        self.coordinate = divmod(rank, model) if rank < self.size else None
        self.device_mesh = None
        self.active = None
        if dist.is_initialized():
            from torch.distributed.device_mesh import DeviceMesh

            # the ranks' device: NCCL's, or gloo's where the ranks already work on a card
            device_type = "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"
            self.device_mesh = DeviceMesh(device_type, torch.arange(self.size).reshape(restarts, model),
                                          mesh_dim_names=AXES)
            # every rank takes part in creating a group, members or not
            self.active = dist.new_group(list(range(self.size)))

    def group(self, axis: str):
        if self.device_mesh is None or self.coordinate is None:
            return None
        return self.device_mesh.get_group(axis)

    def part(self, axis: str, length: int) -> tuple[int, int]:
        """(start, length) of this rank's equal part of ``length`` along ``axis``; the whole
        on an idle rank."""
        size = self.shape[axis]
        if length % size:
            raise ValueError(f"{length} does not divide over the {axis} axis of {size}.")
        if self.coordinate is None:
            return 0, length
        index = self.coordinate[AXES.index(axis)]
        return index * (length // size), length // size

    def __repr__(self):
        return f"Mesh({self.shape}, coordinate={self.coordinate})"


_MESHES: dict = {}


def mesh_of(restarts: int, model: int) -> Mesh:
    """The ``Mesh`` of this shape, built once for the process group that holds it (a new
    process group builds it anew): its groups are created on every rank in one order, so
    every rank asks for the same shapes in the same order, as the attack does."""
    world = dist.group.WORLD if dist.is_initialized() else None
    key = (restarts, model)
    held = _MESHES.get(key)
    if held is None or held[0] is not world:
        held = _MESHES[key] = (world, Mesh(restarts, model))
    return held[1]


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 2D mesh over the first n ranks (the world where None), n as (n / k, k)."""
    return mesh_of(*mesh_shape(n_devices or _dist.world()[1]))


def make_attack_mesh(num_trials: int, mode: str = "restarts", n_devices: int | None = None) -> Mesh:
    """The mesh of ``attack.impl.sharding``: always 2D, the model axis possibly 1."""
    return mesh_of(*attack_mesh_shape(n_devices or _dist.world()[1], num_trials, mode))


def _jax_last_axis(transform, shape) -> tuple[int | None, int]:
    """(the port dim that holds the JAX leaf's last dimension, that dimension's length) for a
    port leaf of ``shape`` whose flat array becomes the port's layout through ``transform``
    (None: the same layout); (None, 0) where no one dim holds it."""
    if transform is None:
        return len(shape) - 1, shape[-1]
    inverse = getattr(transform, "inverse", transform)
    flat_shape = np.shape(inverse(np.zeros(shape)))
    probe = transform(np.broadcast_to(np.arange(flat_shape[-1], dtype=np.float64), flat_shape))
    varying = [d for d in range(probe.ndim) if probe.shape[d] > 1 and np.ptp(probe, axis=d).any()]
    return (varying[0], flat_shape[-1]) if len(varying) == 1 else (None, 0)


def params_partition_specs(model: torch.nn.Module, mesh: Mesh, axis: str = "model") -> dict:
    """name -> spec for every parameter of ``model``: sharded over ``axis`` on the dim that
    holds the JAX leaf's last dimension where the axis size divides that dimension (and is
    no larger), else ``()``."""
    from ..cases.models.model_preparation import _flat_entries

    size = mesh.shape[axis]
    transforms = {id(tensor): transform for _, tensor, transform in _flat_entries(model)}
    specs = {}
    for name, param in model.named_parameters():
        dim, length = _jax_last_axis(transforms.get(id(param)), tuple(param.shape)) if param.dim() else (None, 0)
        if dim is not None and length % size == 0 and length >= size:
            specs[name] = tuple(axis if d == dim else None for d in range(param.dim()))
        else:
            specs[name] = ()
    return specs


def shard_pytree(tree: dict, mesh: Mesh, specs: dict, axis: str = "model") -> dict:
    """This rank's part of every leaf of ``tree`` (name -> tensor) under ``specs``: its
    slice of a sharded leaf, the whole of a replicated one."""
    out = {}
    for name, leaf in tree.items():
        spec = specs.get(name, ())
        if axis in spec:
            dim = spec.index(axis)
            out[name] = leaf.narrow(dim, *mesh.part(axis, leaf.shape[dim])).clone()
        else:
            out[name] = leaf
    return out


def sharded_attack_step(model, loss_fn, objective, mesh: Mesh, params: dict, step_size: float = 0.1):
    """One gradient-inversion step of this rank's trials: its slice over ``restarts`` of a
    (T, N, C, H, W) stack of candidates, then one unsigned, unboxed Adam step (kernel B4).
    The parameters and the target gradient stay whole on every rank, and the ranks of one
    line of the ``model`` axis step the same trials; the JAX package places the
    parameters by ``param_specs`` (GSPMD), which the port does not.

    Returns (step_fn, param_specs); ``step_fn(candidates, opt_state, params, buffers,
    target_grads, labels)`` with ``candidates`` this rank's trials, ``target_grads`` the
    whole target leaves in the order of ``params``, and ``opt_state`` from
    ``step_fn.init_state(candidates)``, returns (candidates, opt_state, values), the
    candidates and the state advanced in place."""
    from ..attacks.auxiliaries.optimizers import Adam
    from ..ops import adam_box_step_trials

    specs = params_partition_specs(model, mesh)
    adam = Adam(lambda count: step_size)

    def init_state(candidates):
        state = adam.init(candidates)
        vals = candidates.new_full((candidates.shape[0],), float("inf"))
        return dict(state, best=candidates.clone(), best_vals=[vals, torch.empty_like(vals)])

    def step_fn(candidates, opt_state, params, buffers, target_grads, labels):
        x = candidates.detach().requires_grad_(True)
        trials = x.shape[0]
        targets = tuple(t.expand(trials, *t.shape) for t in target_grads)
        values, _ = objective.trials(params, buffers, targets, x, labels.expand(trials, *labels.shape))
        grad, = torch.autograd.grad(values.sum(), x)
        bound = candidates.new_zeros(candidates.shape[2])
        adam_box_step_trials(candidates, grad.contiguous(), opt_state["mu"], opt_state["nu"], opt_state["best"],
                             bound, bound, values.detach(), *opt_state["best_vals"],
                             adam.advance(opt_state, candidates.dtype), signed=False, boxed=False)
        opt_state["best_vals"].reverse()
        return candidates, opt_state, values.detach()

    step_fn.init_state = init_state
    return step_fn, specs
