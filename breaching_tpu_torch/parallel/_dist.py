"""The process group of the port's multi-device layer, and the collectives it needs.

The JAX package is single-controller: one process sees every chip. The port runs one
process (rank) per device, as PyTorch does: ``torchrun`` (``python3 -m
torch.distributed.run``) starts the ranks, every rank builds the same case from the same
seed, and the collectives here join what the ranks computed. Run without a launcher,
the world has size 1, no process group exists, and every collective here is the
identity.

Backend rule: NCCL when the ranks run on CUDA devices and every rank of a host has a
card of its own (``torch.cuda.device_count() >= LOCAL_WORLD_SIZE``); otherwise gloo
(the CPU, or several ranks sharing one card). It is a rule, not a fallback: a failed
NCCL start raises. Under NCCL rank r uses ``cuda:LOCAL_RANK``; ranks that share cards
take ``cuda:(LOCAL_RANK mod cards)``.

gloo takes only ``broadcast`` and ``all_reduce`` on CUDA tensors, so every gather here is
an ``all_reduce``: each rank writes its part into a zero buffer of the whole and one sum
joins them (x + 0 is exact, so the gathered values are the ranks' own).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_writer() -> bool:
    """Whether this rank writes the run's records (rank 0)."""
    return world()[0] == 0


def backend_for(device_type: str, ranks_per_host: int) -> str:
    """The backend rule: NCCL where every rank of a host has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """The device of the rank ``local_rank`` of its host: ``cuda:(local_rank mod cards)``."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def start(device: torch.device, rank: int, world_size: int, local_rank: int | None = None,
          ranks_per_host: int | None = None, store=None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this rank's device.
    ``store`` is a ``torch.distributed`` store (a ``FileStore`` in the tests); without
    one, the rendezvous is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``), as
    ``torchrun`` sets it. A process group that already exists is kept."""
    local_rank = rank if local_rank is None else local_rank
    device = rank_device(device, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend_for(device.type, world_size if ranks_per_host is None else ranks_per_host)
    kwargs = dict(store=store) if store is not None else dict(init_method="env://")
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kwargs)
    log.info(f"Rank {rank} of {world_size} on {device} over {backend} "
             f"(NCCL where every rank of a host has a card of its own, else gloo).")
    return device


def start_from_env(device: torch.device) -> torch.device:
    """``start`` from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), a world of one rank included; ``device`` where
    there is neither that environment nor a process group."""
    if dist.is_initialized():
        return rank_device(device, int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    world_size = int(os.environ["WORLD_SIZE"])
    return start(device, int(os.environ["RANK"]), world_size, int(os.environ.get("LOCAL_RANK", "0")),
                 int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))


def backend() -> str | None:
    return dist.get_backend() if dist.is_initialized() else None


def all_reduce_(tensor: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``tensor`` reduced in place over ``group`` (the world where None); the identity
    without a process group. Under NCCL a CPU tensor goes through the rank's card."""
    if not dist.is_initialized():
        return tensor
    if backend() == "nccl" and not tensor.is_cuda:
        staged = tensor.cuda()
        dist.all_reduce(staged, op=op, group=group)
        return tensor.copy_(staged.cpu())
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


class _MeanOverGroup(torch.autograd.Function):
    """The mean of x over the m ranks of a group. Forward: all-reduce SUM, then / m. Backward:
    the cotangent / m, with no second all-reduce: every rank holds the same cotangent of the
    mean (each computes the same loss from it), and rank r's part of the solo gradient is
    that cotangent times (1/m) dx_r. ``torch.distributed.nn``'s all-reduce would all-reduce
    the cotangent again and make the gradient m times too large. The backward is a plain
    division, differentiable again."""

    @staticmethod
    def forward(ctx, x, group, m):
        ctx.m = m
        return all_reduce_(x.detach().clone(), group) / m

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None, None


def mean_over(x: torch.Tensor, group, m: int) -> torch.Tensor:
    """Differentiable mean of x over the m ranks of ``group``; x itself where m is 1."""
    return x if m == 1 else _MeanOverGroup.apply(x, group, m)


def gather(part: torch.Tensor | None, shape, index, group=None, dtype=None, device=None) -> torch.Tensor:
    """The whole tensor of ``shape`` on every rank of ``group``: each rank writes ``part``
    at ``index`` (a tuple of slices) of a zero buffer, a rank with ``part`` None writes
    nothing, and one all-reduce joins them."""
    if part is not None:
        dtype, device = part.dtype, part.device
    whole = torch.zeros(shape, dtype=dtype, device=device)
    if part is not None:
        whole[index] = part
    return all_reduce_(whole, group)
