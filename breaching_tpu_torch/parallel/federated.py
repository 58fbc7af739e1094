"""Users over the ranks of a mesh (counterpart of ``breaching_tpu/parallel/federated.py``).

The JAX package shards the users' batches over a mesh axis, each device computes its
users' gradients and one ``pmean`` gives the secure-aggregation mean. Here each rank of the
axis takes its equal share of the users, sums their gradients, and one all-reduce over the
axis's group joins the ranks' sums into the mean over all users.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from . import _dist


def sharded_user_aggregate(model, loss_fn, mesh, user_inputs, user_labels, axis: str = "restarts") -> dict:
    """The mean of every user's gradient (BatchNorm in eval mode), by parameter name, on
    every rank. ``user_inputs`` (num_users, B, C, H, W) and ``user_labels`` (num_users, B)
    hold all the users on every rank; the number of users divides over ``axis``."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())
    num_users = user_inputs.shape[0]
    start, length = mesh.part(axis, num_users)
    total = None
    for x, y in zip(user_inputs[start:start + length], user_labels[start:start + length]):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(functional_call(model, {**leaves, **buffers}, (x,)), y)
        grads = torch.autograd.grad(loss, tuple(leaves.values()))
        total = list(grads) if total is None else [t + g for t, g in zip(total, grads)]
    flat = torch.cat([t.reshape(-1) for t in total])
    flat = _dist.all_reduce_(flat, mesh.group(axis)) / num_users
    return {k: part.view(v.shape) for (k, v), part in zip(params.items(), flat.split([v.numel() for v in
                                                                                     params.values()]))}
