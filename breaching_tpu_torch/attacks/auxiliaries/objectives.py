"""Gradient-matching objectives (counterpart of ``breaching_tpu/attacks/auxiliaries/objectives.py``).

The simulated user gradient is ``torch.autograd.grad(..., create_graph=True)`` of
the task loss through ``torch.func.functional_call``, so the attack's gradient
with respect to the candidate is a double backward, which cuDNN runs for the
convolutions. Gradients are tuples of tensors in the order of the parameter dict.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from ...ops import fused_cosine_similarity


class GradientLoss:
    """Base class: owns the task-gradient function and the distance."""

    def __init__(self, scale=1.0, task_regularization=0.0, **kwargs):
        self.scale = float(scale)
        self.task_regularization = float(task_regularization)

    def initialize(self, loss_fn, model, local_hyperparams=None, cfg_impl=None):
        if local_hyperparams is not None:
            raise NotImplementedError("Multi-step (fedAVG) users are not ported yet.")
        if cfg_impl is not None and int(cfg_impl.get("grad_accum", 1) or 1) > 1:
            raise NotImplementedError("attack.impl.grad_accum > 1 is not ported yet.")
        self.loss_fn = loss_fn
        self.model = model

    def grad_fn(self, params, buffers, candidate, labels, bn_train=False):
        """The user's parameter gradient for the candidate data, differentiable."""
        if bn_train:  # train-mode BatchNorm updates the buffers it is given in place
            buffers = {k: v.clone() for k, v in buffers.items()}
        outputs = functional_call(self.model, {**params, **buffers}, (candidate,),
                                  dict(train=bn_train))
        task_loss = self.loss_fn(outputs, labels)
        grads = torch.autograd.grad(task_loss, tuple(params.values()), create_graph=True)
        return grads, task_loss

    def __call__(self, params, buffers, target_grads, candidate, labels, bn_train=False):
        grads, task_loss = self.grad_fn(params, buffers, candidate, labels, bn_train=bn_train)
        objective = self.gradient_based_loss(grads, target_grads)
        if self.task_regularization != 0:
            objective = objective + self.task_regularization * task_loss
        return objective, task_loss.detach()

    def gradient_based_loss(self, grads, target_grads):
        raise NotImplementedError


class CosineSimilarity(GradientLoss):
    def gradient_based_loss(self, grads, target_grads):
        product = sum((g * t).sum() for g, t in zip(grads, target_grads))
        rec_norm = sum((g * g).sum() for g in grads)
        data_norm = sum((t * t).sum() for t in target_grads)
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def __repr__(self):
        return f"Cosine Similarity with scale={self.scale} and task reg={self.task_regularization}"


class FusedCosineSimilarity(CosineSimilarity):
    """Cosine matching over the flattened gradient through kernels B1 (one-pass
    sums) and B2 (its backward), ``breaching_tpu_torch/ops/matching.py``."""

    def __init__(self, scale=1.0, task_regularization=0.0, **kwargs):
        super().__init__(scale, task_regularization)
        self._target, self._flat_target = None, None

    def gradient_based_loss(self, grads, target_grads):
        if self._target is not target_grads:  # the target is fixed for a whole attack
            self._target = target_grads
            self._flat_target = torch.cat([t.reshape(-1) for t in target_grads])
        rec = torch.cat([g.reshape(-1) for g in grads])
        return fused_cosine_similarity(rec, self._flat_target) * self.scale

    def __repr__(self):
        return f"Fused (CUDA) Cosine Similarity with scale={self.scale}"


objective_lookup = {
    "cosine-similarity": CosineSimilarity,
    "fused-cosine-similarity": FusedCosineSimilarity,
}
