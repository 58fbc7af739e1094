"""Gradient-matching objectives (counterpart of ``breaching_tpu/attacks/auxiliaries/objectives.py``).

The simulated user gradient is ``torch.autograd.grad(..., create_graph=True)`` of
the task loss through ``torch.func.functional_call``, so the attack's gradient
with respect to the candidate is a double backward, which cuDNN runs for the
convolutions. Gradients are tuples of tensors in the order of the parameter dict.

For a fedAVG user (``initialize`` with its local hyperparameters) the simulated
update is the parameter delta after K local SGD steps, unrolled: each step's
gradient is taken with ``create_graph=True`` and the next step's parameters are the
non-leaf tensors p - lr·g, so the attack's gradient runs back through all K steps
(reference ``breaching_tpu/attacks/auxiliaries/objectives.py:166-202``).

``trials`` computes the objective for T trials at once (restarts, and the fleet of
``reconstruct_fleet``): the user gradient of every trial is
``torch.func.vmap(torch.func.grad(task loss))`` over the candidates' leading trial
axis with the parameters shared, and the distance is reduced per trial, so that one
``torch.autograd.grad`` of the trials' sum gives each trial's attack gradient. It
is not ported for fedAVG users.
"""

from __future__ import annotations

import torch
from torch.func import functional_call, grad as func_grad, vmap

from ...ops import fused_cosine_similarity


class GradientLoss:
    """Base class: owns the task-gradient function and the distance."""

    def __init__(self, scale=1.0, task_regularization=0.0, **kwargs):
        self.scale = float(scale)
        self.task_regularization = float(task_regularization)
        self.local_hyperparams = None

    def initialize(self, loss_fn, model, local_hyperparams=None, cfg_impl=None):
        """``local_hyperparams``: None for a fedSGD user; for a fedAVG user its ``lr``,
        ``steps``, ``data_per_step`` and ``labels``, one row of sorted labels per step
        as a (steps, data_per_step) tensor."""
        if cfg_impl is not None and int(cfg_impl.get("grad_accum", 1) or 1) > 1:
            raise NotImplementedError("attack.impl.grad_accum > 1 is not ported yet.")
        self.loss_fn = loss_fn
        self.model = model
        self.local_hyperparams = local_hyperparams

    def grad_fn(self, params, buffers, candidate, labels, bn_train=False):
        """The user's update for the candidate data, differentiable: the parameter
        gradient, or for a fedAVG user the parameter delta; with the task loss (of the
        last local step)."""
        if bn_train:  # train-mode BatchNorm updates the buffers it is given in place
            buffers = {k: v.clone() for k, v in buffers.items()}
        if self.local_hyperparams is not None:
            return self._local_steps(params, buffers, candidate, bn_train)
        outputs = functional_call(self.model, {**params, **buffers}, (candidate,),
                                  dict(train=bn_train))
        task_loss = self.loss_fn(outputs, labels)
        grads = torch.autograd.grad(task_loss, tuple(params.values()), create_graph=True)
        return grads, task_loss

    def _local_steps(self, params, buffers, candidate, bn_train):
        """The fedAVG user's K local SGD steps, unrolled: step k trains on the
        candidate's rows (k·m + j) mod N, j < m, under the shared sorted labels of
        that step (not the attack's labels), as the user does. Returns the delta and
        the last step's task loss."""
        hp = self.local_hyperparams
        lr, steps, per_step = float(hp["lr"]), int(hp["steps"]), int(hp["data_per_step"])
        num_points = candidate.shape[0]
        initial = tuple(params.values())
        current = initial
        for k in range(steps):
            start = k * per_step % num_points
            if start + per_step <= num_points:  # a view: no gather, and no scatter in the backward
                batch = candidate[start:start + per_step]
            else:
                batch = candidate[[(start + j) % num_points for j in range(per_step)]]
            outputs = functional_call(self.model, {**dict(zip(params, current)), **buffers}, (batch,),
                                      dict(train=bn_train))
            task_loss = self.loss_fn(outputs, hp["labels"][k])
            grads = torch.autograd.grad(task_loss, current, create_graph=True)
            current = tuple(p - lr * g for p, g in zip(current, grads))
        return tuple(p - p0 for p, p0 in zip(current, initial)), task_loss

    def __call__(self, params, buffers, target_grads, candidate, labels, bn_train=False):
        grads, task_loss = self.grad_fn(params, buffers, candidate, labels, bn_train=bn_train)
        objective = self.gradient_based_loss(grads, target_grads)
        if self.task_regularization != 0:
            objective = objective + self.task_regularization * task_loss
        return objective, task_loss.detach()

    def trials(self, params, buffers, target_grads, candidates, labels):
        """The objective of T trials at once, for candidates (T, N, C, H, W), labels
        (T, N) and ``target_grads`` with a leading trial axis (T, ...) in the order of
        ``params``: (T,) values, differentiable with respect to the candidates, and
        (T,) task losses. BatchNorm runs in eval mode."""
        if self.local_hyperparams is not None:
            raise NotImplementedError("Restarts and fleets of fedAVG users are not ported yet; "
                                      "attack a fedAVG user with one trial.")
        def task_loss(p, x, y):
            loss = self.loss_fn(functional_call(self.model, {**p, **buffers}, (x,)), y)
            return loss, loss

        grads, task_losses = vmap(func_grad(task_loss, has_aux=True), in_dims=(None, 0, 0))(
            params, candidates, labels)
        objective = self.trial_distances(tuple(grads[k] for k in params), target_grads)
        if self.task_regularization != 0:
            objective = objective + self.task_regularization * task_losses
        return objective, task_losses.detach()

    def gradient_based_loss(self, grads, target_grads):
        raise NotImplementedError

    def trial_distances(self, grads, target_grads):
        raise NotImplementedError


def _per_trial_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.dim())))


class CosineSimilarity(GradientLoss):
    def gradient_based_loss(self, grads, target_grads):
        product = sum((g * t).sum() for g, t in zip(grads, target_grads))
        rec_norm = sum((g * g).sum() for g in grads)
        data_norm = sum((t * t).sum() for t in target_grads)
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def trial_distances(self, grads, target_grads):
        product = sum(_per_trial_sum(g * t) for g, t in zip(grads, target_grads))
        rec_norm = sum(_per_trial_sum(g * g) for g in grads)
        data_norm = sum(_per_trial_sum(t * t) for t in target_grads)
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def __repr__(self):
        return f"Cosine Similarity with scale={self.scale} and task reg={self.task_regularization}"


class FusedCosineSimilarity(CosineSimilarity):
    """Cosine matching over the flattened gradient through kernels B1 (one-pass
    sums) and B2 (its backward), ``breaching_tpu_torch/ops/matching.py``. For T
    trials, one B1 and one B2 launch per trial, on that trial's row of the flattened
    gradient. The flattened target is kept for as long as the target is the same
    object: one row per trial for ``trials``."""

    def __init__(self, scale=1.0, task_regularization=0.0, **kwargs):
        super().__init__(scale, task_regularization)
        self._target, self._flat_target = None, None

    def gradient_based_loss(self, grads, target_grads):
        if self._target is not target_grads:  # the target is fixed for a whole attack
            self._target = target_grads
            self._flat_target = torch.cat([t.reshape(-1) for t in target_grads])
        rec = torch.cat([g.reshape(-1) for g in grads])
        return fused_cosine_similarity(rec, self._flat_target) * self.scale

    def trial_distances(self, grads, target_grads):
        num_trials = grads[0].shape[0]
        if self._target is not target_grads:
            self._target = target_grads
            self._flat_target = torch.cat([t.reshape(num_trials, -1) for t in target_grads], dim=1)
        rec = torch.cat([g.reshape(num_trials, -1) for g in grads], dim=1)
        return torch.stack([fused_cosine_similarity(r, d) for r, d in
                            zip(rec.unbind(), self._flat_target.unbind())]) * self.scale

    def __repr__(self):
        return f"Fused (CUDA) Cosine Similarity with scale={self.scale}"


objective_lookup = {
    "cosine-similarity": CosineSimilarity,
    "fused-cosine-similarity": FusedCosineSimilarity,
}
