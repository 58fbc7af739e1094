"""The fedSGD and fedAVG users (counterparts of ``breaching_tpu/cases/users.py``
``UserSingleStep`` and ``UserMultiStep``).

The fedSGD update is ``torch.autograd.grad`` of the task loss over the payload's
parameters, evaluated with ``torch.func.functional_call`` on the user's copy of
the architecture; the fedAVG update is the parameter delta after several local SGD
steps of that kind. BatchNorm follows the JAX package: with server-provided buffers
the model runs in eval mode on them; without, it runs in train mode and the
user's running statistics (cumulative, so exactly its batch statistics after one
step, and carried from one local step to the next) are shared. Local DP noise and
per-example clipping are not ported, nor is ``MultiUserAggregate``: a config that
asks for them is refused.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import functional_call

from .data import construct_dataloader

log = logging.getLogger(__name__)


def construct_user(model, loss_fn, cfg_case, setup):
    """User factory (reference: breaching/cases/users.py:13-28)."""
    cfg_user = cfg_case.user
    user_types = {"local_gradient": UserSingleStep, "local_update": UserMultiStep}
    if cfg_user.user_type not in user_types:
        raise NotImplementedError(f"User type {cfg_user.user_type} is not ported yet.")
    dataloader = construct_dataloader(cfg_case.data, cfg_case.impl, user_idx=cfg_user.user_idx)
    return user_types[cfg_user.user_type](model, loss_fn, dataloader, setup, cfg_user.user_idx, cfg_user)


class UserSingleStep:
    """A fedSGD user sharing a single batch gradient."""

    def __init__(self, model, loss_fn, dataloader, setup, idx, cfg_user):
        self.model = model
        self.loss = loss_fn
        self.dataloader = dataloader
        self.setup = setup
        self.user_idx = idx
        self.cfg = cfg_user
        self.num_data_points = int(cfg_user.num_data_points)
        self.provide_labels = bool(cfg_user.provide_labels)
        self.provide_buffers = bool(cfg_user.provide_buffers)
        self.provide_num_data_points = bool(cfg_user.provide_num_data_points)
        ldp = cfg_user.local_diff_privacy
        for key in ("gradient_noise", "input_noise", "per_example_clipping"):
            if float(ldp.get(key, 0.0) or 0.0) > 0:
                raise NotImplementedError(f"local_diff_privacy.{key} > 0 is not ported yet.")
        self.counted_queries = 0

    def __repr__(self):
        return f"""User (of type {self.__class__.__name__}):
    Number of data points: {self.num_data_points}
    Threat model: labels {self.provide_labels}, buffers {self.provide_buffers}, n {self.provide_num_data_points}
    Dataset: {self.dataloader.name}, user idx {self.user_idx}"""

    def compute_local_updates(self, server_payload, custom_data=None):
        self.counted_queries += 1
        inputs, labels = self._user_tensors(custom_data)
        parameters = server_payload["parameters"]
        bn_train, local_buffers = self._local_buffers(server_payload["buffers"])

        params = {k: v.detach().requires_grad_(True) for k, v in parameters.items()}
        outputs = functional_call(self.model, {**params, **local_buffers}, (inputs,),
                                  dict(train=bn_train))
        loss = self.loss(outputs, labels)
        grads = torch.autograd.grad(loss, tuple(params.values()))
        grads = {k: g.detach() for k, g in zip(params, grads)}

        shared_buffers = local_buffers if bn_train else None
        metadata = dict(
            num_data_points=self.num_data_points if self.provide_num_data_points else None,
            labels=torch.sort(labels).values if self.provide_labels else None,
            local_hyperparams=None,
            data_key="inputs",
        )
        shared_data = dict(
            gradients=grads,
            buffers=shared_buffers if self.provide_buffers else None,
            metadata=metadata,
        )
        true_user_data = dict(data=inputs, labels=labels, buffers=shared_buffers)
        return shared_data, true_user_data

    def _user_tensors(self, custom_data):
        """The user's inputs and labels on its device."""
        data = self._load_data() if custom_data is None else custom_data
        device = self.setup["device"]
        return (torch.as_tensor(data["inputs"], dtype=self.setup["dtype"], device=device),
                torch.as_tensor(data["labels"], dtype=torch.int64, device=device))

    def _local_buffers(self, buffers):
        """(BatchNorm in train mode, the user's copy of the buffers): eval mode on the
        server's buffers where it sends them, else train mode on the model's own."""
        bn_train = buffers is None and any(True for _ in self.model.buffers())
        # train mode updates the running statistics in place: work on copies
        local_buffers = {k: v.clone() for k, v in (
            buffers.items() if buffers is not None else self.model.named_buffers())}
        log.info(f"Computing user update on user {self.user_idx} in model mode: "
                 f"{'training' if bn_train else 'eval'}.")
        return bn_train, local_buffers

    def _load_data(self):
        """Draw `num_data_points` examples from this user's partition
        (reference: users.py:200-227)."""
        blocks, num_samples = [], 0
        for block in self.dataloader:
            blocks.append(block)
            num_samples += block["labels"].shape[0]
            if num_samples >= self.num_data_points:
                break
        if num_samples < self.num_data_points:
            raise ValueError(
                f"User {self.user_idx} does not have the requested {self.num_data_points} samples "
                f"(only {num_samples} available).")
        return {
            key: np.concatenate([b[key] for b in blocks])[: self.num_data_points]
            for key in blocks[0]
        }


class UserMultiStep(UserSingleStep):
    """A fedAVG user: several local SGD steps, shares the parameter delta (reference
    ``breaching_tpu/cases/users.py:270-370``).

    Step k trains on the user's examples (k·m + j) mod N, j < m, with m examples per
    step and N in all. The shared labels are the user's in data order; the local
    hyperparameters carry each step's labels sorted, as the JAX package shares them.
    """

    def __init__(self, model, loss_fn, dataloader, setup, idx, cfg_user):
        super().__init__(model, loss_fn, dataloader, setup, idx, cfg_user)
        self.num_local_updates = int(cfg_user.num_local_updates)
        self.num_data_per_local_update_step = int(cfg_user.num_data_per_local_update_step)
        self.local_learning_rate = float(cfg_user.local_learning_rate)
        self.provide_local_hyperparams = bool(cfg_user.provide_local_hyperparams)

    def __repr__(self):
        return (super().__repr__() +
                f"\n    Local steps: {self.num_local_updates}, data per step: "
                f"{self.num_data_per_local_update_step}, lr: {self.local_learning_rate} "
                f"(hyperparams shared: {self.provide_local_hyperparams})")

    def compute_local_updates(self, server_payload, custom_data=None):
        self.counted_queries += 1
        inputs, labels = self._user_tensors(custom_data)
        parameters = server_payload["parameters"]
        bn_train, local_buffers = self._local_buffers(server_payload["buffers"])

        per_step = self.num_data_per_local_update_step
        idx = (torch.arange(self.num_local_updates * per_step, device=labels.device)
               % self.num_data_points).reshape(self.num_local_updates, per_step)
        params = {k: v.detach() for k, v in parameters.items()}
        for step_idx in idx:
            current = {k: v.requires_grad_(True) for k, v in params.items()}
            # the running statistics of train mode carry from step to step in local_buffers
            outputs = functional_call(self.model, {**current, **local_buffers}, (inputs[step_idx],),
                                      dict(train=bn_train))
            grads = torch.autograd.grad(self.loss(outputs, labels[step_idx]), tuple(current.values()))
            params = {k: (v - self.local_learning_rate * g).detach()
                      for (k, v), g in zip(current.items(), grads)}
        delta = {k: params[k] - parameters[k].detach() for k in params}

        shared_buffers = local_buffers if any(True for _ in self.model.buffers()) else None
        metadata = dict(
            num_data_points=self.num_data_points if self.provide_num_data_points else None,
            labels=labels if self.provide_labels else None,
            local_hyperparams=dict(
                lr=self.local_learning_rate,
                steps=self.num_local_updates,
                data_per_step=per_step,
                labels=[torch.sort(labels[step_idx]).values for step_idx in idx],
            ) if self.provide_local_hyperparams else None,
            data_key="inputs",
        )
        shared_data = dict(
            gradients=delta,
            buffers=shared_buffers if self.provide_buffers else None,
            metadata=metadata,
        )
        true_user_data = dict(data=inputs, labels=labels, buffers=shared_buffers)
        return shared_data, true_user_data
