"""Shared attack machinery (counterpart of ``breaching_tpu/attacks/base_attack.py``):
payload ingestion and candidate set-up. Only user-provided labels are ported; label
recovery strategies are not.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from .auxiliaries.initializations import init_candidate

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PayloadModel:
    """The attacked architecture bound to one payload's parameters and buffers."""

    module: torch.nn.Module
    params: dict       # name -> tensor that requires grad (the user's gradient is taken over it)
    buffers: dict      # name -> tensor
    bn_train: bool     # BatchNorm on the candidate's batch statistics


class _BaseAttacker:
    def __init__(self, model, loss_fn, cfg_attack, setup):
        self.model_template = model
        self.loss_fn = loss_fn
        self.cfg = cfg_attack
        self.setup = setup

    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        raise NotImplementedError

    def prepare_attack(self, server_payload, shared_data):
        """Basic startup common to all attacks (reference: base_attack.py:43-74).

        Returns (rec_models, labels, stats).
        """
        stats = dict()
        shared_data = list(shared_data)
        server_payload = list(server_payload)
        device = self.setup["device"]

        metadata = server_payload[0]["metadata"]
        self.data_shape = tuple(metadata.shape)  # (C, H, W)
        self.modality = metadata.modality
        if self.modality != "vision":
            raise NotImplementedError(f"{self.modality} attacks are not ported yet.")
        if metadata.get("mean") is not None:
            self.dm = torch.as_tensor(metadata.mean, dtype=torch.float32, device=device)
            self.ds = torch.as_tensor(metadata.std, dtype=torch.float32, device=device)
        else:
            self.dm = torch.zeros(self.data_shape[0], device=device)
            self.ds = torch.ones(self.data_shape[0], device=device)

        if self.cfg.normalize_gradients:
            raise NotImplementedError("normalize_gradients is not ported yet.")
        rec_models = self._construct_models_from_payload_and_buffers(server_payload, shared_data)
        self._shared_data_cache = self._cast_shared_data(shared_data)

        labels = self._shared_data_cache[0]["metadata"]["labels"]
        if labels is None:
            raise NotImplementedError("Label recovery is not ported yet; the user must provide labels.")
        return rec_models, torch.as_tensor(labels, device=device), stats

    def _construct_models_from_payload_and_buffers(self, server_payload, shared_data):
        """Bind payload parameters and the best available buffers: user-shared
        buffers, else server-provided buffers, else the template's, with BatchNorm
        then in train mode (reference base_attack.py:178-203)."""
        device, dtype = self.setup["device"], self.setup["dtype"]
        has_batchnorm = any(True for _ in self.model_template.buffers())
        models = []
        for idx, payload in enumerate(server_payload):
            user_buffers = shared_data[idx]["buffers"] if idx < len(shared_data) else None
            if user_buffers is not None:
                buffers, bn_train = user_buffers, False
            elif payload["buffers"] is not None:
                buffers, bn_train = payload["buffers"], False
            else:
                buffers = dict(self.model_template.named_buffers())
                bn_train = has_batchnorm
            params = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
                      for k, v in payload["parameters"].items()}
            buffers = {k: v.detach().to(device=device, dtype=dtype) for k, v in buffers.items()}
            models.append(PayloadModel(self.model_template, params, buffers, bn_train))
        return models

    def _cast_shared_data(self, shared_data):
        device, dtype = self.setup["device"], self.setup["dtype"]
        for data in shared_data:
            data["gradients"] = {k: g.to(device=device, dtype=dtype)
                                 for k, g in data["gradients"].items()}
        return shared_data

    def _initialize_data(self, data_shape):
        return init_candidate(self.setup["generator"], self.cfg.init, data_shape,
                              dtype=self.setup["dtype"], device=self.setup["device"])
