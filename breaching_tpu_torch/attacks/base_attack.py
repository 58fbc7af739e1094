"""Shared attack machinery (counterpart of ``breaching_tpu/attacks/base_attack.py``):
payload ingestion, gradient normalization, label recovery and candidate set-up.
The label strategies ``iDLG``, ``analytic``, ``yin``, ``wainakh-simple``,
``wainakh-whitebox``, ``bias-corrected``, ``random`` and, on a text payload,
``bias-text`` (the num_data_points x seq_len tokens from the decoder bias's gradient,
seeded with the tokens whose embedding rows received gradient) are ported; without a
strategy (``label_strategy`` unset) the labels stay None, as in the JAX package;
``exhaustive`` raises the JAX package's ``ValueError``.

A text payload (``modality`` text) goes through ``text_utils.prepare_text_attack`` after
the gradients are cast and normalized; without shared labels its tokens come from
``text_utils.recover_token_information`` where ``attack.token_strategy`` is set, else
from the label strategy. ``random``, and the padding of a strategy that finds too few
labels, draw from ``setup["python_rng"]`` (numpy). ``wainakh-whitebox`` measures the
impact of one example on the head's gradient with fake images (``_fake_data``: standard
normal, from a CPU generator seeded from the setup's, so that the CPU and the card see
the same draws).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
from torch.func import functional_call

from ..cases.models.model_preparation import head_grads, head_keys
from ..utils import model_dtype
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
        if self.modality not in ("vision", "text"):
            raise NotImplementedError(f"{self.modality} attacks are not ported yet.")
        # the normalization in the model's type: float64 where the JAX package's x64 makes
        # its mean and std float64
        stats = dict(dtype=model_dtype(self.setup), device=device)
        if self.modality == "text":
            self.dm, self.ds = torch.zeros(1, **stats), torch.ones(1, **stats)
        elif metadata.get("mean") is not None:
            self.dm = torch.as_tensor(metadata.mean, **stats)
            self.ds = torch.as_tensor(metadata.std, **stats)
        else:
            self.dm = torch.zeros(self.data_shape[0], **stats)
            self.ds = torch.ones(self.data_shape[0], **stats)

        rec_models = self._construct_models_from_payload_and_buffers(server_payload, shared_data)
        shared_data = self._cast_shared_data(shared_data)
        if self.cfg.normalize_gradients:
            shared_data = self._normalize_gradients(shared_data)
        if self.modality == "text":
            from .auxiliaries.text_utils import prepare_text_attack

            shared_data = prepare_text_attack(self, shared_data, rec_models)
        self._shared_data_cache = shared_data

        labels = self._shared_data_cache[0]["metadata"]["labels"]
        if labels is None:
            if self.modality == "text" and self.cfg.get("token_strategy"):
                from .auxiliaries.text_utils import recover_token_information

                labels = recover_token_information(self, self._shared_data_cache, server_payload, rec_models[0])
            else:
                labels = self._recover_label_information(self._shared_data_cache, rec_models)
        return rec_models, None if labels is None else torch.as_tensor(labels, device=device), stats

    def _construct_models_from_payload_and_buffers(self, server_payload, shared_data):
        """Bind payload parameters and the best available buffers: user-shared
        buffers, else server-provided buffers, else the template's, with BatchNorm
        then in train mode (reference base_attack.py:178-203)."""
        device, dtype = self.setup["device"], model_dtype(self.setup)
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
        """The target gradients in the setup's dtype (reference base_attack.py:105-110):
        under ``case.impl.dtype=bfloat16`` bfloat16 targets beside the float32 model, whose
        candidate gradients stay float32 (JAX's promotion of a bfloat16 candidate through
        float32 parameters); under float64 everything is float64."""
        device, dtype = self.setup["device"], self.setup["dtype"]
        for data in shared_data:
            data["gradients"] = {k: g.to(device=device, dtype=dtype)
                                 for k, g in data["gradients"].items()}
        return shared_data

    def _normalize_gradients(self, shared_data, fudge_factor=1e-6):
        """Scale each query's gradient to unit norm (reference base_attack.py:112-120)."""
        for data in shared_data:
            grads = data["gradients"]
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = 1.0 / torch.maximum(norm, torch.full_like(norm, fudge_factor))
            data["gradients"] = {k: g * scale for k, g in grads.items()}
        return shared_data

    def _initialize_data(self, data_shape):
        return init_candidate(self.setup["generator"], self.cfg.init, data_shape, dtype=self.setup["dtype"],
                              device=self.setup["device"], mean=self.dm, std=self.ds,
                              text=getattr(self, "modality", "vision") == "text")

    def _recover_label_information(self, user_data, rec_models=None):
        """Label recovery from the classification head's gradients (reference
        base_attack.py:143-253), on the host in numpy; ``wainakh-whitebox`` also runs
        ``rec_models[0]`` on fake data."""
        strategy = self.cfg.label_strategy
        if strategy is None or str(strategy).lower() == "none":
            return None
        if strategy == "bias-text" and getattr(self, "modality", None) != "text":
            raise NotImplementedError("Label strategy bias-text recovers a text payload's tokens; it is not "
                                      "ported for other payloads.")
        num_data_points = int(user_data[0]["metadata"]["num_data_points"])
        grads = [tuple(t.detach().cpu().numpy() for t in head_grads(d["gradients"], self.model_template))
                 for d in user_data]
        num_classes, num_queries = grads[0][1].shape[0], len(user_data)
        if strategy == "iDLG":
            labels = np.unique([int(np.argmin(w.sum(axis=1))) for w, _ in grads])
        elif strategy == "analytic":
            labels = np.unique([i for _, b in grads for i in np.nonzero(b < 0)[0].tolist()])[:num_data_points]
        elif strategy == "yin":
            labels = np.argsort(sum(w.min(axis=1) for w, _ in grads))[:num_data_points]
        elif strategy in ("wainakh-simple", "wainakh-whitebox"):
            if strategy == "wainakh-simple":
                m_impact = 0.0
                for w, _ in grads:
                    g_i = w.sum(axis=1)
                    m_impact += np.where(g_i < 0, g_i, 0).sum() * (1 + 1 / num_classes) / num_data_points / num_queries
                s_offset = np.zeros(num_classes)
            else:
                m_impact, s_offset = self._wainakh_whitebox_estimates(rec_models, num_data_points, num_classes,
                                                                      num_queries)
            g_i = np.stack([w.sum(axis=1) for w, _ in grads]).mean(axis=0).copy()
            selected = []
            for idx in range(num_classes):
                if g_i[idx] < 0:
                    selected.append(idx)
                    g_i[idx] -= m_impact
            g_i = g_i - s_offset
            while len(selected) < num_data_points:
                idx = int(np.argmin(g_i))
                selected.append(idx)
                g_i[idx] -= m_impact
            labels = np.asarray(selected)
        elif strategy == "exhaustive":
            raise ValueError(
                f"Exhaustive label searching is not implemented — a naive search here would "
                f"try {num_classes ** num_data_points} label vectors.")
        elif strategy == "bias-corrected":
            avg_bias = np.stack([b for _, b in grads]).mean(axis=0).copy()
            valid = np.nonzero(avg_bias < 0)[0]
            selected = valid.tolist()
            m_impact = avg_bias[valid].sum() / max(num_data_points, 1)
            avg_bias[valid] -= m_impact
            while len(selected) < num_data_points:
                idx = int(np.argmin(avg_bias))
                selected.append(idx)
                avg_bias[idx] -= m_impact
            labels = np.asarray(selected)
        elif strategy == "bias-text":
            return self._bias_text(user_data, grads, num_data_points)
        elif strategy == "random":
            labels = self.setup["python_rng"].integers(0, num_classes, num_data_points)
        else:
            raise ValueError(f"Invalid label recovery strategy {strategy} given.")
        labels = np.asarray(labels).reshape(-1)
        if len(labels) < num_data_points:  # too few found: random labels fill the rest
            fill = self.setup["python_rng"].integers(0, num_classes, num_data_points - len(labels))
            labels = np.concatenate([labels, fill])
        labels = np.sort(labels[:num_data_points])
        log.info(f"Recovered labels {labels.tolist()} through strategy {strategy}.")
        return labels

    def _bias_text(self, user_data, grads, num_data_points):
        """``bias-text`` (reference base_attack.py:426-452): the tokens whose decoder-bias
        gradient is negative, then those whose embedding row in the first query's gradient
        is nonzero (after ``prepare_text_attack``, which zeroes that leaf, none), then the
        least bias gradient, each pick lowering it by the mean impact; (N, seq_len)."""
        num_missing = num_data_points * int(self.data_shape[0])
        avg_bias = np.stack([b for _, b in grads]).mean(axis=0).copy()
        valid = np.nonzero(avg_bias < 0)[0]
        selected = valid.tolist()
        embedding = self.model_template.registry["embedding"]
        rows = user_data[0]["gradients"][embedding].detach().cpu().numpy()
        for token in np.nonzero(np.linalg.norm(rows, axis=-1) > 0)[0].tolist():
            if token not in selected:
                selected.append(token)
        m_impact = avg_bias[valid].sum() / max(num_missing, 1)
        avg_bias[valid] -= m_impact
        while len(selected) < num_missing:
            idx = int(np.argmin(avg_bias))
            selected.append(idx)
            avg_bias[idx] -= m_impact
        log.info(f"Recovered {num_missing} tokens through strategy bias-text.")
        return np.asarray(selected[:num_missing]).reshape(num_data_points, int(self.data_shape[0]))

    def _fake_data(self, generator, index, count):
        """``count`` standard normal images of the data's shape, the fake data of
        ``wainakh-whitebox``'s draw ``index``: drawn on the CPU from ``generator`` and
        moved to the attack's device."""
        return torch.randn(count, *self.data_shape, generator=generator).to(self.setup["device"])

    def _wainakh_whitebox_estimates(self, rec_models, num_data_points, num_classes, num_queries):
        """The impact of one example on the head's weight gradient, measured on fake
        data (reference base_attack.py:359-386; the JAX package's sweeps at
        breaching_tpu/attacks/base_attack.py:256-300). With BatchNorm in eval mode on the
        first payload: m, the sum over classes c of the head's weight gradient summed
        over its entries for n fake images all of class c, times (1 + 1/C) / n / C / Q;
        and s[c], the sum of row c of that gradient for C - 1 fake images of every
        other class, divided by C - 1 and by Q. The m sweep takes draws 0, ..., C - 1,
        the s sweep draws C, ..., 2C - 1."""
        model = rec_models[0]
        head_weight, _ = head_keys(model.module)
        head = model.params[head_weight].detach().requires_grad_(True)
        params = {k: head if k == head_weight else v.detach() for k, v in model.params.items()}
        seed = int(torch.randint(2 ** 62, (), generator=self.setup["generator"]))
        generator = torch.Generator().manual_seed(seed)
        device = head.device

        def head_weight_grad(data, labels):
            outputs = functional_call(model.module, {**params, **model.buffers}, (data,), dict(train=False))
            grad, = torch.autograd.grad(self.loss_fn(outputs, labels), head)
            return grad

        m_sums = torch.stack([
            head_weight_grad(self._fake_data(generator, c, num_data_points),
                             torch.full((num_data_points,), c, dtype=torch.int64, device=device)).sum()
            for c in range(num_classes)])
        t = num_classes - 1
        all_labels = torch.arange(num_classes, device=device)
        s_sums = torch.stack([
            head_weight_grad(self._fake_data(generator, num_classes + c, t), all_labels[all_labels != c])[c].sum() / t
            for c in range(num_classes)])
        m_impact = float(m_sums.sum()) * (1 + 1 / num_classes) / num_data_points / num_classes / num_queries
        return m_impact, s_sums.cpu().numpy() / num_queries

