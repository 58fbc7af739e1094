"""Analytic attacks (counterpart of ``breaching_tpu/attacks/analytic_attack.py``): the FC
inversion of a linear model (``AnalyticAttacker``, ``attack_type: analytic``) and the
readout of a malicious imprint block (``ImprintAttacker``, ``imprint-readout``).

Both are a few tensor operations on the user's gradient, a product, a difference, a
division and a selection, run where the gradient lies. The readout's weight-over-bias
division cancels the common factor of a bin's rows only if both were computed in full
float32: ``system_startup`` turns TF32 off on the card. The recovered rows are in the JAX
package's (H, W, C) order and are reshaped to NCHW here. ``AprilAttacker`` (it needs the
ViT) is not ported.
"""

from __future__ import annotations

import logging

import torch

from ..cases.models.model_preparation import head_grads
from .base_attack import _BaseAttacker

log = logging.getLogger(__name__)


def invert_fc_layer(weight_grad, bias_grad, image_positions=None, eps=1e-12):
    """The input to a linear layer as weight_grad / bias_grad, row by row (reference:
    analytic_attack.py:51-62); weight_grad is (out, in), bias_grad (out,), rows whose bias
    gradient is within ``eps`` of 0 divide by infinity. With one image position, the mean
    of the valid rows; with several, those rows."""
    safe_bias = torch.where(bias_grad.abs() > eps, bias_grad, torch.full_like(bias_grad, float("inf")))
    intermediates = weight_grad / safe_bias[:, None]
    if image_positions is None or len(image_positions) == 0:
        return intermediates
    if len(image_positions) == 1:
        valid = (bias_grad.abs() > eps).to(weight_grad.dtype)
        return (intermediates * valid[:, None]).sum(dim=0) / torch.clamp(valid.sum(), min=1)
    return intermediates[torch.as_tensor(image_positions, device=weight_grad.device).long()]


class AnalyticAttacker(_BaseAttacker):
    """The analytic inversion of a linear model, the sanity check (reference:
    analytic_attack.py:17-62)."""

    def __repr__(self):
        return f"Attacker (of type {self.__class__.__name__})."

    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        shared_data = self._shared_data_cache
        num_points = int(shared_data[0]["metadata"]["num_data_points"] or len(labels))
        c, h, w = self.data_shape
        inputs_from_queries = []
        for model, user_data in zip(rec_models, shared_data):
            w_grad, b_grad = head_grads(user_data["gradients"], model.module)
            if labels is not None and num_points > 1:
                layer_inputs = invert_fc_layer(w_grad, b_grad, labels.cpu().tolist())
            else:
                layer_inputs = invert_fc_layer(w_grad, b_grad, [0])[None]
            inputs_from_queries.append(layer_inputs.reshape(num_points, h, w, c).permute(0, 3, 1, 2))
        final = torch.stack(inputs_from_queries).mean(dim=0)
        return dict(data=final, labels=labels), stats


class ImprintAttacker(AnalyticAttacker):
    """The readout of a malicious imprint block (reference: analytic_attack.py:65-153),
    from ``server_secrets["ImprintBlock"]``: the names of the block's first layer's weight
    (bins, inputs) and bias, the (H, W, C) shape it sees and its bin structure."""

    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        data, _ = self.readout(server_payload, self._shared_data_cache, server_secrets)
        return dict(data=data, labels=labels), stats

    def readout(self, server_payload, shared_data, server_secrets):
        """(the recovered NCHW images, the bins they were read from) of the first query's
        gradient, after ``prepare_attack``."""
        if not server_secrets or "ImprintBlock" not in server_secrets:
            raise ValueError("No imprint hidden in this model according to the server.")
        secrets = server_secrets["ImprintBlock"]
        grads = shared_data[0]["gradients"]
        weight_grad, bias_grad = grads[secrets["weight_name"]], grads[secrets["bias_name"]]
        if self.cfg.get("sort_by_bias"):
            params_bias = server_payload[0]["parameters"][secrets["bias_name"]].to(bias_grad.device)
            order = torch.argsort(-params_bias, stable=True)
            weight_grad, bias_grad = weight_grad[order], bias_grad[order]
        if secrets["structure"] == "cumulative":  # bin i minus bin i - 1
            weight_grad = torch.cat([weight_grad[:1], weight_grad[1:] - weight_grad[:-1]])
            bias_grad = torch.cat([bias_grad[:1], bias_grad[1:] - bias_grad[:-1]])
        layer_inputs, bins = self._reduce_hits(invert_fc_layer(weight_grad, bias_grad), weight_grad, bias_grad,
                                               shared_data)
        return self._reformat_data(layer_inputs, secrets), bins

    def _reduce_hits(self, layer_inputs, weight_grad, bias_grad, shared_data):
        """The rows of the ``num_data_points`` lowest scores (|bias gradient| with
        ``breach_reduction: bias``, |mean weight gradient| otherwise; rows whose bias
        gradient is within 1e-12 of 0 score infinity), ties to the lower row as
        ``jax.lax.top_k`` breaks them, in row order, zero-padded to ``num_data_points``
        with ``breach_padding`` (reference: analytic_attack.py:105-128). Returns (the rows,
        their indices in the sorted and de-cumulated bins)."""
        len_data = int(shared_data[0]["metadata"]["num_data_points"] or layer_inputs.shape[0])
        valid = bias_grad.abs() > 1e-12
        log.info(f"Initially produced {int(valid.sum())} hits.")
        if self.cfg.get("breach_reduction", "weight") == "bias":
            score = bias_grad.abs()
        else:  # "weight": robust under DP noise
            score = weight_grad.mean(dim=1).abs()
        score = torch.where(valid, score, torch.full_like(score, float("inf")))
        k = min(len_data, layer_inputs.shape[0])
        best = torch.sort(torch.sort(score, stable=True).indices[:k]).values
        chosen = layer_inputs[best]
        if len_data > k and self.cfg.get("breach_padding", True):
            chosen = torch.cat([chosen, chosen.new_zeros((len_data - k, *chosen.shape[1:]))])
        return chosen, best

    def _reformat_data(self, layer_inputs, secrets):
        """The rows as NCHW images of the data's first three channels, clipped to the
        normalized box."""
        h, w, c = secrets["shape"]
        inputs = layer_inputs.reshape(layer_inputs.shape[0], h, w, c)[..., :3].permute(0, 3, 1, 2)
        if tuple(inputs.shape[2:]) != tuple(self.data_shape[1:]):
            raise NotImplementedError(
                f"The cubic resize of an imprint readout at {(h, w)} to the data's {tuple(self.data_shape[1:])} "
                f"(a deep placement whose feature map is smaller than the input) is not ported yet.")
        dm, ds = self.dm.reshape(1, -1, 1, 1), self.ds.reshape(1, -1, 1, 1)
        return torch.clamp(inputs, -dm / ds, (1 - dm) / ds)
