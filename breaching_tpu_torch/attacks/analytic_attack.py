"""Analytic attacks (counterpart of ``breaching_tpu/attacks/analytic_attack.py``): the FC
inversion of a linear model (``AnalyticAttacker``, ``attack_type: analytic``), the
readout of a malicious imprint block (``ImprintAttacker``, ``imprint-readout``) and
APRIL's closed-form inversion of a ViT (``AprilAttacker``, ``april-analytic``). On text the
imprint readout's rows are token embeddings, matched to the payload's vocabulary.

The first two are a few tensor operations on the user's gradient, a product, a
difference, a division and a selection, run where the gradient lies. The readout's
weight-over-bias division cancels the common factor of a bin's rows only if both were
computed in full float32: ``system_startup`` turns TF32 off on the card. The recovered
rows are in the JAX package's (H, W, C) order and are reshaped to NCHW here; a deep
placement's rows, read at a feature map smaller than the input, are resized to it with
``jax.image.resize``'s cubic interpolation (``cubic_resize``). Under
``handle_preceding_layers: VAE`` the server's decoder turns the rows into images first.
APRIL's two least-squares solves run in float64 on the host with ``numpy.linalg.lstsq``, as
the JAX package runs them.
"""

from __future__ import annotations

import logging

import numpy as np
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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel (a = -0.5) at distances x >= 0, as jax.image's."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """jax.image's (in_size, out_size) weights of a cubic resize with antialiasing:
    half-pixel sample positions, the kernel widened by the scale where it shrinks, each
    output's weights divided by their sum (0 where the sum is within 1000 float32 eps of
    0), and 0 for a sample outside the input."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32, device=device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    weights = _keys_cubic(x / torch.clamp(inv_scale, min=1.0))
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def cubic_resize(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW images resized to ``size`` (H, W) as ``jax.image.resize(..., "cubic")``
    resizes NHWC ones: separable Keys cubic weights, one contraction per spatial axis."""
    wh = _cubic_weights(x.shape[2], int(size[0]), x.device).to(x.dtype)
    ww = _cubic_weights(x.shape[3], int(size[1]), x.device).to(x.dtype)
    return torch.einsum("nchw,hy,wz->ncyz", x, wh, ww)


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
        data, _ = self.readout(server_payload, self._shared_data_cache, server_secrets, rec_models)
        return dict(data=data, labels=labels), stats

    def readout(self, server_payload, shared_data, server_secrets, rec_models=None):
        """(the recovered NCHW images, or on text the (N, T) tokens, and the bins they were
        read from) of the first query's gradient, after
        ``prepare_attack``."""
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
        return self._reformat_data(layer_inputs, secrets, rec_models), bins

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

    def _reformat_data(self, layer_inputs, secrets, rec_models):
        """The rows as NCHW images of the data's first three channels, clipped to the
        normalized box; on text, (seq, D) embeddings re-identified as the payload's nearest
        tokens. Where the secrets hold a ``decoder``, the rows, reshaped to NHWC maps of
        ``secrets["shape"]``, are decoded to images first (the JAX package hands the top
        placement's flat rows to its ``decode``, which then fails: ROADMAP Queue C)."""
        if self.modality == "text":
            from .auxiliaries.text_utils import match_embeddings_to_tokens

            inputs = layer_inputs.reshape(layer_inputs.shape[0], *secrets["shape"])
            return match_embeddings_to_tokens(rec_models[0], inputs)
        h, w, c = secrets["shape"]
        if "decoder" in secrets:  # images decoded from the rows, NHWC, whose shape then holds
            layer_inputs = secrets["decoder"](layer_inputs.reshape(layer_inputs.shape[0], h, w, c))
            h, w, c = layer_inputs.shape[1:]
        inputs = layer_inputs.reshape(layer_inputs.shape[0], h, w, c)[..., :3].permute(0, 3, 1, 2)
        if tuple(inputs.shape[2:]) != tuple(self.data_shape[1:]):
            inputs = cubic_resize(inputs, self.data_shape[1:])
        dm, ds = self.dm.reshape(1, -1, 1, 1), self.ds.reshape(1, -1, 1, 1)
        return torch.clamp(inputs, -dm / ds, (1 - dm) / ds)


class AprilAttacker(AnalyticAttacker):
    """APRIL's closed-form inversion of a ViT whose first block has no norm and no
    residuals (reference: analytic_attack.py:827-896; JAX ``AprilAttacker``): two
    least-squares solves, attention then patch embedding, and the patches tiled back into
    an image. The image fills slot 0 of a batch of ``num_data_points`` zeros, or, against
    the fishing server (``server_secrets["ClassAttack"]``), the target's slot of the whole
    batch, with every label of the batch."""

    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        shared_data = self._shared_data_cache
        len_data = int(shared_data[0]["metadata"]["num_data_points"] or 1)
        x = self.closed_form_april(rec_models[0], shared_data[0]).to(self.dm.device)
        dm, ds = self.dm.reshape(-1, 1, 1), self.ds.reshape(-1, 1, 1)
        inputs = torch.clamp(x, -dm / ds, (1 - dm) / ds)
        data = inputs.new_zeros((len_data, *inputs.shape))
        data[0] = inputs
        reconstructed = dict(data=data, labels=labels)
        if server_secrets and "ClassAttack" in server_secrets:
            info = server_secrets["ClassAttack"]
            full = inputs.new_zeros((int(info["true_num_data"]), *inputs.shape))
            full[int(np.asarray(info["target_indx"]).reshape(-1)[0])] = inputs
            reconstructed = dict(data=full, labels=torch.as_tensor(info["all_labels"], device=inputs.device))
        return reconstructed, stats

    @staticmethod
    def closed_form_april(model, shared_data) -> torch.Tensor:
        """The (C, H, W) image, float32, from the payload model and the user's gradient
        (reference: closed_form_april, analytic_attack.py:869-896). Both solves in float64:
        the second inverts a poorly conditioned (P*P*C x D) embedding."""
        module = model.module
        if not hasattr(module, "april_refs"):
            raise ValueError(f"Model {getattr(module, 'name', type(module).__name__)} has no april_refs: APRIL "
                             f"inverts the ViT's first block (vit_base_april, vit_small_april).")
        as64 = lambda refs: {k: v.detach().cpu().double().numpy() for k, v in refs.items()}
        refs, g_refs = as64(module.april_refs(model.params)), as64(module.april_refs(shared_data["gradients"]))
        q_w, k_w, v_w = np.split(refs["qkv_kernel"], 3, axis=1)    # (D, 3D): flax's (in, out)
        q_g, k_g, v_g = np.split(g_refs["qkv_kernel"], 3, axis=1)
        b = q_w @ q_g.T + k_w @ k_g.T + v_w @ v_g.T                 # (D, D)
        a = g_refs["pos_embed"][0]                                  # (T, D)
        log.info(f"Attention Inversion: ||A||={np.linalg.norm(a):.3f}, ||b||={np.linalg.norm(b):.3f}")
        z = np.linalg.lstsq(a.T, b, rcond=None)[0] - refs["pos_embed"][0]
        x = z[1:] - refs["patch_bias"]                              # the patch tokens, without the class token
        em_w = refs["patch_kernel"]                                 # (P*P*C, D)
        log.info(f"Embedding Inversion: ||A||={np.linalg.norm(em_w):.3f}, ||b||={np.linalg.norm(x):.3f}")
        patches = np.linalg.lstsq(em_w.T, x.T, rcond=None)[0]       # (P*P*C, T-1)
        return torch.as_tensor(module.april_retile(patches.astype(np.float32)))
