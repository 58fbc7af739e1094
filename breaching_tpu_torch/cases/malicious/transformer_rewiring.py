"""Decepticon's parameter rewiring of a transformer (Fowl et al., "Decepticons";
counterpart of ``breaching_tpu/cases/malicious/transformer_rewiring.py``).

The edits are the JAX package's, made in numpy on float32 host copies of the parameters
and written back into the model where it lies, so that every written entry equals the
JAX package's (a kernel transposed: the registry's ``kernel_layout`` is ``out_in``):

- the embedding's components [0:v] are zeroed; a learned positional table's too, and its
  rows divided by the norm of their [v:2v] components;
- the first attention becomes a positional copy machine: the query bias carries the
  imprint position's key scaled by ``softmax_skew``, K = I, V moves the components
  [v:2v] into [0:v], so every token of a sentence receives the same sentence key. Q, K
  and V are one fused module (rows [q; k; v]) or, in the HuggingFace encoders, three
  (the registry's ``query``/``key``/``value`` dict); the positions are taken as the
  first block sees them, through the embedding LayerNorm where the registry names one
  (eps 1e-12 for every family, as in the JAX package), from the table's row
  ``pos_offset`` on (RoBERTa's 2);
- the middle attentions' outputs are zeroed and every second FF layer lets a tiny
  ``eps`` flow through;
- every first FF layer becomes a cumulative imprint layer: each hidden unit measures
  <FF input, probe> against Gaussian-CDF bins calibrated on the rewired model's own
  feature distribution (random tokens, or the server's external data);
- the last attention is zeroed (causal) or equalized (masked LM).

numpy's generators are the JAX package's: ``default_rng(seed)`` for the probes (and a
reset embedding), ``default_rng(1)`` for the calibration tokens, so both packages draw
the same numbers. The calibration's forward passes run where the model lies.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
from scipy.stats import norm as normal_dist

log = logging.getLogger(__name__)


class _HostParams:
    """The model's parameters by name as float32 numpy copies, each read from the model
    once; ``commit`` writes the copies back in place."""

    def __init__(self, model):
        self.named = dict(model.named_parameters())
        self.arrays = {}

    def __getitem__(self, name):
        if name not in self.arrays:
            self.arrays[name] = self.named[name].detach().cpu().numpy().copy()
        return self.arrays[name]

    def __setitem__(self, name, value):
        self.arrays[name] = np.asarray(value, np.float32)

    def commit(self):
        with torch.no_grad():
            for name, array in self.arrays.items():
                self.named[name].copy_(torch.from_numpy(array))


def _set_kernel(params, module, kernel_in_out, layout):
    """Write a kernel given in the (in, out) orientation of the JAX package's code."""
    params[f"{module}.weight"] = kernel_in_out.T if layout == "out_in" else kernel_in_out


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def positional_table(model, params, seq_len):
    """The pure positional encodings (seq_len, D) of a registered architecture, from
    ``params`` (parameter name -> tensor or array): a learned table's rows from the
    registry's ``pos_offset`` (RoBERTa's positions start at pad_token_id + 1)."""
    registry = getattr(model, "registry", {})
    pos_name = registry.get("pos_embedding")
    if pos_name is not None:
        offset = int(registry.get("pos_offset", 0))
        return _numpy(params[pos_name])[offset:offset + seq_len]
    from ..models.language_models import fixed_positional_encoding

    return fixed_positional_encoding(model.max_len, model.ninp)[:seq_len]


def reconfigure_transformer(model, loss_fn, cfg_server, cfg_data, setup, external_dataloader=None):
    """Apply the whole rewiring in place; returns (model, secrets). Registry-driven: any
    model whose ``registry`` names each layer's ``attention_qkv`` (a fused module, rows
    [q; k; v], or a dict of ``query``, ``key`` and ``value`` modules), ``attention_out``,
    ``ff_first`` and ``ff_second`` and the embedding's parameters."""
    registry = getattr(model, "registry", {})
    if not registry.get("attention_qkv"):
        raise ValueError(
            f"Transformer rewiring needs a populated architecture registry "
            f"(got {getattr(model, 'name', type(model).__name__)}); register attention/ff paths in model.aux first.")

    pmod = cfg_server.param_modification
    v_length = int(pmod.v_length)
    seq_len = int(cfg_data.shape[0])
    D, H = int(model.ninp), int(model.nhid)
    nlayers = int(registry.get("nlayers") or len(registry["attention_qkv"]))
    layout = registry.get("kernel_layout", "in_out")
    params = _HostParams(model)

    rng = np.random.default_rng(int(pmod.get("seed", 0) or 0))

    # --- measurement probes, one per layer (reference: servers.py:418-429) ---
    def make_measurement():
        probe_dim = D - v_length - 1
        weights = rng.standard_normal(probe_dim)
        probe = (weights - weights.mean()) / weights.std() / math.sqrt(probe_dim)
        probe = probe * float(pmod.measurement_scale)
        m = np.zeros(D, np.float32)
        m[v_length:-1] = probe
        return m

    measurements = [make_measurement() for _ in range(nlayers)]
    measurement = measurements[0]

    # --- embedding modifications (reference: partially_disable_embedding:60-67) ---
    if pmod.get("reset_embedding"):
        # N(0, 1), as torch's nn.Embedding.reset_parameters (reference servers.py:432-433)
        params[registry["embedding"]] = rng.standard_normal(params[registry["embedding"]].shape)
    params[registry["embedding"]][:, :v_length] = 0.0
    if registry.get("pos_embedding") is not None:
        pos = params[registry["pos_embedding"]]
        pos[:, :v_length] = 0.0
        norms = np.linalg.norm(pos[:, v_length:2 * v_length], axis=1, keepdims=True)
        params[registry["pos_embedding"]] = pos / np.maximum(norms, 1e-8)

    # the positions as the first block sees them (its attention biases carry them): through
    # the embedding LayerNorm where one exists (reference: set_MHA's norm_layer0(pos_encoder(zeros)))
    positions = positional_table(model, params, seq_len)
    norm0 = registry.get("embedding_norm")
    if norm0 is not None:
        mu = positions.mean(axis=-1, keepdims=True)
        var = positions.var(axis=-1, keepdims=True)
        attn_positions = ((positions - mu) / np.sqrt(var + 1e-12) * params[f"{norm0}.weight"]
                          + params[f"{norm0}.bias"])
    else:
        attn_positions = positions

    imprint_pos = int(pmod.imprint_sentence_position)
    softmax_skew = float(pmod.softmax_skew)

    def write_qkv(entry, q_kernel, q_bias, k_kernel, k_bias, v_kernel, v_bias):
        """Q, K and V through one fused module, rows [q; k; v], or a dict of three."""
        if isinstance(entry, dict):
            for name, kernel, bias in (("query", q_kernel, q_bias), ("key", k_kernel, k_bias),
                                       ("value", v_kernel, v_bias)):
                _set_kernel(params, entry[name], kernel, layout)
                params[f"{entry[name]}.bias"] = bias
            return
        _set_kernel(params, entry, np.concatenate([q_kernel, k_kernel, v_kernel], axis=1), layout)
        params[f"{entry}.bias"] = np.concatenate([q_bias, k_bias, v_bias])

    eye = np.eye(D, dtype=np.float32)
    zeros_dd, zeros_d = np.zeros((D, D), np.float32), np.zeros(D, np.float32)

    # --- first attention: positional copy machine (reference: _set_default_MHA) ---
    q_bias = np.zeros(D, np.float32)
    q_bias[v_length:2 * v_length] = softmax_skew * attn_positions[imprint_pos, v_length:2 * v_length]
    v_kernel = np.zeros((D, D), np.float32)
    v_kernel[v_length:2 * v_length, :v_length] = np.eye(v_length)
    v_bias = np.zeros(D, np.float32)
    v_bias[imprint_pos:imprint_pos + v_length] = -attn_positions[imprint_pos, v_length:2 * v_length]
    write_qkv(registry["attention_qkv"][0], zeros_dd, q_bias, eye, zeros_d, v_kernel, v_bias)

    first_out = registry["attention_out"][0]
    _set_kernel(params, first_out, float(pmod.sequence_token_weight) * eye, layout)
    params[f"{first_out}.bias"] = np.zeros_like(params[f"{first_out}.bias"])

    # --- second FF layers: tiny flow-through (reference: set_flow_backward_layer:239-252) ---
    eps = float(pmod.eps)
    for module in registry["ff_second"]:
        k = np.zeros((H, D), np.float32)
        k[:, -1] = eps / H
        _set_kernel(params, module, k, layout)
        params[f"{module}.bias"] = np.zeros_like(params[f"{module}.bias"])

    # --- middle attentions disabled (reference: disable_mha_layers:255-263) ---
    for module in registry["attention_out"][1:-1]:
        params[f"{module}.weight"] = np.zeros_like(params[f"{module}.weight"])
        params[f"{module}.bias"] = np.zeros_like(params[f"{module}.bias"])

    # --- last attention (reference: equalize_mha_layer:266-313) ---
    if nlayers > 1:
        last_out = registry["attention_out"][-1]
        if cfg_data.task == "masked-lm" and not cfg_data.get("disable_mlm", False):
            write_qkv(registry["attention_qkv"][-1], zeros_dd, zeros_d, eye, zeros_d, eye, zeros_d)
            _set_kernel(params, last_out, float(pmod.equalize_token_weight) * eye, layout)
        else:
            params[f"{last_out}.weight"] = np.zeros_like(params[f"{last_out}.weight"])
        params[f"{last_out}.bias"] = np.zeros_like(params[f"{last_out}.bias"])
    params.commit()

    # --- calibrate the feature distribution, then set the imprint bins ---
    # bin_setup (reference: servers.py:487-501): 'concatenate' spreads one measurement's
    # bins across all layers; 'separate' gives each layer its own probe and bin range;
    # 'repeat' reuses probe 0 with each layer's own calibration.
    bin_setup = str(pmod.get("bin_setup", "concatenate"))
    all_bins = []
    if bin_setup == "concatenate":
        mu, std = _feature_distribution(model, measurement, cfg_data, external_dataloader, layer=0)
        log.info(f"Feature mean is {mu:.4f}, feature std is {std:.4f}.")
        bins = _gaussian_bins(mu, std, H * nlayers)
        for i, module in enumerate(registry["ff_first"]):
            _set_kernel(params, module, np.tile(measurement[:, None], (1, H)), layout)
            params[f"{module}.bias"] = -np.asarray(bins[i * H:(i + 1) * H], np.float32)
        all_bins = bins
    elif bin_setup in ("separate", "repeat"):
        for i, module in enumerate(registry["ff_first"]):
            probe = measurements[i] if bin_setup == "separate" else measurements[0]
            mu, std = _feature_distribution(model, probe, cfg_data, external_dataloader, layer=i)
            log.info(f"Layer {i}: feature mean {mu:.4f}, std {std:.4f}.")
            bins = _gaussian_bins(mu, std, H)
            _set_kernel(params, module, np.tile(probe[:, None], (1, H)), layout)
            params[f"{module}.bias"] = -np.asarray(bins, np.float32)
            all_bins.extend(bins)
    else:
        raise ValueError(f"Invalid bin setup {bin_setup} given.")
    params.commit()

    secrets = dict(ImprintBlock=dict(
        weight_paths=list(registry["ff_first"]),
        bias_paths=[f"{module}.bias" for module in registry["ff_first"]],
        data_shape=tuple(cfg_data.shape),
        structure="cumulative" if bin_setup == "concatenate" else "cumulative-per-layer",
        v_length=v_length,
        bins=all_bins,
        measurement=measurement,
        bin_setup=bin_setup,
        hidden_dim=H,
        kernel_layout=layout,
    ))
    return model, secrets


def _gaussian_bins(mu, std, num_bins):
    """Inverse-CDF bins of N(mu, std) (reference: make_imprint_layer:316-344)."""
    bins = [-10.0]
    for i in range(1, num_bins):
        bins.append(float(normal_dist.ppf(i / num_bins)) * std + mu)
    return bins


def _feature_distribution(model, measurement, cfg_data, external_dataloader, num_batches=20, layer=0):
    """Mean and std of <FF input of ``layer``, measurement> on the rewired model over 20
    batches of the external data, or of random tokens (reference:
    compute_feature_distribution:8-57). The forward stops before the model's head."""
    device = next(model.parameters()).device
    probe = torch.as_tensor(measurement, device=device)

    def batch_features(inputs):
        capture = {}
        with torch.no_grad():
            model(torch.as_tensor(inputs, device=device), train=True, features=True, capture=capture)
        ff_in = capture[f"layer{layer}/ff_input"]
        return (ff_in.reshape(-1, ff_in.shape[-1]) @ probe).cpu().numpy()

    rng = np.random.default_rng(1)
    samples = []
    if external_dataloader is not None:
        for i, batch in enumerate(external_dataloader):
            samples.append(batch_features(batch["input_ids"]))
            if i + 1 >= num_batches:
                break
    else:
        batch, seq = int(cfg_data.batch_size), int(cfg_data.shape[0])
        for _ in range(num_batches):
            samples.append(batch_features(rng.integers(0, int(cfg_data.vocab_size), (batch, seq))))
    flat = np.concatenate(samples)
    return float(flat.mean()), float(flat.std())
