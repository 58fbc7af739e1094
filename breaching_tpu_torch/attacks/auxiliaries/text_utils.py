"""The text attacks' helpers (counterpart of
``breaching_tpu/attacks/auxiliaries/text_utils.py``): the ``run-embedding`` strategy,
token recovery before the attack, and the mapping of recovered embeddings to tokens.

- ``prepare_text_attack``: the candidate lives in embedding space (T, D), fed to the model
  in place of token ids. The embedding table's weight and its raw gradient are kept on
  ``attacker.embeddings``, and the table's gradient is zeroed in the matching target. The
  candidate's gradient there is zero too for an untied model; with a tied decoder it
  carries the decoder's gradient, matched against the zeroed target all the same, as
  the JAX package does.
- ``recover_token_information``: the bag of ``num_data_points * seq_len`` tokens from the
  decoder bias's and the embedding rows' gradients (``token_strategy``:
  ``decoder-bias``, ``embedding-norm``, ``embedding-log``, ``mixed``,
  ``greedy-embedding``, ``greedy-bias``), on the host in numpy, sorted.
- ``postprocess_text_data``: recovered embeddings to the tokens of highest centered
  cosine similarity (``from-embedding``; among the recovered labels' tokens with
  ``from-limited-embedding``), or the labels as the tokens (``from-labels``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


def prepare_text_attack(attacker, shared_data, rec_models):
    """Set up ``attack.text_strategy`` (``run-embedding``; ``no-preprocessing`` leaves the
    payload as it is). Returns the shared data to match, as new dicts."""
    strategy = attacker.cfg.get("text_strategy", "run-embedding")
    if strategy == "no-preprocessing":
        return shared_data
    if strategy != "run-embedding":
        raise ValueError(f"Invalid text strategy {strategy} given.")
    attacker.embeddings, prepared = [], []
    for model, data in zip(rec_models, shared_data):
        name = model.module.registry["embedding"]
        grads = data["gradients"]
        attacker.embeddings.append(dict(weight=model.params[name].detach(), grads=grads[name]))
        # new dicts: the caller's shared data keeps the embedding's gradient
        prepared.append(dict(data, gradients=dict(grads, **{name: torch.zeros_like(grads[name])})))
    attacker.data_shape = (attacker.data_shape[0], attacker.embeddings[0]["weight"].shape[1])
    return prepared


def max_cosine_similarity(rec: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """For each row of ``rec`` (n, D), the row of ``table`` (V, D) of highest cosine
    similarity after both are centered on their own means: one (n, V) product."""
    rec = rec - rec.mean(dim=-1, keepdim=True)
    table = table - table.mean(dim=-1, keepdim=True)
    rec = rec / (torch.linalg.vector_norm(rec, dim=-1, keepdim=True) + 1e-12)
    table = table / (torch.linalg.vector_norm(table, dim=-1, keepdim=True) + 1e-12)
    return torch.argmax(rec @ table.T, dim=1)


def match_embeddings_to_tokens(model, embeddings: torch.Tensor) -> torch.Tensor:
    """The nearest token of the payload model's embedding table for each embedding (..., D)."""
    table = model.params[model.module.registry["embedding"]].detach()
    flat = embeddings.reshape(-1, embeddings.shape[-1])
    return max_cosine_similarity(flat, table.to(flat)).reshape(embeddings.shape[:-1])


def postprocess_text_data(attacker, reconstructed_data, models=None):
    """The reconstruction's embeddings as token ids, by ``attack.token_recovery``."""
    token_recovery = attacker.cfg.get("token_recovery", "from-embedding")
    if getattr(attacker, "embeddings", None):
        table = attacker.embeddings[0]["weight"]
    elif models is not None:
        table = models[0].params[models[0].module.registry["embedding"]].detach()
    else:
        return reconstructed_data
    if token_recovery == "from-labels":
        reconstructed_data["data"] = reconstructed_data["labels"]
        return reconstructed_data
    rec = reconstructed_data["data"]
    rec_flat = rec.reshape(-1, rec.shape[-1])
    labels = reconstructed_data.get("labels")
    if token_recovery == "from-limited-embedding" and labels is not None:
        active = torch.unique(torch.as_tensor(labels, device=table.device).reshape(-1))
        tokens = active[max_cosine_similarity(rec_flat, table[active])]
    else:
        tokens = max_cosine_similarity(rec_flat, table)
    reconstructed_data["data"] = tokens.reshape(rec.shape[:2])
    return reconstructed_data


def estimate_repeat_counts(energies, num_missing):
    """Per-token repeat counts from squared embedding-gradient row norms E: (E / E0)^(1/p)
    with E0 the median energy (the singleton level) and p bisected in [0.25, 8] so that the
    counts sum to ``num_missing``; proportional excess-energy allocation where no such p
    exists. Returns int64 counts >= 1 whose sum is at most ``num_missing``."""
    sq = np.asarray(energies, np.float64)
    remaining = num_missing - len(sq)
    ratios = np.maximum(sq / max(np.median(sq), 1e-300), 1.0)

    def estimated_total(p):
        return np.maximum(ratios ** (1.0 / p), 1.0).sum()

    lo, hi = 0.25, 8.0
    with np.errstate(over="ignore"):
        if estimated_total(lo) >= num_missing >= estimated_total(hi):
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if estimated_total(mid) > num_missing:
                    lo = mid
                else:
                    hi = mid
            c_hat = np.maximum(ratios ** (1.0 / hi), 1.0)
        else:
            excess = np.maximum(sq - np.median(sq), 0.0)
            total = excess.sum()
            if total <= 0:
                c_hat = np.ones(len(sq))
                c_hat[np.argsort(-sq)[:remaining]] += 1.0
            else:
                c_hat = 1.0 + excess / total * remaining
    counts = np.floor(c_hat).astype(np.int64)
    deficit = num_missing - int(counts.sum())
    if deficit > 0:
        counts[np.argsort(-(c_hat - counts))[:deficit]] += 1
    return counts


def _numpy(tensor):
    return tensor.detach().cpu().numpy()


def recover_token_information(attacker, user_data, server_payload, model):
    """The (num_data_points, seq_len) tokens recovered before the attack, sorted, by
    ``attack.token_strategy`` (None: no recovery)."""
    strategy = attacker.cfg.get("token_strategy", "decoder-bias")
    if strategy is None:
        return None
    registry = model.module.registry
    num_data_points = int(user_data[0]["metadata"]["num_data_points"] or 1)
    seq_len = int(server_payload[0]["metadata"].shape[0])
    num_missing = num_data_points * seq_len
    token_cutoff = float(attacker.cfg.get("token_cutoff", 3.5) or 3.5)

    # run-embedding zeroes the embedding leaf in the target; the raw gradients are kept
    saved = getattr(attacker, "embeddings", None)
    if saved:
        wte = np.mean([_numpy(e["grads"]) for e in saved], axis=0)
    else:
        wte = np.mean([_numpy(d["gradients"][registry["embedding"]]) for d in user_data], axis=0)
    wte_norm = np.linalg.norm(wte, axis=1)
    bias_name = registry.get("decoder_bias")
    avg_bias = None
    if bias_name is not None and all(bias_name in d["gradients"] for d in user_data):
        avg_bias = np.mean([_numpy(d["gradients"][bias_name]) for d in user_data], axis=0)

    def classes_from_norm(cutoff_factor):
        if not np.any(wte_norm):
            return np.array([], np.int64)
        with np.errstate(divide="ignore"):
            log_norm = np.log(wte_norm)
        if not np.isfinite(log_norm).all():
            # untied embeddings: rows of absent tokens are exactly zero
            return np.nonzero(wte_norm)[0]
        mean, std = log_norm.mean(), log_norm.std()
        valid = np.array([], np.int64)
        for _ in range(64):
            valid = np.nonzero(log_norm > mean + cutoff_factor * std)[0]
            if len(valid):
                break
            cutoff_factor *= 0.8
        return valid

    tokens: list[int] = []
    if strategy == "decoder-bias":
        if avg_bias is None:
            raise ValueError("Cannot use decoder-bias token recovery without a decoder bias.")
        bias = avg_bias.copy()
        valid = np.nonzero(bias < 0)[0]
        if len(valid) > num_missing:
            valid = np.argsort(bias)[: num_missing - 1]
        tokens = valid.tolist()
        for token in classes_from_norm(token_cutoff):
            if token not in tokens:
                tokens.append(int(token))
        m_impact = bias[valid].sum() / num_missing
        bias[valid] -= m_impact
        while len(tokens) < num_missing:
            idx = int(np.argmin(bias))
            tokens.append(idx)
            bias[idx] -= m_impact
    elif strategy in ("embedding-norm", "embedding-log"):
        norm = wte_norm.copy()
        valid = classes_from_norm(token_cutoff)
        if len(valid) > num_missing:
            valid = np.argsort(-norm)[:num_missing]
        tokens = valid.tolist()
        if strategy == "embedding-norm":
            sq = norm[valid] ** 2
            if len(sq):  # rows near the cutoff hold noise; true tokens sit far above it
                keep = sq >= 0.25 * np.median(sq)
                valid, sq = valid[keep], sq[keep]
            tokens = [int(t) for t in valid]
            if num_missing > len(tokens) and len(sq):
                counts = estimate_repeat_counts(sq, num_missing)
                tokens += [int(t) for t, c in zip(valid, counts - 1) for _ in range(max(int(c), 0))]
            if len(tokens) < num_missing:  # pad by cycling the rows in descending energy
                order = ([int(t) for t in valid[np.argsort(-sq)]] if len(sq)
                         else [int(t) for t in np.argsort(-norm)[:num_missing]])
                i = 0
                while len(tokens) < num_missing:
                    tokens.append(order[i % len(order)])
                    i += 1
            tokens = tokens[:num_missing]
        else:
            with np.errstate(divide="ignore"):
                log_norm = np.log(np.maximum(norm, 1e-30))
            m_impact = log_norm[valid].max() / np.sqrt(num_data_points)
            while len(tokens) < num_missing:
                idx = int(valid[np.argmax(log_norm[valid])])
                tokens.append(idx)
                log_norm[idx] -= m_impact
    elif strategy == "mixed":
        if avg_bias is None:
            raise ValueError("mixed token recovery needs a decoder bias.")
        bias = avg_bias.copy()
        valid = classes_from_norm(token_cutoff)
        tokens = valid.tolist()
        m_impact = bias[valid].sum() / num_missing
        bias[valid] -= m_impact
        while len(tokens) < num_missing:
            idx = int(valid[np.argmin(bias[valid])])
            tokens.append(idx)
            bias[idx] -= m_impact
    elif strategy == "greedy-embedding":
        norm = wte_norm.copy()
        m_impact = norm.sum() / num_missing
        while len(tokens) < num_missing:
            idx = int(np.argmax(norm))
            tokens.append(idx)
            norm[idx] -= m_impact
    elif strategy == "greedy-bias":
        if avg_bias is None:
            raise ValueError("greedy-bias token recovery needs a decoder bias.")
        bias = avg_bias.copy()
        m_impact = bias.sum() / num_missing
        while len(tokens) < num_missing:
            idx = int(np.argmin(bias))
            tokens.append(idx)
            bias[idx] -= m_impact
    else:
        raise ValueError(f"Invalid strategy {strategy} for token recovery before attack.")
    log.info(f"Recovered tokens through strategy {strategy}.")
    return np.sort(np.asarray(tokens[:num_missing])).reshape(num_data_points, seq_len)
