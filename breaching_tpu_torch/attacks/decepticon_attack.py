"""Decepticon's analytic readout: whole token sequences from the gradients of a
transformer whose parameters the server rewired (counterpart of
``breaching_tpu/attacks/decepticon_attack.py``; reference analytic_attack.py
DecepticonAttacker:156-824). Pipeline (positions-first, the default):

1. the bag of tokens from the embedding and decoder gradients (``prepare_attack``);
2. breach extraction: every FF imprint layer's gradient, the cumulative bins
   differenced, weight rows divided by bias rows: one hidden state per (sentence,
   position), extracted in float64 on the host from the float32 gradients;
3. sentences told apart on the sentence-key components [0:v] (size-constrained k-means
   on the host's C++ assignment solver, ``native.py``, or another of the clustering zoo);
4. positions per sentence: the |correlation| assignment of states against the
   layer-normed positional embeddings on the content slice [v:-1]; free positions
   backfilled from collided rows;
5. the positional component removed by decorrelation;
6. the leaked tokens assigned to slots (each used once), then the full-vocabulary
   supplement for slots of low confidence: one float32 product of the slots and the
   layer-normed vocabulary on the device (TF32 off), or with ``exact_supplement`` each
   slot against its exact per-position references, whose LayerNorm statistics and
   correlations come from four products of the table on the device (``exact_scores``: the
   JAX package composes every (slot, token) reference, slots x vocabulary x hidden).

Where the registry names an embedding LayerNorm (the HuggingFace encoders), the embedding
table and the positional table pass through it before anything is matched (the tokens
and positions as the first block sees them, each normed on its own), and the exact
references compose LN_first(embLN(wte + pos + token type 0)); the norm after the
attention is the registry's ``first_ff_norm``. The correlations and assignments are the
JAX package's numpy and scipy code, on the host. The host LayerNorm's eps is 1e-5, as
there (the model's is flax's 1e-6).
``stats["decepticon_seconds"]`` gives the readout's seconds by stage: extraction,
clustering, matching and supplement.
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from ..cases.malicious.transformer_rewiring import positional_table
from .analytic_attack import AnalyticAttacker

log = logging.getLogger(__name__)


def _numpy(tensor, dtype=None):
    array = tensor.detach().cpu().numpy()
    return array if dtype is None else array.astype(dtype)


def _cross_corrcoef(a, b):
    """Centered correlation between rows of a [N, D] and b [M, D] as one matmul."""
    a = a - a.mean(axis=1, keepdims=True)
    b = b - b.mean(axis=1, keepdims=True)
    a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-10)
    b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-10)
    return a @ b.T


class _Stages(dict):
    """Seconds by stage, added up over the stage's runs."""

    @contextlib.contextmanager
    def __call__(self, stage):
        start = time.perf_counter()
        try:
            yield
        finally:
            self[stage] = self.get(stage, 0.0) + time.perf_counter() - start


class DecepticonAttacker(AnalyticAttacker):
    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        rec_models, tokens, stats = self.prepare_attack(server_payload, shared_data)
        shared_data = self._shared_data_cache
        if not server_secrets or "ImprintBlock" not in server_secrets:
            raise ValueError("Decepticon readout requires the malicious-transformer secrets.")
        secrets = server_secrets["ImprintBlock"]
        model = rec_models[0]
        registry = model.module.registry
        device = self.setup["device"]
        metadata = server_payload[0]["metadata"]
        len_data = int(shared_data[0]["metadata"]["num_data_points"] or 1)
        seq_len = int(metadata.shape[0])
        v = int(secrets["v_length"])
        stage = stats["decepticon_seconds"] = _Stages()

        norm_scale, norm_bias = self._first_norm_params(model)
        embedding_table = self._through_embedding_norm(model, _numpy(model.params[registry["embedding"]]))
        leaked = _numpy(tokens).reshape(-1) if tokens is not None else None

        with stage("extraction"):
            breached, preference, valid = self._extract_breaches(shared_data[0]["gradients"], secrets)
            candidates = np.nonzero(valid)[0]
            # too many rows can activate (noise, rounding at bin edges): keep the len_data *
            # seq_len most plausible by cfg.breach_reduction (reference: analytic_attack.py:370-397)
            order = candidates[np.argsort(-preference[candidates])]
            breached = breached[order[: len_data * seq_len]]
        log.info(f"Extracted {len(breached)} breached states with signal.")
        if len(breached) == 0:
            fallback = leaked if leaked is not None else np.zeros(len_data * seq_len, np.int64)
            return dict(data=torch.as_tensor(fallback, device=device).reshape(len_data, seq_len),
                        labels=tokens), stats

        # layer-normed positional references, tiled per sentence (reference:183-188)
        pos_table = self._through_embedding_norm(model, np.asarray(positional_table(model.module, model.params,
                                                                                    seq_len)))
        positional = np.tile(_layer_norm(pos_table, norm_scale, norm_bias), (len_data, 1))

        with stage("clustering"):  # on the raw sentence-key components (reference:190-200)
            if len_data > 1:
                sentence_labels = self._cluster_sentences(breached[:, :v], len_data, seq_len)
            else:
                sentence_labels = np.zeros(len(breached), np.int64)
            if self.cfg.get("sentence_based_backfill") and len_data > 1:
                breached, sentence_labels = self._sentence_backfill(breached, sentence_labels, (len_data, seq_len), v)

        # all further matching on the [v:-1] content slice (reference:208-211)
        breached_c = breached[:, v:-1].copy()
        positional_c = positional[:, v:-1]
        leaked_emb_c = None
        if leaked is not None:
            leaked_emb_c = _layer_norm(embedding_table[leaked], norm_scale, norm_bias)[:, v:-1]

        if self.cfg.get("recovery_order", "positions-first") == "tokens-first" and leaked is not None \
                and len(leaked) > 0:
            # ---- tokens-first recovery (reference:258-314) ----
            with stage("matching"):
                token_order, breach_sel, costs = self._match_embeddings(breached_c, leaked_emb_c)
                breach_tokens = np.zeros(len(breached_c), np.int64)
                breach_costs = np.full(len(breached_c), -np.inf)
                breach_tokens[token_order] = leaked[breach_sel]
                breach_costs[token_order] = costs
                token_embs = _layer_norm(embedding_table[breach_tokens], norm_scale, norm_bias)[:, v:-1]
                just_positions = self._separate(breached_c, token_embs)
                recovered_tokens = np.zeros(len_data * seq_len, np.int64)
                for sentence in range(len_data):
                    mask = sentence_labels == sentence
                    if not mask.any():
                        continue
                    pos_idx, row_idx, _ = self._match_embeddings(positional_c[:seq_len], just_positions[mask])
                    recovered_tokens[sentence * seq_len + pos_idx] = breach_tokens[mask][row_idx]
                final_tokens = recovered_tokens.reshape(len_data, seq_len)
                confidence = self._compute_confidence_estimates(final_tokens, breached_c, embedding_table,
                                                                pos_table, norm_scale, norm_bias, v)
            return self._result(final_tokens, tokens, confidence), stats

        # ---- positions-first recovery (reference:213-256, default) ----
        with stage("matching"):
            ordered = np.zeros((len_data * seq_len, breached_c.shape[1]), breached_c.dtype)
            for sentence in range(len_data):
                rows = breached_c[sentence_labels == sentence]
                if len(rows) == 0:
                    continue
                pos_idx, sel, _ = self._match_embeddings(positional_c[:seq_len], rows)
                ordered[sentence * seq_len + pos_idx] = rows[sel]
            if len(breached_c) < len(positional_c):
                ordered = self._backfill_embeddings(ordered, breached_c, positional_c, sentence_labels,
                                                    (len_data, seq_len))
            breached_without_positions = self._separate(ordered, positional_c)
            recovered_tokens = np.zeros(len_data * seq_len, np.int64)
            slot_costs = np.full(len_data * seq_len, -np.inf)
            if leaked is not None and len(leaked) > 0:
                token_order, slot_sel, costs = self._match_embeddings(breached_without_positions, leaked_emb_c)
                recovered_tokens[token_order] = leaked[slot_sel]
                slot_costs[token_order] = costs

            # ---- iterative positional refinement (beyond the reference): the first
            # row-to-position match correlates the raw token + position mixture with the
            # positional references, so repeated tokens can land in each other's places.
            # Removing each slot's estimated token direction exposes the positional
            # component; re-matching on that residual and re-assigning tokens converges
            # in 1-2 passes. ----
            refine = int(self.cfg.get("position_refinement", 2) or 0)
            if leaked is None or len(leaked) == 0:
                refine = 0
            for _ in range(refine):
                tok_emb_slots = _layer_norm(embedding_table[recovered_tokens], norm_scale, norm_bias)[:, v:-1]
                residual = self._separate(ordered, tok_emb_slots)
                new_ordered = np.zeros_like(ordered)
                for sentence in range(len_data):
                    block = slice(sentence * seq_len, (sentence + 1) * seq_len)
                    rows = ordered[block]
                    filled = np.nonzero(np.linalg.norm(rows, axis=-1) > 0)[0]
                    if len(filled) == 0:
                        continue
                    pos_idx, sel, _ = self._match_embeddings(positional_c[:seq_len], residual[block][filled])
                    new_ordered[sentence * seq_len + pos_idx] = rows[filled][sel]
                if np.array_equal(new_ordered, ordered):
                    break
                ordered = new_ordered
                breached_without_positions = self._separate(ordered, positional_c)
                token_order, slot_sel, costs = self._match_embeddings(breached_without_positions, leaked_emb_c)
                recovered_tokens = np.zeros(len_data * seq_len, np.int64)
                slot_costs = np.full(len_data * seq_len, -np.inf)
                recovered_tokens[token_order] = leaked[slot_sel]
                slot_costs[token_order] = costs

        with stage("supplement"):
            weight = float(self.cfg.get("embedding_token_weight", 0.25) or 0.0)
            if weight > 0 or leaked is None:
                supplemented = None
                if self.cfg.get("exact_supplement", False):
                    supplemented = self._supplement_exact(recovered_tokens, slot_costs, ordered, model,
                                                          (len_data, seq_len), v, weight)
                if supplemented is not None:
                    recovered_tokens = supplemented
                else:
                    table = (model.params[registry["embedding"]].detach() if "embedding_norm" not in registry
                             else torch.as_tensor(embedding_table, device=device))
                    recovered_tokens = self._supplement_from_full_vocabulary(
                        recovered_tokens, slot_costs, breached_without_positions, table, norm_scale, norm_bias,
                        v, weight)

            if self.cfg.get("collision_recovery", False) and leaked is not None and len(leaked) > 0:
                recovered_tokens, slot_costs = self._recover_collisions(model, ordered, recovered_tokens, slot_costs,
                                                                        leaked, (len_data, seq_len), v)

            # ---- exact-reference position / token alternation (beyond the reference):
            # with tokens estimated, re-assign rows to the positions whose exact composed
            # reference they correlate with, then re-estimate the tokens there. ----
            exact_rounds = int(self.cfg.get("exact_refinement", 0) or 0)
            if exact_rounds and self.cfg.get("exact_supplement", False):
                for _ in range(exact_rounds):
                    moved, ordered, recovered_tokens, slot_costs = self._exact_position_round(
                        model, ordered, recovered_tokens, slot_costs, (len_data, seq_len), v)
                    if not moved:
                        break
                    supplemented = self._supplement_exact(recovered_tokens, slot_costs, ordered, model,
                                                          (len_data, seq_len), v, weight)
                    if supplemented is not None:
                        recovered_tokens = supplemented

        with stage("matching"):
            final_tokens = recovered_tokens.reshape(len_data, seq_len)
            confidence = self._compute_confidence_estimates(final_tokens, breached_c, embedding_table, pos_table,
                                                            norm_scale, norm_bias, v)
        return self._result(final_tokens, tokens, confidence), stats

    def _result(self, final_tokens, tokens, confidence):
        device = self.setup["device"]
        return dict(data=torch.as_tensor(final_tokens, device=device), labels=tokens,
                    confidence=torch.as_tensor(confidence, dtype=torch.float32, device=device))

    # ------------------------------------------------------------------ pieces

    def _through_embedding_norm(self, model, table):
        """A (rows, D) table through the registry's embedding LayerNorm (host eps 1e-5, as
        in the JAX package), or as it is without one."""
        name = model.module.registry.get("embedding_norm")
        if name is None:
            return table
        return _layer_norm(table, _numpy(model.params[f"{name}.weight"]), _numpy(model.params[f"{name}.bias"]))

    def _first_norm_params(self, model):
        """(scale, bias) of the LayerNorm the imprinted FF input passes through: the
        registry's ``first_ff_norm``, else norm1 for post-LN blocks (ff_input = norm1(x +
        attn)), norm2 for pre-LN blocks (ff_input = norm2(x + attn(norm1(x))))."""
        name = model.module.registry.get("first_ff_norm")
        if name is None:
            name = "layer0.norm2" if getattr(model.module, "norm_first", False) else "layer0.norm1"
        if f"{name}.weight" in model.params:
            return _numpy(model.params[f"{name}.weight"]), _numpy(model.params[f"{name}.bias"])
        dim = getattr(model.module, "ninp", 96)
        return np.ones(dim, np.float32), np.zeros(dim, np.float32)

    def _extract_breaches(self, gradients, secrets):
        """FF imprint gradients -> breached hidden states (reference:
        _extract_breaches:324-397), in float64 on the host.

        Bin k of the cumulative structure fires for every state whose measurement exceeds
        bin k, so grad_k - grad_{k+1} isolates the states in [bin_k, bin_{k+1}). The
        flow-through eps makes these gradients tiny (about 1e-10), so validity is
        relative: plateaus between states difference to exactly zero, real jumps lie far
        above float32 rounding at the layers' boundaries.

        Returns (states, preference, valid): a higher preference is kept first under
        cfg.breach_reduction ('bias' prefers the smallest |bias| jumps, the least likely
        to be collided rows; 'weight' and 'total-weight' heavy weight rows)."""
        layout = secrets.get("kernel_layout", "in_out")
        weight_rows, bias_rows = [], []
        for module in secrets["weight_paths"]:
            kernel = _numpy(gradients[f"{module}.weight"], np.float64)
            weight_rows.append(kernel.T if layout == "in_out" else kernel)   # (H, D)
            bias_rows.append(_numpy(gradients[f"{module}.bias"], np.float64))
        weights = np.concatenate(weight_rows, axis=0)           # (bins, D)
        biases = np.concatenate(bias_rows, axis=0)              # (bins,)

        if secrets["structure"] == "cumulative":
            weights = np.concatenate([weights[:-1] - weights[1:], weights[-1:]], axis=0)
            biases = np.concatenate([biases[:-1] - biases[1:], biases[-1:]])
        elif secrets["structure"] == "cumulative-per-layer":
            # bins are cumulative within each layer's block (bin_setup separate / repeat)
            H = int(secrets["hidden_dim"])
            for start in range(0, len(biases), H):
                block_w = weights[start:start + H].copy()
                block_b = biases[start:start + H].copy()
                weights[start:start + H - 1] = block_w[:-1] - block_w[1:]
                biases[start:start + H - 1] = block_b[:-1] - block_b[1:]

        mags = np.abs(biases)
        valid = mags > mags.max(initial=0.0) * 1e-6
        safe_bias = np.where(valid, biases, np.inf)
        states = (weights / safe_bias[:, None]).astype(np.float32)

        reduction = self.cfg.get("breach_reduction", "bias") or "bias"
        if reduction == "bias":
            preference = -mags                    # smallest jump first
        elif reduction == "weight":
            preference = np.abs(weights.mean(axis=1))
        elif reduction == "total-weight":
            preference = np.square(weights).sum(axis=1)
        else:
            raise ValueError(f"Invalid breach reduction {reduction} given.")
        return states, preference, valid

    def _cluster_sentences(self, keys, num_sentences, seq_len=None):
        """Sentences told apart on the key components, by the reference's clustering zoo
        (analytic_attack.py:624-757): size-constrained k-means (the default; no cluster
        exceeds seq_len rows), k-medoids (PAM on the correlation matrix, retried until the
        size constraint holds), dynamic-threshold (greedy correlation grouping over a
        searched threshold, seeds replicated seq_len times and assigned), plain threshold
        (>= 0.99 groups), fcluster (ward on 1 - |corr|) and pca (SVD seeds)."""
        algorithm = self.cfg.get("sentence_algorithm", "k-means") or "k-means"
        seq_len = int(seq_len or max(len(keys) // max(num_sentences, 1), 1))
        rng = np.random.default_rng(0)

        std = keys.std(axis=-1, keepdims=True) + 1e-10
        normalized = (keys - keys.mean(axis=-1, keepdims=True)) / std

        if algorithm == "k-means":
            n_init = int(self.cfg.get("sentence_kmeans_inits", 10) or 10)
            return _constrained_kmeans(normalized, num_sentences, seq_len, rng, n_init=n_init)
        if algorithm == "k-medoids":
            corrs = _safe_corrcoef(keys)
            for trial in range(50):
                labels = _pam_kmedoids(corrs, num_sentences, np.random.default_rng(trial))
                if np.bincount(labels, minlength=num_sentences).max() <= seq_len:
                    return labels
            raise AssertionError("Invalid Assignment in k-medoids")
        if "dynamic-threshold" in algorithm:
            comps = normalized if "normalized" in algorithm else keys
            return self._dynamic_threshold_cluster(keys, comps, num_sentences, seq_len,
                                                   use_median="median" in algorithm, rng=rng)
        if algorithm == "threshold":
            corrs = _safe_corrcoef(keys)
            labels = np.full(len(keys), -1, np.int64)
            assigned = set()
            for idx in range(len(keys)):
                if idx in assigned:
                    continue
                matches = np.nonzero(corrs[idx] >= 0.99)[0]
                matches = np.asarray([m for m in matches if m not in assigned])
                if len(matches) > seq_len:
                    matches = matches[np.argsort(-corrs[idx][matches])[:seq_len]]
                labels[matches] = idx
                assigned |= set(matches.tolist())
            # group ids compressed to [0, num_sentences)
            _, labels = np.unique(labels, return_inverse=True)
            return labels.astype(np.int64) % num_sentences
        if algorithm == "fcluster":
            import scipy.cluster.hierarchy as spc
            from scipy.spatial.distance import squareform

            corrs = _safe_corrcoef(keys)
            dissimilarity = 1 - np.abs((corrs + corrs.T) / 2)
            np.fill_diagonal(dissimilarity, 0)
            hierarchy = spc.linkage(squareform(dissimilarity, checks=False), method="ward")
            labels = spc.fcluster(hierarchy, num_sentences, criterion="maxclust") - 1
            assert np.bincount(labels).max() <= seq_len, "Invalid Assignment in fcluster"
            return labels.astype(np.int64)
        if "pca" in algorithm:
            A = keys - keys.mean(axis=-1, keepdims=True)
            U, S, Vt = np.linalg.svd(A, full_matrices=False)
            seeds = U[:, :num_sentences].T @ A
            if "direct" in algorithm:
                return np.abs(U[:, :num_sentences]).argmax(axis=-1).astype(np.int64)
            return self._assign_to_seeds(A, seeds, seq_len)
        raise ValueError(f"Invalid sentence algorithm {algorithm} given.")

    def _assign_to_seeds(self, components, seeds, seq_len):
        """The capacitated assignment of components to seed sentences: the reference
        replicates each seed seq_len times and solves a dense linear_sum_assignment
        (analytic_attack.py:703-709); the solver takes the capacity on the (n, k)
        correlation table directly."""
        from .. import native

        corr = _cross_corrcoef(np.asarray(components), np.asarray(seeds))
        score = np.abs(corr) if "abs" in self.cfg.get("matcher", "abs-corrcoef") else corr
        return native.capacitated_assignment(-score, seq_len)

    def _dynamic_threshold_cluster(self, keys, components, num_sentences, seq_len, use_median=False, rng=None):
        """Greedy correlation grouping over a searched threshold (reference:
        analytic_attack.py:656-710): the loosest threshold at which no row correlates with
        more than seq_len others, groups formed greedily by descending degree, each seeded
        by its mean or median, missing groups by random seeds, then every row assigned to
        the replicated seeds."""
        corrs = _safe_corrcoef(keys)
        upper = [1 - 1.5 ** float(n) for n in range(-96, -16)][::-1]
        lower = (1.001 - np.geomspace(1, 0.001, 2000)[:-1]).tolist()
        thresholds = [*lower, *upper]
        final_threshold = thresholds[0]
        for idx, threshold in enumerate(thresholds[::-1]):
            if (corrs > threshold).sum(axis=-1).max() > seq_len:
                final_threshold = thresholds[::-1][max(idx - 1, 0)]
                break
        else:
            log.info(f"Cannot separate {num_sentences} seeds by thresholding!")

        assigned = set()
        groups = []
        degree_order = np.argsort(-(corrs > final_threshold).sum(axis=-1))
        for idx in degree_order:
            if int(idx) in assigned or len(groups) >= num_sentences:
                continue
            matches = [int(m) for m in np.nonzero(corrs[idx] > final_threshold)[0] if int(m) not in assigned]
            if matches:
                groups.append(matches)
                assigned |= set(matches)
        if len(groups) < num_sentences:
            log.info(f"Could assemble only {len(groups)} seeds at threshold {final_threshold}; "
                     f"filling with random seeds.")
        rng = rng or np.random.default_rng(0)
        seeds = rng.standard_normal((num_sentences, components.shape[-1]))
        for i, group in enumerate(groups):
            block = components[np.asarray(group)]
            seeds[i] = np.median(block, axis=0) if use_median else block.mean(axis=0)
        return self._assign_to_seeds(components, seeds, seq_len)

    def _compute_confidence_estimates(self, final_tokens, breached_embeddings, embedding_table, pos_table,
                                      norm_scale, norm_bias, v):
        """Uncalibrated per-token confidence: the correlation of each recovered token's
        estimated first-norm embedding with the breached states (reference:
        _compute_confidence_estimates:788-812); 1.0 for a right token, lower for a
        likely mismatch."""
        len_data, seq_len = final_tokens.shape
        flat = final_tokens.reshape(-1)
        estimated = embedding_table[flat] + np.tile(pos_table, (len_data, 1))
        estimated = _layer_norm(estimated, norm_scale, norm_bias)[:, v:-1]
        corr = _cross_corrcoef(estimated, breached_embeddings)
        score = np.abs(corr) if "abs" in self.cfg.get("matcher", "abs-corrcoef") else corr
        return score.max(axis=1).reshape(len_data, seq_len)

    def _sentence_backfill(self, breached, sentence_labels, shape, v_len, match_t=0.75, nontrivial_t=1e-2):
        """Collided breaches replicated into under-filled sentences while their
        sentence-key residual still correlates with that sentence's seed (reference:
        _sentence_backfill:521-566)."""
        len_data, seq_len = shape
        keys = breached[:, :v_len]
        mean = keys.mean(axis=-1, keepdims=True)
        std = keys.std(axis=-1, keepdims=True) + 1e-10
        normed = (keys - mean) / std
        seeds = np.stack([np.median(normed[sentence_labels == s], axis=0) if (sentence_labels == s).any()
                          else np.zeros(v_len) for s in range(len_data)])
        unmixed = self._separate(normed, seeds[sentence_labels])
        nontrivial = np.linalg.norm(unmixed, axis=1) > nontrivial_t
        comp_ids = np.nonzero(nontrivial)[0]
        components = unmixed[nontrivial]

        for _ in range(seq_len):
            counts = np.bincount(sentence_labels, minlength=len_data)
            free = seq_len - counts
            if free.max() <= 0 or len(components) == 0:
                break
            rep_seeds = np.repeat(seeds, np.maximum(free, 0), axis=0)
            rep_labels = np.repeat(np.arange(len_data), np.maximum(free, 0))
            if len(rep_seeds) == 0:
                break
            seed_idx, comp_idx, costs = self._match_embeddings(components, rep_seeds)
            matches = costs > match_t
            if not matches.any():
                break
            matched_rows = comp_ids[seed_idx[matches]]
            breached = np.concatenate([breached, breached[matched_rows]], axis=0)
            sentence_labels = np.concatenate([sentence_labels, rep_labels[comp_idx[matches]]])
            components[seed_idx[matches]] = self._separate(components[seed_idx[matches]],
                                                           rep_seeds[comp_idx[matches]])
            keep = np.linalg.norm(components, axis=1) > nontrivial_t
            components, comp_ids = components[keep], comp_ids[keep]
        return breached, sentence_labels

    def _match_embeddings(self, references, queries):
        """The assignment of query rows to reference rows by the largest |correlation|
        (reference: _match_embeddings:759-786). Returns (reference indices, query indices,
        matched correlations)."""
        from scipy.optimize import linear_sum_assignment

        corr = _cross_corrcoef(np.asarray(queries), np.asarray(references))  # (nq, nr)
        score = np.abs(corr) if "abs" in self.cfg.get("matcher", "abs-corrcoef") else corr
        q_ind, r_ind = linear_sum_assignment(-score)
        return r_ind, q_ind, score[q_ind, r_ind]

    def _separate(self, mixed, base):
        """A base component removed from mixed rows (reference:568-589)."""
        scheme = self.cfg.get("separation", "decorrelation") or "none"
        if scheme == "subtraction":
            return mixed - base
        if scheme == "none":
            return mixed.copy()
        # decorrelation (the default): the correlated part removed in normalized space
        m_mean = mixed.mean(axis=-1, keepdims=True)
        m_std = mixed.std(axis=-1, keepdims=True) + 1e-10
        b_mean = base.mean(axis=-1, keepdims=True)
        b_std = base.std(axis=-1, keepdims=True) + 1e-10
        m_normed = (mixed - m_mean) / m_std
        b_normed = (base - b_mean) / b_std
        corr = (m_normed * b_normed).sum(-1, keepdims=True) / (
            np.linalg.norm(m_normed, axis=-1, keepdims=True) * np.linalg.norm(b_normed, axis=-1, keepdims=True)
            + 1e-10)
        unmixed = m_normed - corr * b_normed
        return unmixed * m_std + m_mean

    def _backfill_embeddings(self, ordered, fillable, positional, sentence_labels, shape):
        """Empty slots filled with (collided) breach rows (reference:399-457, 'local')."""
        len_data, seq_len = shape
        mode = self.cfg.get("backfilling", "local") or "local"
        if mode == "global":
            free = np.nonzero(np.linalg.norm(ordered, axis=-1) == 0)[0]
            while len(free) > 0 and len(fillable) > 0:
                pos_idx, sel, _ = self._match_embeddings(positional[free], fillable)
                ordered[free[pos_idx]] = fillable[sel]
                new_free = np.nonzero(np.linalg.norm(ordered, axis=-1) == 0)[0]
                if len(new_free) == len(free):
                    break
                free = new_free
            return ordered
        for sentence in range(len_data):
            rows = fillable[sentence_labels == sentence]
            if len(rows) == 0:
                continue
            block = ordered[sentence * seq_len:(sentence + 1) * seq_len]
            free = np.nonzero(np.linalg.norm(block, axis=-1) == 0)[0]
            while len(free) > 0:
                pos_idx, sel, _ = self._match_embeddings(positional[:seq_len][free], rows)
                block[free[pos_idx]] = rows[sel]
                new_free = np.nonzero(np.linalg.norm(block, axis=-1) == 0)[0]
                if len(new_free) == len(free):
                    break
                free = new_free
            ordered[sentence * seq_len:(sentence + 1) * seq_len] = block
        return ordered

    def _exact_tables(self, model, seq_len):
        """Raw tables for the exact composition of references, or None without a learned
        embedding table or enough positions: (wte, pos_tab, the token-type row 0 (zeros
        without a token-type table), the embedding norm's (scale, bias) or None,
        first_norm (scale, bias)), in float64."""
        registry = model.module.registry
        emb_name = registry.get("embedding")
        if emb_name is None or emb_name not in model.params:
            return None
        wte = _numpy(model.params[emb_name], np.float64)
        pos_tab = np.asarray(positional_table(model.module, model.params, seq_len), np.float64)
        if len(pos_tab) < seq_len:
            return None
        offset = np.zeros(wte.shape[1])
        if registry.get("type_embedding") in model.params:
            offset = _numpy(model.params[registry["type_embedding"]], np.float64)[0]
        emb_norm = None
        if registry.get("embedding_norm") is not None:
            name = registry["embedding_norm"]
            emb_norm = (_numpy(model.params[f"{name}.weight"], np.float64),
                        _numpy(model.params[f"{name}.bias"], np.float64))
        norm_scale, norm_bias = self._first_norm_params(model)
        return wte, pos_tab, offset, emb_norm, (np.asarray(norm_scale, np.float64),
                                                np.asarray(norm_bias, np.float64))

    def _exact_reference_builder(self, model, seq_len):
        """f(slot_idx, token_idx) -> the exact first-norm states LN_first(embLN(wte[t] +
        pos[p] + tte_0)) (without an embedding norm LN_first(wte[t] + pos[p])), or None
        without learned tables.

        The rest of the pipeline matches states against additively combined LN(emb) +
        LN(pos) references (the reference's approximation, analytic_attack.py:183-211):
        good enough for assignment, too coarse to decompose a collided bin, whose minority
        component carries a fraction of the state's energy. Composing the tables exactly,
        the norms applied to the sum as the forward pass applies them, makes that
        residual decomposition feasible."""
        tables = self._exact_tables(model, seq_len)
        if tables is None:
            return None
        wte, pos_tab, offset, emb_norm, (norm_scale, norm_bias) = tables

        def build(slot_idx, token_idx):
            p = np.asarray(slot_idx) % seq_len
            x = wte[np.asarray(token_idx)] + pos_tab[p] + offset
            if emb_norm is not None:
                x = _layer_norm(x, emb_norm[0], emb_norm[1])
            return _layer_norm(x, norm_scale, norm_bias)

        return build

    def _recover_collisions(self, model, ordered, recovered_tokens, slot_costs, leaked, shape, v):
        """Collided imprint bins decomposed into per-position tokens (beyond the
        reference, which backfills the raw collided row into the free position,
        analytic_attack.py:399-457).

        Two states between the same pair of cumulative thresholds leave one bin
        difference holding their bias-weighted average. Every group of positions holding
        the same row keeps its best-explained slot, then greedily claims tokens for the
        remaining slots from the residual after the fitted exact reference is removed;
        each claim must beat cfg.collision_threshold (default 0.2). A claimed slot's cost
        becomes its residual correlation, so that the full-vocabulary supplement
        overrides only weak claims."""
        len_data, seq_len = shape
        builder = self._exact_reference_builder(model, seq_len)
        if builder is None:
            return recovered_tokens, slot_costs
        threshold = float(self.cfg.get("collision_threshold", 0.2) or 0.2)
        cand = np.unique(np.concatenate([np.asarray(leaked).reshape(-1), np.asarray(recovered_tokens)]))

        groups: dict[bytes, list[int]] = {}
        for slot in range(len(ordered)):
            row = ordered[slot]
            if not np.linalg.norm(row):
                continue
            groups.setdefault(np.asarray(row, np.float32).tobytes(), []).append(slot)
        collided = [sorted(slots, key=lambda s: -slot_costs[s]) for slots in groups.values() if len(slots) > 1]
        if not collided:
            return recovered_tokens, slot_costs

        def _normed(a):
            a = a - a.mean(axis=-1, keepdims=True)
            return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)

        # one residual per collided row: the primary slot's exact reference (its token
        # after the supplement, the cleanest explanation) removed
        residuals, capacity = [], []
        secondaries: list[int] = []
        for slots in collided:
            primary = slots[0]
            state = _normed(np.asarray(ordered[primary], np.float64))
            ref = _normed(builder([primary], [recovered_tokens[primary]])[:, v:-1])[0]
            residuals.append(state - (state @ ref) * ref)
            capacity.append(len(slots) - 1)
            secondaries.extend(slots[1:])
        residuals = _normed(np.stack(residuals))

        # the joint (secondary slot, candidate token) claim matrix: any residual may claim
        # any secondary slot, greedily by correlation
        refs = np.concatenate([_normed(builder(np.full(len(cand), s), cand)[:, v:-1]) for s in secondaries])
        corr = np.abs(residuals @ refs.T)                      # (G, |U| * |C|)
        n_cand = len(cand)
        claimed = 0
        taken: set[int] = set()
        for flat in np.argsort(-corr, axis=None):
            g, uc = divmod(int(flat), corr.shape[1])
            if corr[g, uc] < threshold:
                break
            u, c = divmod(uc, n_cand)
            slot = secondaries[u]
            if slot in taken or capacity[g] <= 0:
                continue
            recovered_tokens[slot] = cand[c]
            slot_costs[slot] = float(corr[g, uc])
            taken.add(slot)
            capacity[g] -= 1
            claimed += 1
        if claimed:
            log.info(f"Collision recovery claimed {claimed} slots from {len(collided)} collided rows.")
        return recovered_tokens, slot_costs

    def _exact_position_round(self, model, ordered, recovered_tokens, slot_costs, shape, v):
        """One round of exact-reference position re-assignment: per sentence, every
        non-empty row re-matched to a position by |corr(row, build(position, row's
        token))|. Tokens and costs travel with their rows; a moved row's cost becomes its
        assignment correlation, and a position left rowless keeps its token with cost
        -inf. Returns (any row moved, ordered, tokens, costs)."""
        len_data, seq_len = shape
        builder = self._exact_reference_builder(model, seq_len)
        if builder is None:
            return False, ordered, recovered_tokens, slot_costs
        from scipy.optimize import linear_sum_assignment

        def _normed(a):
            a = a - a.mean(axis=-1, keepdims=True)
            return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)

        use_abs = "abs" in self.cfg.get("matcher", "abs-corrcoef")
        moved = False
        new_ordered = ordered.copy()
        new_tokens = recovered_tokens.copy()
        new_costs = slot_costs.copy()
        all_pos = np.arange(seq_len)
        for sentence in range(len_data):
            block = slice(sentence * seq_len, (sentence + 1) * seq_len)
            rows = ordered[block]
            filled = np.nonzero(np.linalg.norm(rows, axis=-1) > 0)[0]
            if len(filled) == 0:
                continue
            toks = recovered_tokens[block][filled]
            rn = _normed(np.asarray(rows[filled], np.float64))
            profit = np.zeros((len(filled), seq_len))
            for i in range(len(filled)):
                refs = _normed(builder(all_pos, np.full(seq_len, toks[i]))[:, v:-1])
                corr = refs @ rn[i]
                profit[i] = np.abs(corr) if use_abs else corr
            r_idx, p_idx = linear_sum_assignment(-profit)
            base = sentence * seq_len
            blk_rows = np.zeros_like(rows)
            # a slot whose row moved away must not keep that row's cost, or the exact
            # supplement skips it and duplicates the token there
            blk_toks = recovered_tokens[block].copy()
            blk_costs = np.full_like(slot_costs[block], -np.inf)
            for r, p in zip(r_idx, p_idx):
                blk_rows[p] = rows[filled[r]]
                blk_toks[p] = toks[r]
                old_p = filled[r]
                if p != old_p:
                    moved = True
                    blk_costs[p] = profit[r, p]
                else:
                    blk_costs[p] = slot_costs[base + old_p]
            new_ordered[block] = blk_rows
            new_tokens[block] = blk_toks
            new_costs[block] = blk_costs
        return moved, new_ordered, new_tokens, new_costs

    def _supplement_exact(self, recovered_tokens, costs, ordered, model, shape, v, weight):
        """The full-vocabulary supplement against exact per-position references
        LN_first(embLN(wte + pos_slot + tte_0)), the function the forward pass applies,
        on the device (``_device_exact_vocab_match``, ``exact_scores``). Returns None
        without raw tables (the caller falls back to the additive supplement)."""
        len_data, seq_len = shape
        tables = self._exact_tables(model, seq_len)
        if tables is None:
            return None
        wte, pos_tab, offset, emb_norm, (norm_scale, norm_bias) = tables
        slots = np.arange(len_data * seq_len) % seq_len
        device = self.setup["device"]

        def on_device(array):
            return torch.as_tensor(np.asarray(array, np.float32), device=device)

        best, best_val = _device_exact_vocab_match(
            on_device(wte), on_device(pos_tab[slots] + offset),
            None if emb_norm is None else tuple(map(on_device, emb_norm)), on_device(norm_scale),
            on_device(norm_bias), on_device(ordered), int(v), "abs" in self.cfg.get("matcher", "abs-corrcoef"))
        replace = best_val * max(weight, 1e-9) > costs
        num_replaced = int(replace.sum())
        if num_replaced:
            log.info(f"Replaced {num_replaced} tokens from the full vocabulary "
                     f"(exact refs, avg new corr {best_val[replace].mean():.2f}).")
        costs[replace] = best_val[replace]
        return np.where(replace, best + 1, recovered_tokens)

    def _supplement_from_full_vocabulary(self, recovered_tokens, costs, breached, table, norm_scale, norm_bias, v,
                                         weight):
        """Slots of low confidence replaced by the best correlation over the whole
        vocabulary (reference:591-622) of ``table`` (the embedding table on the device,
        through the embedding norm where there is one): the (slots x vocabulary x hidden)
        correlation as a float32 product on the device, only each slot's winner back to
        the host."""
        device = self.setup["device"]
        best, best_val = _device_vocab_match(
            torch.as_tensor(breached, dtype=torch.float32, device=device), table,
            torch.as_tensor(norm_scale, device=device), torch.as_tensor(norm_bias, device=device), int(v),
            "abs" in self.cfg.get("matcher", "abs-corrcoef"))
        replace = best_val * max(weight, 1e-9) > costs
        num_replaced = int(replace.sum())
        if num_replaced:
            log.info(f"Replaced {num_replaced} tokens from the full vocabulary "
                     f"(avg new corr {best_val[replace].mean():.2f}).")
        return np.where(replace, best + 1, recovered_tokens)


def _layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


def _torch_layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def _unit_rows(x):
    """Rows centred on their means and scaled to unit norm (at least 1e-10)."""
    x = x - x.mean(dim=-1, keepdim=True)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-10)


# elements of the largest (slots x vocabulary) or (slots x vocabulary x hidden) block
# the device matchers form at once
_CHUNK_ELEMENTS = 2 ** 28


def _device_vocab_match(breached, table, scale, bias, v, use_abs):
    """Each slot's best row of the layer-normed vocabulary (row 0 skipped: the caller
    adds 1) and its score, by the centred correlation of float32 rows on the device, the
    slots in chunks: ((slots,) int64, (slots,) float32) numpy arrays."""
    with torch.no_grad():
        refs = _unit_rows(_torch_layer_norm(table, scale, bias)[1:, v:-1])
        states = _unit_rows(breached)
        found = []
        for chunk in states.split(max(1, _CHUNK_ELEMENTS // refs.shape[0])):
            score = chunk @ refs.T
            value, index = (score.abs() if use_abs else score).max(dim=1)
            found.append((index, value))
        return tuple(_numpy(torch.cat(parts)) for parts in zip(*found))


def _device_exact_vocab_match(wte, pos_rows, emb_norm, n_scale, n_bias, states, v, use_abs):
    """The exact-reference vocabulary matcher: for each slot, the full vocabulary's
    references at that slot's position, LN_first(embLN(wte + pos_slot)) (``emb_norm``
    the embedding norm's (scale, bias), or None), correlated with the slot's state on the
    content slice (``exact_scores``). Row 0 is skipped, as in ``_device_vocab_match``."""
    found = []
    for score in exact_scores(wte, pos_rows, emb_norm, n_scale, n_bias, states, v):
        value, index = (score.abs() if use_abs else score).max(dim=1)
        found.append((index, value))
    return tuple(_numpy(torch.cat(parts)) for parts in zip(*found))


def exact_scores(wte, pos_rows, emb_norm, n_scale, n_bias, states, v, eps=1e-5):
    """Yields, a chunk of slots at a time, the centred correlation (slots, V - 1) of each
    slot's state (on the content slice [v:-1]) with every token's exact reference
    LN_first(embLN(wte[t] + pos_slot))[v:-1], tokens from row 1, without forming the (slots
    x vocabulary x hidden) references: each LayerNorm is affine in its row, so a reference
    on the slice is z = A (x * u) + B u + C k + E s_f + b_f with x = wte[t] + pos_slot, u =
    s_e s_f, k = b_e s_f and scalars A, B, C, E of (token, slot) from the row's mean and
    variance (without an embedding norm u = s_f, k = 0), and the correlation, its norm and
    those statistics are sums that four (V, D) x (D, slots) products and per-token or
    per-slot constants give. The same numbers as composing the references (float32,
    sums in other orders)."""
    with torch.no_grad():
        table = wte[1:]
        dim = table.shape[1]
        sl = slice(v, dim - 1)
        s_f, b_f = n_scale, n_bias
        if emb_norm is not None:
            s_e, b_e = emb_norm
            u, k = s_e * s_f, b_e * s_f
        else:
            u, k = s_f, torch.zeros_like(s_f)
        U, K, F, G = u[sl], k[sl], s_f[sl], b_f[sl]
        length = U.shape[0]
        t_sl = table[:, sl]
        # per token
        w_sum, w_sq = table.sum(1, keepdim=True), (table * table).sum(1, keepdim=True)
        t_u, t_uu = t_sl @ U, t_sl @ (U * U)
        t_uk, t_uf, t_ug = t_sl @ (U * K), t_sl @ (U * F), t_sl @ (U * G)
        t_xx = (t_sl * t_sl) @ (U * U)
        # constants of the slice
        sums = {name: float(a @ b) for name, (a, b) in dict(
            uu=(U, U), kk=(K, K), ff=(F, F), gg=(G, G), uk=(U, K), uf=(U, F), ug=(U, G), kf=(K, F), kg=(K, G),
            fg=(F, G)).items()}
        sum_u, sum_k, sum_f, sum_g = (float(x.sum()) for x in (U, K, F, G))
        if emb_norm is not None:
            see = s_e * s_e
            t_se, t_xsee, t_see, t_seb = ((table @ s_e)[:, None], ((table * table) @ see)[:, None],
                                          (table @ see)[:, None], (table @ (s_e * b_e))[:, None])
            se_sum, see_sum, seb_sum = float(s_e.sum()), float((s_e * s_e).sum()), float((s_e * b_e).sum())
            be_mean, bee_sum = float(b_e.mean()), float((b_e * b_e).sum())
        step = max(1, _CHUNK_ELEMENTS // 8 // table.shape[0])
        for start in range(0, len(pos_rows), step):
            rows = pos_rows[start:start + step]
            c = _unit_rows(states[start:start + step])
            r_sl = rows[:, sl]
            # the row's mean and variance over all dims, x = wte[t] + pos_slot
            mu_x = (w_sum + rows.sum(1)) / dim
            var_x = (w_sq + 2 * table @ rows.T + (rows * rows).sum(1)) / dim - mu_x * mu_x
            if emb_norm is not None:
                r_x = torch.rsqrt(var_x + eps)
                xs = t_se + rows @ s_e
                mu_y = r_x * (xs - mu_x * se_sum) / dim + be_mean
                x2 = t_xsee + 2 * table @ (rows * see).T + (rows * rows) @ see
                dev2 = x2 - 2 * mu_x * (t_see + rows @ see) + mu_x * mu_x * see_sum
                cross = t_seb + rows @ (s_e * b_e) - mu_x * seb_sum
                var_y = (r_x * r_x * dev2 + 2 * r_x * cross + bee_sum) / dim - mu_y * mu_y
                r_y = torch.rsqrt(var_y + eps)
                A, B, C, E = r_y * r_x, -r_y * r_x * mu_x, r_y, -r_y * mu_y
            else:
                r_y = torch.rsqrt(var_x + eps)
                A, B, C, E = r_y, 0.0, 0.0, -r_y * mu_x
            # the slice: sum of x U c, of x U, of x^2 U^2 and of x U times each constant vector
            xuc = t_sl @ (U * c).T + ((r_sl * U) * c).sum(1)
            xu = t_u[:, None] + r_sl @ U
            xuu = t_uu[:, None] + r_sl @ (U * U)
            xuk = t_uk[:, None] + r_sl @ (U * K)
            xuf = t_uf[:, None] + r_sl @ (U * F)
            xug = t_ug[:, None] + r_sl @ (U * G)
            xx = t_xx[:, None] + 2 * t_sl @ (r_sl * U * U).T + (r_sl * r_sl) @ (U * U)
            num = A * xuc + B * (c @ U) + C * (c @ K) + E * (c @ F) + c @ G
            total = A * xu + B * sum_u + C * sum_k + E * sum_f + sum_g
            squares = (A * A * xx + 2 * A * (B * xuu + C * xuk + E * xuf + xug)
                       + B * B * sums["uu"] + C * C * sums["kk"] + E * E * sums["ff"] + sums["gg"]
                       + 2 * (B * C * sums["uk"] + B * E * sums["uf"] + B * sums["ug"] + C * E * sums["kf"]
                              + C * sums["kg"] + E * sums["fg"]))
            norm = torch.sqrt(torch.clamp(squares - total * total / length, min=0.0))
            yield (num / torch.clamp(norm, min=1e-10)).T


def _safe_corrcoef(rows):
    corrs = np.corrcoef(np.asarray(rows, np.float64))
    corrs[~np.isfinite(corrs)] = 0.0
    return corrs


def _constrained_kmeans(rows, k, size_max, rng, n_init=10, max_iter=300, tol=1e-6):
    """Lloyd iterations with a capacity-constrained assignment step, so that no cluster
    exceeds size_max rows (the reference uses the k_means_constrained package,
    analytic_attack.py:626-642, which solves the same transportation problem with ortools
    min-cost flow). Each assignment runs on the (n, k) squared-distance table through the
    host's C++ solver."""
    from .. import native

    size_max = min(size_max, len(rows))
    row_sq = np.sum(rows ** 2, axis=1, keepdims=True)
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        # k-means++ seeding
        centroids = [rows[rng.integers(len(rows))]]
        for _ in range(k - 1):
            d2 = np.min([np.sum((rows - c) ** 2, axis=1) for c in centroids], axis=0)
            probs = d2 / max(d2.sum(), 1e-12)
            centroids.append(rows[rng.choice(len(rows), p=probs)])
        centroids = np.stack(centroids)
        labels = np.zeros(len(rows), np.int64)
        for _ in range(max_iter):
            cost = row_sq - 2.0 * rows @ centroids.T + np.sum(centroids ** 2, axis=1)[None, :]
            new_labels = native.capacitated_assignment(cost, size_max)
            moved = (new_labels != labels).any()
            labels = new_labels
            new_centroids = np.stack([rows[labels == c].mean(axis=0) if (labels == c).any() else centroids[c]
                                      for c in range(k)])
            shift = float(np.sum((new_centroids - centroids) ** 2))
            centroids = new_centroids
            if not moved or shift < tol:
                break
        inertia = float(np.sum((rows - centroids[labels]) ** 2))
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels
    return best_labels


def _pam_kmedoids(corrs, k, rng, max_iter=100):
    """PAM-style k-medoids maximizing the within-cluster correlation to the medoid (the
    reference uses kmedoids.fasterpam on the correlation matrix, analytic_attack.py:644-653)."""
    n = corrs.shape[0]
    medoids = rng.choice(n, size=min(k, n), replace=False)
    labels = np.argmax(corrs[:, medoids], axis=1)
    for _ in range(max_iter):
        new_medoids = medoids.copy()
        for c in range(len(medoids)):
            members = np.nonzero(labels == c)[0]
            if len(members) == 0:
                continue
            within = corrs[np.ix_(members, members)].sum(axis=1)
            new_medoids[c] = members[int(np.argmax(within))]
        new_labels = np.argmax(corrs[:, new_medoids], axis=1)
        if (new_medoids == medoids).all() and (new_labels == labels).all():
            break
        medoids, labels = new_medoids, new_labels
    return labels.astype(np.int64)
