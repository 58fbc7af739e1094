"""Text reconstruction metrics, a copy of ``breaching_tpu/analysis/text_metrics.py``
(pure numpy and scipy): token accuracy, BLEU, ROUGE-1/2/L on token ids, and the order
of a batch of sentences by token overlap (reference: analysis.py:110-202, 378-394).
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu(candidates, references, max_n=4, smooth=True):
    """Corpus BLEU over token-id sequences (modified n-gram precision with
    brevity penalty; add-1 smoothing à la sacrebleu's exp smoothing)."""
    log_precisions = []
    for n in range(1, max_n + 1):
        matches, total = 0, 0
        for cand, ref in zip(candidates, references):
            cand_ngrams = _ngrams(list(cand), n)
            ref_ngrams = _ngrams(list(ref), n)
            matches += sum(min(c, ref_ngrams[g]) for g, c in cand_ngrams.items())
            total += max(sum(cand_ngrams.values()), 0)
        if total == 0:
            return 0.0
        if matches == 0:
            if not smooth:
                return 0.0
            matches = 1
        log_precisions.append(np.log(matches / total))
    cand_len = sum(len(c) for c in candidates)
    ref_len = sum(len(r) for r in references)
    bp = 1.0 if cand_len >= ref_len else np.exp(1 - ref_len / max(cand_len, 1))
    return float(bp * np.exp(np.mean(log_precisions)))


def rouge_n(candidates, references, n=1):
    """Mean ROUGE-N F1 over pairs."""
    scores = []
    for cand, ref in zip(candidates, references):
        cand_ngrams = _ngrams(list(cand), n)
        ref_ngrams = _ngrams(list(ref), n)
        overlap = sum(min(c, ref_ngrams[g]) for g, c in cand_ngrams.items())
        p = overlap / max(sum(cand_ngrams.values()), 1)
        r = overlap / max(sum(ref_ngrams.values()), 1)
        scores.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
    return float(np.mean(scores)) if scores else 0.0


def _lcs_len(a, b):
    dp = np.zeros((len(a) + 1, len(b) + 1), np.int32)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            dp[i + 1, j + 1] = dp[i, j] + 1 if x == y else max(dp[i, j + 1], dp[i + 1, j])
    return int(dp[-1, -1])


def rouge_l(candidates, references):
    scores = []
    for cand, ref in zip(candidates, references):
        lcs = _lcs_len(list(cand), list(ref))
        p = lcs / max(len(cand), 1)
        r = lcs / max(len(ref), 1)
        scores.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
    return float(np.mean(scores)) if scores else 0.0


def compute_text_order(rec_sequences, ref_sequences):
    """Match reconstructed to true sentences by token overlap + assignment
    (reference: analysis.py:378-394)."""
    from scipy.optimize import linear_sum_assignment

    B = len(rec_sequences)
    if B == 1:
        return np.asarray([0])
    cost = np.zeros((B, B))
    for i, ref in enumerate(ref_sequences):
        ref_counts = Counter(list(ref))
        for j, rec in enumerate(rec_sequences):
            rec_counts = Counter(list(rec))
            overlap = sum(min(c, rec_counts[t]) for t, c in ref_counts.items())
            cost[i, j] = -overlap
    _, order = linear_sum_assignment(cost)
    return order


def _ids(data):
    """Token ids as a numpy array (from a tensor on any device)."""
    return data.detach().cpu().numpy() if hasattr(data, "detach") else np.asarray(data)


def run_text_metrics(rec_data, true_data, server_payload, model, order_batch=True):
    rec = _ids(rec_data["data"])
    ref = _ids(true_data["data"])
    if rec.ndim == 1:
        rec = rec[None]
    if ref.ndim == 1:
        ref = ref[None]

    if order_batch and rec.shape[0] == ref.shape[0] and rec.shape[0] > 1:
        order = compute_text_order(list(rec), list(ref))
        rec = rec[order]
        rec_data["order"] = order

    total = ref.size
    token_acc = float((rec[:, :ref.shape[1]] == ref).sum() / max(total, 1))

    # frequency-corrected token accuracy (multiset overlap; reference analysis.py:315-329)
    overlap = 0
    for r_row, t_row in zip(rec, ref):
        r_counts, t_counts = Counter(r_row.tolist()), Counter(t_row.tolist())
        overlap += sum(min(c, r_counts[t]) for t, c in t_counts.items())
    fcorr_acc = overlap / max(total, 1)

    return dict(
        accuracy=token_acc,
        token_acc=fcorr_acc,
        bleu=bleu(list(rec), list(ref)),
        google_bleu=bleu(list(rec), list(ref), max_n=4, smooth=True),
        # HONEST LABEL: this is the local BLEU x 100 (sacrebleu's 0-100 scale)
        # computed on token ids, NOT the sacrebleu package with its own
        # tokenization (a network dependency). Key kept for reference-name
        # parity; report() prints it as "S-BLEU (local)".
        sacrebleu=100 * bleu(list(rec), list(ref)),
        rouge1=rouge_n(list(rec), list(ref), 1),
        rouge2=rouge_n(list(rec), list(ref), 2),
        rougeL=rouge_l(list(rec), list(ref)),
        order=rec_data.get("order"),
    )
