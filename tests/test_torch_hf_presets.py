"""The honest server's text attacks on the port's HuggingFace architectures against the
JAX package's Flax models, on the CPU: ``tag`` on each tiny family (``hf-gpt2-tiny`` causal,
``hf-bert-tiny``, ``hf-roberta-tiny`` and ``hf-distilbert-tiny`` masked LM) and on the
BERT sequence-classification head (cola, 2 sentences), at vocab 128 and 8 tokens
(``permutation`` on ``hf-gpt2-tiny`` is in tests/test_torch_hf_permutation.py, so that each
file takes well under 90 s alone).

Both packages attack the same FL exchange on the same weights (the JAX package's, through
the weight bridge) from the JAX package's own initial candidate tree, for 3 steps; as
tests/test_torch_text_presets.py holds the non-HF presets: every loss within 1e-3
relative, the recovered tokens and labels equal, the report's text metrics equal and its
feature-space MSE within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from test_torch_text_presets import both_cases, share_jax_initial_candidate

torch.set_num_threads(1)
SMALL = ["case.data.vocab_size=128", "case.data.shape=[8]", "seed=0"]
CASE10 = ["case=10_causal_lang_training"] + SMALL
CASE9 = ["case=9_bert_training"] + SMALL
COLA = CASE10 + ["case/data=cola", "case.data.task=classification", "case.data.size=64",
                 "case.data.default_clients=16", "case.user.num_data_points=2"]
PRESETS = {
    "tag_hf_gpt2_tiny": CASE10 + ["attack=tag", "case.model=hf-gpt2-tiny"],
    "tag_hf_bert_tiny": CASE9 + ["attack=tag", "case.model=hf-bert-tiny"],
    "tag_hf_roberta_tiny": CASE10 + ["attack=tag", "case.model=hf-roberta-tiny", "case.data.task=masked-lm"],
    "tag_hf_distilbert_tiny": CASE9 + ["attack=tag", "case.model=hf-distilbert-tiny"],
    "tag_hf_bert_tiny_classification": COLA + ["attack=tag", "case.model=hf-bert-tiny"],
}


def steps_and_report_match_jax(overrides, points=1):
    """Both packages' 3 steps from the JAX package's initial candidate, their tokens and
    reports compared; returns (the candidate tree, the port's case)."""
    e = both_cases(overrides + ["attack.optim.max_iterations=3", "attack.optim.callback=1"])
    tree = share_jax_initial_candidate(e)

    j_rec, j_stats = e["j_attacker"].reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    rec, stats = e["attacker"].reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert rec["data"].dtype == torch.int64 and rec["data"].shape == (points, 8)
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))

    j_metrics = jax_breaching.analysis.report(j_rec, e["j_true"], e["j_payloads"], e["j_server"].model)
    metrics = breaching.analysis.report(rec, e["true"], e["payloads"], e["server"].model)
    assert set(metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        if key == "feat_mse":
            np.testing.assert_allclose(metrics[key], value, rtol=1e-3)
        else:
            np.testing.assert_array_equal(np.asarray(metrics[key]), np.asarray(value), err_msg=key)
    return tree, e


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_hf_preset_steps_and_report_match_jax(preset):
    points = 2 if "classification" in preset else 1
    tree, e = steps_and_report_match_jax(PRESETS[preset], points)
    assert tree["data"].shape == (points, 8, e["server"].model.ninp)

