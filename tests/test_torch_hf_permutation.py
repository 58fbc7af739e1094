"""The permutation attack on the port's ``hf-gpt2-tiny`` against the JAX package's Flax
GPT-2, on the CPU, at vocab 128 and 8 tokens: GPT-2's tied LM head has no bias, so both
packages refuse ``decoder-bias`` token recovery there, and with
``token_strategy=embedding-norm`` (the bag of tokens from the embedding's gradient norms,
as ``decepticons_gpt2`` takes it) both attack the same exchange from the JAX package's
initial (P, P) matrix for 3 steps: every loss within 1e-3 relative, the recovered tokens
and the report equal (its feature-space MSE within 1e-3 relative), as
tests/test_torch_hf_presets.py holds TAG.
"""

import numpy as np
import pytest
import torch

from test_torch_hf_presets import CASE10, steps_and_report_match_jax
from test_torch_text_presets import both_cases

torch.set_num_threads(1)
PERMUTATION = CASE10 + ["attack=permutation", "case.model=hf-gpt2-tiny"]


def test_permutation_on_hf_gpt2_matches_jax():
    tree, e = steps_and_report_match_jax(PERMUTATION + ["attack.token_strategy=embedding-norm"])
    assert tree["data"].shape == (8, 8)
    np.testing.assert_array_equal(np.sort(e["attacker"]._leaked.numpy()),
                                  np.sort(e["true"]["data"].numpy().reshape(-1)))


def test_decoder_bias_token_recovery_refused_on_gpt2():
    """GPT-2's tied LM head has no bias: ``decoder-bias`` token recovery raises in both
    packages."""
    e = both_cases(PERMUTATION)
    with pytest.raises(ValueError, match="decoder bias"):
        e["j_attacker"].prepare_attack(e["j_payloads"], [dict(d) for d in e["j_shared"]])
    with pytest.raises(ValueError, match="decoder bias"):
        e["attacker"].prepare_attack(e["payloads"], e["shared"])
