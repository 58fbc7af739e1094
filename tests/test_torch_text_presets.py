"""The honest server's text presets of ``examples/run_example.py`` through the port's
``reconstruct`` and ``report``, against the JAX package's, on the CPU: ``tag`` (case 10,
and on the tied pre-LN ``gpt2-tiny``), ``permutation``, ``dlg_text`` and case 9's
masked-LM ``bert`` with ``attack=tag``, cut to vocab 128 and 8 tokens.

Both packages attack the same FL exchange on the same weights from the JAX package's own
initial candidate tree (embeddings and token-label logits, or the permutation matrix),
given to both by overriding each attacker's candidate initialization, for 3 steps (2 of
L-BFGS). Tolerances, as tests/test_torch_presets.py holds the vision presets (float32 on
both sides, sums in other orders, through a double backward): every loss 1e-3
relative; the recovered tokens and labels equal; the report's text metrics, label
accuracy and parameter count equal, its feature-space MSE 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

torch.set_num_threads(1)
SMALL = ["case.data.vocab_size=128", "case.data.shape=[8]", "seed=0"]
CASE10 = ["case=10_causal_lang_training"] + SMALL
PRESETS = {
    "tag": CASE10 + ["attack=tag"],
    "tag_gpt2_tiny": CASE10 + ["attack=tag", "case.model=gpt2-tiny"],
    "permutation": CASE10 + ["attack=permutation", "case.model=transformer1"],
    "dlg_text": CASE10 + ["attack=deepleakage", "case.user.provide_labels=False", "case.model=linear"],
    "bert_tag": ["case=9_bert_training", "case.model=bert-tiny", "attack=tag"] + SMALL,
}


def _flat(params):
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def both_cases(overrides):
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    load_flat_state(model, _flat(j_model.params), strict=True)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, j_true = j_server.run_protocol(j_user)
    shared, payloads, true = server.run_protocol(user)
    return dict(cfg=cfg, setup=setup, server=server, attacker=attacker, shared=shared, payloads=payloads,
                true=true, j_server=j_server, j_attacker=j_attacker, j_shared=j_shared, j_payloads=j_payloads,
                j_true=j_true)


def share_jax_initial_candidate(e):
    """Give both attackers the JAX package's initial candidate tree."""
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    metadata = e["j_payloads"][0]["metadata"]
    j_attacker._task, j_attacker._vocab_size = metadata.get("task"), metadata.get("vocab_size")
    j_attacker._num_classes = metadata.get("classes")
    _, j_labels, _ = j_attacker.prepare_attack(e["j_payloads"], [dict(d) for d in e["j_shared"]])
    num_points = int(e["j_shared"][0]["metadata"]["num_data_points"])
    tree = {k: np.asarray(v) for k, v in
            j_attacker._init_candidate_tree(num_points, jax.random.PRNGKey(5), j_labels).items()}
    j_attacker._init_candidate_tree = lambda n, key, labels: {k: jnp.asarray(v) for k, v in tree.items()}
    attacker._init_candidate_tree = lambda num_trials, n: {k: torch.from_numpy(v.copy())[None]
                                                           for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_text_preset_steps_and_report_match_jax(preset):
    steps = 2 if preset == "dlg_text" else 3
    e = both_cases(PRESETS[preset] + [f"attack.optim.max_iterations={steps}", "attack.optim.callback=1"])
    tree = share_jax_initial_candidate(e)
    if preset == "permutation":
        assert tree["data"].shape == (8, 8)
    else:
        assert tree["data"].shape[1:] == (8, e["server"].model.embedding.shape[1])
        assert tree["labels"].shape[1:] == (8, 128)

    j_rec, j_stats = e["j_attacker"].reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    rec, stats = e["attacker"].reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == steps and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert rec["data"].dtype == torch.int64 and rec["data"].shape == (1, 8)
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
