"""Token recovery, the permutation attack's pieces and the text metrics of the port
against the JAX package's, on the CPU.

- The six ``token_strategy`` recoveries and the ``bias-text`` label strategy, each on
  both packages' FL exchange of 2 sentences x 12 tokens on the same weights (an untied and
  a tied transformer, vocab 128): the same tokens.
- ``max_cosine_similarity``: the same argmax as the JAX package's
  ``_max_cosine_similarity``.
- Sinkhorn-Knopp within 1e-6 (float32, 20 normalizations), the assignment of positions to
  tokens the same, and a step whose loss is not finite leaving the permutation candidate
  as it was, not projected again (the JAX step projects the update, then keeps the old
  candidate).
- The text metrics (token accuracy, BLEU, ROUGE, the batch order) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.analysis import text_metrics as jax_text_metrics
from breaching_tpu.attacks.auxiliaries import text_utils as jax_text_utils
from breaching_tpu.attacks.optimization_permutation_attack import sinkhorn_knopp as jax_sinkhorn_knopp
import breaching_tpu_torch as breaching
from breaching_tpu_torch.analysis import text_metrics
from breaching_tpu_torch.attacks.auxiliaries import text_utils
from breaching_tpu_torch.attacks.optimization_permutation_attack import project_permutation, sinkhorn_knopp
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

torch.set_num_threads(1)
CASE10 = ["case=10_causal_lang_training", "case.data.vocab_size=128", "case.data.shape=[12]", "seed=0",
          "case.user.num_data_points=2", "case.data.batch_size=2"]
STRATEGIES = ["decoder-bias", "embedding-norm", "embedding-log", "mixed", "greedy-embedding", "greedy-bias"]


def _flat(params):
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def both_exchanges(overrides):
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    load_flat_state(model, _flat(j_model.params), strict=True)
    return dict(cfg=cfg, setup=setup, server=server, exchange=server.run_protocol(user), j_cfg=jax_cfg,
                j_setup=jax_setup, j_server=j_server, j_exchange=j_server.run_protocol(j_user))


@pytest.fixture(scope="module", params=["transformer3", "transformer3t"])
def exchanges(request):
    return both_exchanges(CASE10 + [f"case.model={request.param}", "attack=tag",
                                    "attack.attack_type=optimization", "attack.label_strategy=None"])


def _prepared_labels(e, **attack):
    """Both packages' labels from ``prepare_attack`` under the attack settings given."""
    out = []
    for package, cfg, setup, server, (shared, payloads, _) in (
            (jax_breaching, e["j_cfg"], e["j_setup"], e["j_server"], e["j_exchange"]),
            (breaching, e["cfg"], e["setup"], e["server"], e["exchange"])):
        attacker = package.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        for key, value in attack.items():
            attacker.cfg[key] = value
        _, labels, _ = attacker.prepare_attack(payloads, [dict(d) for d in shared])
        out.append(np.asarray(labels))
    return out


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_token_recovery_matches_jax(exchanges, strategy):
    want, got = _prepared_labels(exchanges, token_strategy=strategy)
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


def test_bias_text_matches_jax(exchanges):
    want, got = _prepared_labels(exchanges, label_strategy="bias-text")
    assert got.shape == want.shape == (2, 12)
    np.testing.assert_array_equal(got, want)


def test_repeat_count_estimate_matches_jax():
    rng = np.random.default_rng(0)
    for energies, missing in ((rng.uniform(1, 1.02, 20) * np.repeat([1, 4, 9], [14, 4, 2]), 32),
                              (np.ones(10), 24), (rng.uniform(0, 5, 30), 31)):
        np.testing.assert_array_equal(text_utils.estimate_repeat_counts(energies, missing),
                                      jax_text_utils.estimate_repeat_counts(energies, missing))


@pytest.mark.parametrize("shape", [(24, 16, 128), (32, 96, 4096)])
def test_max_cosine_similarity_argmax_matches_jax(shape):
    n, width, vocab = shape
    rng = np.random.default_rng(1)
    rec = rng.standard_normal((n, width)).astype(np.float32)
    table = rng.standard_normal((vocab, width)).astype(np.float32)
    rec[:4] = table[[3, 7, 7, 100]] * 2.5 + 0.1  # exact matches up to scale and offset
    want = np.asarray(jax_text_utils._max_cosine_similarity(jnp.asarray(rec), jnp.asarray(table)))
    got = text_utils.max_cosine_similarity(torch.from_numpy(rec), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[:4]) == [3, 7, 7, 100]


@pytest.mark.parametrize("size", [8, 32, 256])
def test_sinkhorn_matches_jax(size):
    matrix = np.random.default_rng(size).uniform(size=(size, size)).astype(np.float32)
    matrix[0, 0] = 0.0  # clamped to eps
    want = np.asarray(jax_sinkhorn_knopp(jnp.clip(jnp.asarray(matrix), 0.0, 1.0)))
    got = project_permutation(torch.from_numpy(matrix)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sinkhorn_knopp(torch.from_numpy(matrix)).sum(0).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def permutation_case():
    return both_exchanges(CASE10 + ["case.model=transformer1", "attack=permutation",
                                    "attack.optim.max_iterations=3", "attack.optim.callback=1"])


def test_permutation_extraction_matches_jax(permutation_case):
    e = permutation_case
    cfg, setup, server = e["cfg"], e["setup"], e["server"]
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_attacker = jax_breaching.attacks.prepare_attack(e["j_server"].model, e["j_server"].loss, e["j_cfg"].attack,
                                                      e["j_setup"])
    leaked = np.random.default_rng(2).integers(0, 128, 24)
    attacker._leaked, attacker._num_points = torch.from_numpy(leaked), 2
    j_attacker._leaked_flat, j_attacker._num_points = jnp.asarray(leaked), 2
    perm = np.random.default_rng(3).uniform(size=(24, 24)).astype(np.float32)
    got = attacker._extract_solution(dict(data=torch.from_numpy(perm)), None)
    want = j_attacker._extract_solution(dict(data=jnp.asarray(perm)), None)
    np.testing.assert_array_equal(got["data"].numpy(), np.asarray(want["data"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert got["data"].shape == (2, 12)


def test_a_non_finite_permutation_step_keeps_the_candidate_unprojected(permutation_case):
    """Step 2's loss is made NaN: the step is rejected and the candidate stays what it
    was, bit for bit. Projecting it again would change it (Sinkhorn is not idempotent)."""
    e = permutation_case
    cfg, setup, server = e["cfg"], e["setup"], e["server"]
    shared, payloads, _ = e["exchange"]
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    attacker.cfg.optim.callback = 3  # one read-back for the three steps: the NaN does not end the run
    seen, plain_loss = [], attacker._loss

    def loss(candidate, *args, **kwargs):
        seen.append(candidate["data"].detach().clone())
        value, task = plain_loss(candidate, *args, **kwargs)
        return (value * float("nan") if len(seen) == 2 else value), task

    attacker._loss = loss
    rec, stats = attacker.reconstruct(payloads, shared, server.secrets)
    values = stats["Trial_0_Val"]
    assert len(values) == 3 and np.isnan(values[1]) and np.isfinite(values[0]) and np.isfinite(values[2])
    torch.testing.assert_close(seen[2], seen[1], rtol=0, atol=0)  # step 2 rejected
    assert not torch.equal(project_permutation(seen[1]), seen[1])
    assert not torch.equal(seen[1], seen[0])  # step 1 accepted, and projected
    torch.testing.assert_close(project_permutation(seen[1]), project_permutation(project_permutation(seen[1])),
                               rtol=0, atol=1e-3)
    assert rec["data"].shape == (2, 12)


def _sequences(seed, batch=3, length=10, vocab=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, length))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_metrics_match_jax_exactly(seed):
    ref = _sequences(seed)
    rec = np.concatenate([ref[2:], ref[:1], _sequences(seed + 10, batch=1)])  # shuffled, one new
    rec[0, :3] = 0
    want = jax_text_metrics.run_text_metrics(dict(data=rec), dict(data=ref), None, None)
    got_data = dict(data=torch.from_numpy(rec))
    got = text_metrics.run_text_metrics(got_data, dict(data=torch.from_numpy(ref)), None, None)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got_data["order"], want["order"])
    for n in (1, 2, 3):
        assert text_metrics.rouge_n(list(rec), list(ref), n) == jax_text_metrics.rouge_n(list(rec), list(ref), n)
    assert text_metrics.bleu(list(rec), list(ref), smooth=False) == \
        jax_text_metrics.bleu(list(rec), list(ref), smooth=False)
