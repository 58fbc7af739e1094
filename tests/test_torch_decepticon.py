"""Decepticon on the port against the JAX package, on the CPU, at the JAX package's test
sizes (tests/test_decepticon_hard.py, test_decepticon_exact.py, test_text_stack.py): the
``random-tokens`` data, vocab 512, 12 tokens, seed 13; the victim's weights before the
rewiring carried across by the weight bridge, then each package rewires its own copy.

- The rewired parameters: every written entry equal to the JAX package's, the imprint
  bins (from forward passes) to 1e-5 relative; the secrets equal (the bins to 1e-5).
- On the JAX package's exchange (its gradients given to the port): the breach
  extraction's states to 1e-12 of the largest, every clustering algorithm's labels,
  ``_match_embeddings``, the full-vocabulary supplements and the exact-reference stack
  exactly, and the whole readout's tokens exactly.
- End to end, each package on its own exchange: the same tokens and the same report, for
  transformer3 with 1 sentence, ``gpt2-tiny`` with 2 and ``bert-tiny`` masked-LM with 2;
  and the JAX tests' thresholds on the port. With 4 sentences (k-means and
  dynamic-threshold) the two exchanges' float32 rounding (gradients 5e-7 apart relative)
  moves one extracted state by 13% (a bin whose bias jump is tiny), and the two readouts
  differ in a token (ROADMAP Queue C): there the port is held to the JAX exchange above
  and to the JAX tests' thresholds.
"""

import itertools
import types

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks import decepticon_attack as jax_dec
from breaching_tpu.cases.malicious import transformer_rewiring as jax_rewiring
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks import decepticon_attack as dec
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)
BASE = ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
        "case/data=random-tokens", "case.data.shape=[12]", "case.data.vocab_size=512",
        "case.data.default_clients=40", "case.server.has_external_data=False", "seed=13"]
# name -> (model, task, sentences, extra overrides, the JAX tests' thresholds on
# (token_acc, accuracy))
CASES = {
    "transformer3": ("transformer3", "causal-lm", 1, [], (0.5, 0.3)),
    "transformer3_x4_kmeans": ("transformer3", "causal-lm", 4, ["attack.sentence_algorithm=k-means"], (0.8, 0.8)),
    "transformer3_x4_dynamic": ("transformer3", "causal-lm", 4, ["attack.sentence_algorithm=dynamic-threshold"],
                                (0.8, 0.8)),
    "gpt2_tiny_x2": ("gpt2-tiny", "causal-lm", 2, [], (0.6, 0.5)),
    "bert_tiny_x2": ("bert-tiny", "masked-lm", 2, [], (0.5, 0.5)),
    "transformer3_separate_bins": ("transformer3", "causal-lm", 1,
                                   ["case.server.param_modification.bin_setup=separate"], (0.5, 0.3)),
}
# the cases whose two exchanges differ by float32 rounding enough to move a token
ROUNDING_APART = {"transformer3_x4_kmeans", "transformer3_x4_dynamic"}


def _flat(tree):
    return {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_names(model, flat):
    """A flat JAX tree in the port's names and layouts of ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: np.ascontiguousarray(transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model)}


def _module_name(path):
    return ".".join(path)


def build(name):
    """Both packages' cases, exchanges and attackers for CASES[name]."""
    model_name, task, points, extra, _ = CASES[name]
    overrides = BASE + [f"case.model={model_name}", f"case.data.task={task}",
                        f"case.user.num_data_points={points}", *extra]
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    victim = {}
    original = jax_rewiring.reconfigure_transformer

    def recording(model, *args, **kwargs):  # the JAX victim's weights before the rewiring
        victim.update(_flat(model.params))
        return original(model, *args, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_rewiring, "reconfigure_transformer", recording)
        j_user, j_server, _, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, victim, strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    model = server.vet_model(model)
    user = breaching.cases.construct_user(model, loss, cfg.case, setup)
    j_shared, j_payloads, j_true = j_server.run_protocol(j_user)
    shared, payloads, true = server.run_protocol(user)
    j_grads = _port_names(model, _flat(j_shared[0]["gradients"]))
    jax_exchange = [dict(shared[0], gradients={k: torch.tensor(v) for k, v in j_grads.items()})]
    return types.SimpleNamespace(
        cfg=cfg, j_cfg=j_cfg, setup=setup, j_setup=j_setup, server=server, j_server=j_server, model=model,
        shared=shared, payloads=payloads, true=true, j_shared=j_shared, j_payloads=j_payloads, j_true=j_true,
        jax_exchange=jax_exchange,
        attacker=lambda: breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup),
        j_attacker=lambda: jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, j_cfg.attack,
                                                                j_setup))


_built = {}


@pytest.fixture(params=sorted(CASES))
def case(request):
    if request.param not in _built:
        _built[request.param] = build(request.param)
    return request.param, _built[request.param]


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def test_rewired_parameters_and_secrets_match_jax(case):
    name, e = case
    ours = {key: tensor.detach().numpy() for key, tensor, _ in _flat_entries(e.model)}
    theirs = _flat(e.j_server.model.params)
    transforms = {key: transform for key, _, transform in _flat_entries(e.model)}
    assert set(ours) == set(theirs)
    bins = {f"params/{path[0]}/{path[1]}/bias" for path in e.j_server.secrets["ImprintBlock"]["weight_paths"]}
    for key, value in ours.items():
        want = transforms[key](theirs[key]) if transforms[key] else theirs[key]
        if key in bins:  # the imprint bins, calibrated by forward passes
            _rel_close(value, want, 1e-5)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)
    got, want = e.server.secrets["ImprintBlock"], e.j_server.secrets["ImprintBlock"]
    assert set(got) == set(want)
    assert got["weight_paths"] == [_module_name(p) for p in want["weight_paths"]]
    assert got["bias_paths"] == [f"{_module_name(p[:-1])}.bias" for p in want["bias_paths"]]
    assert got["kernel_layout"] == "out_in" and want["kernel_layout"] == "in_out"
    _rel_close(got["bins"], want["bins"], 1e-5)
    np.testing.assert_array_equal(got["measurement"], want["measurement"])
    for key in ("data_shape", "structure", "v_length", "bin_setup", "hidden_dim"):
        assert got[key] == want[key], key


def test_readout_on_the_jax_exchange_matches_jax(case):
    """The JAX package's gradients through the port's readout: extraction, clustering,
    tokens and confidence as the JAX package's on the same gradients."""
    name, e = case
    attacker, j_attacker = e.attacker(), e.j_attacker()
    secrets, j_secrets = e.server.secrets["ImprintBlock"], e.j_server.secrets["ImprintBlock"]
    states, preference, valid = attacker._extract_breaches(e.jax_exchange[0]["gradients"], secrets)
    j_states, j_preference, j_valid = j_attacker._extract_breaches(e.j_shared[0]["gradients"], j_secrets)
    np.testing.assert_array_equal(valid, j_valid)
    _rel_close(states[valid], j_states[j_valid], 1e-12)
    _rel_close(preference, j_preference, 1e-12)
    points = CASES[name][2]
    if points > 1:
        v = int(secrets["v_length"])
        keys = j_states[np.nonzero(j_valid)[0][:points * 12], :v]
        np.testing.assert_array_equal(attacker._cluster_sentences(keys, points, 12),
                                      j_attacker._cluster_sentences(keys, points, 12))

    rec, _ = attacker.reconstruct(e.payloads, e.jax_exchange, e.server.secrets)
    j_rec, _ = j_attacker.reconstruct(e.j_payloads, [dict(d) for d in e.j_shared], e.j_server.secrets)
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))
    _rel_close(rec["confidence"].numpy(), np.asarray(j_rec["confidence"]), 1e-5)


def test_each_package_on_its_own_exchange(case):
    """End to end through the entry points, each package on its own exchange: the same
    tokens and report, and the JAX tests' thresholds on the port's."""
    name, e = case
    rec, stats = e.attacker().reconstruct(e.payloads, e.shared, e.server.secrets)
    j_rec, _ = e.j_attacker().reconstruct(e.j_payloads, e.j_shared, e.j_server.secrets)
    metrics = breaching.analysis.report(rec, e.true, e.payloads, e.server.model, cfg_case=e.cfg.case,
                                        setup=e.setup)
    j_metrics = jax_breaching.analysis.report(j_rec, e.j_true, e.j_payloads, e.j_server.model,
                                              cfg_case=e.j_cfg.case, setup=e.j_setup)
    np.testing.assert_array_equal(e.true["data"].numpy(), np.asarray(e.j_true["data"]))
    assert set(metrics) == set(j_metrics)
    if name not in ROUNDING_APART:
        np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
        for key, value in j_metrics.items():
            if key == "feat_mse":
                np.testing.assert_allclose(metrics[key], value, rtol=1e-3)
            else:
                np.testing.assert_array_equal(np.asarray(metrics[key]), np.asarray(value), err_msg=key)
    token_acc, accuracy = CASES[name][4]
    assert metrics["token_acc"] > token_acc and metrics["accuracy"] > accuracy, metrics
    assert rec["confidence"].shape == rec["data"].shape
    assert set(stats["decepticon_seconds"]) == {"extraction", "clustering", "matching", "supplement"}


# ---------------------------------------------------------------- the readout's pieces

def _bare(attacker_cls, cfg_attack):
    attacker = attacker_cls.__new__(attacker_cls)
    attacker.cfg = cfg_attack
    attacker.setup = dict(device=torch.device("cpu"))
    return attacker


ALGORITHMS = ["k-means", "k-medoids", "dynamic-threshold", "dynamic-threshold-median",
              "dynamic-threshold-normalized", "threshold", "fcluster", "pca", "pca-direct"]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_clustering_zoo_matches_jax(algorithm):
    """The JAX test's three well-separated key clusters of 10 rows, and three that
    overlap: every algorithm's labels equal the JAX package's (or both raise)."""
    rng = np.random.default_rng(0)
    seeds = rng.standard_normal((3, 6)) * 3
    separated = np.concatenate([seeds[i] + 0.05 * rng.standard_normal((10, 6)) for i in range(3)])
    overlapping = np.concatenate([seeds[i] + 2.0 * rng.standard_normal((10, 6)) for i in range(3)])
    cfg, j_cfg = (pkg.get_config(["case=10_causal_lang_training", "attack=decepticon",
                                  f"attack.sentence_algorithm={algorithm}"]).attack
                  for pkg in (breaching, jax_breaching))
    attacker, j_attacker = _bare(dec.DecepticonAttacker, cfg), _bare(jax_dec.DecepticonAttacker, j_cfg)
    for keys in (separated, overlapping):
        try:
            want = j_attacker._cluster_sentences(keys, 3, seq_len=10)
        except AssertionError:
            with pytest.raises(AssertionError):
                attacker._cluster_sentences(keys, 3, seq_len=10)
            continue
        got = attacker._cluster_sentences(keys, 3, seq_len=10)
        np.testing.assert_array_equal(got, want)
    truth = np.repeat(np.arange(3), 10)
    agree = max((attacker._cluster_sentences(separated, 3, seq_len=10) == np.asarray(p)[truth]).mean()
                for p in itertools.permutations(range(3)))
    assert agree == 1.0


def test_matching_separation_and_backfills_match_jax():
    cfg, j_cfg = (pkg.get_config(["case=10_causal_lang_training", "attack=decepticon",
                                  "attack.sentence_based_backfill=True"]).attack
                  for pkg in (breaching, jax_breaching))
    attacker, j_attacker = _bare(dec.DecepticonAttacker, cfg), _bare(jax_dec.DecepticonAttacker, j_cfg)
    rng = np.random.default_rng(3)
    refs, queries = rng.standard_normal((12, 20)), rng.standard_normal((9, 20))
    for got, want in zip(attacker._match_embeddings(refs, queries), j_attacker._match_embeddings(refs, queries)):
        np.testing.assert_array_equal(got, want)
    _rel_close(attacker._separate(queries, refs[:9]), j_attacker._separate(queries, refs[:9]), 1e-12)
    ordered = np.zeros((24, 20), np.float32)
    ordered[[0, 3, 5, 13]] = rng.standard_normal((4, 20))
    fill, labels = rng.standard_normal((6, 20)).astype(np.float32), np.array([0, 0, 1, 1, 1, 0])
    positional = rng.standard_normal((24, 20))
    for mode in ("local", "global"):
        attacker.cfg.backfilling = j_attacker.cfg.backfilling = mode
        np.testing.assert_array_equal(
            attacker._backfill_embeddings(ordered.copy(), fill, positional, labels, (2, 12)),
            j_attacker._backfill_embeddings(ordered.copy(), fill, positional, labels, (2, 12)))
    breached = rng.standard_normal((20, 30)).astype(np.float32)
    labels = np.repeat(np.arange(2), 10)[rng.permutation(20)][:18]
    got, want = attacker._sentence_backfill(breached[:18], labels, (2, 12), 6), \
        j_attacker._sentence_backfill(breached[:18], labels, (2, 12), 6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def bert():
    if "bert_tiny_x2" not in _built:
        _built["bert_tiny_x2"] = build("bert_tiny_x2")
    e = _built["bert_tiny_x2"]
    attacker, j_attacker = e.attacker(), e.j_attacker()
    rec_models = attacker.prepare_attack(e.payloads, e.shared)[0]
    j_rec_models = j_attacker.prepare_attack(e.j_payloads, [dict(d) for d in e.j_shared])[0]
    return attacker, rec_models[0], j_attacker, j_rec_models[0]


V, SEQ = 6, 12


def test_full_vocabulary_supplement_matches_jax(bert):
    """Slots holding noisy layer-normed embeddings of known tokens, against the whole
    vocabulary on each package's device matcher: the same tokens."""
    attacker, model, j_attacker, j_model = bert
    scale, bias = attacker._first_norm_params(model)
    table = model.params["embedding"].detach().numpy()
    rng = np.random.default_rng(4)
    tokens = rng.choice(np.arange(1, 512), size=24, replace=False)
    states = dec._layer_norm(table[tokens], scale, bias)[:, V:-1]
    states = (states + 0.8 * rng.standard_normal(states.shape)).astype(np.float32)
    costs = rng.uniform(0.0, 0.5, 24)
    recovered = rng.integers(0, 512, 24)
    got = attacker._supplement_from_full_vocabulary(recovered.copy(), costs.copy(), states,
                                                    model.params["embedding"].detach(), scale, bias, V, 0.8)
    want = j_attacker._supplement_from_full_vocabulary(recovered.copy(), costs.copy(), states, table, scale, bias,
                                                       V, 0.8)
    np.testing.assert_array_equal(got, want)
    assert (got != recovered).sum() > 5


def _sliced(builder, positions, tokens):
    return np.asarray(builder(np.asarray(positions), np.asarray(tokens)))[:, V:-1]


def test_exact_reference_stack_matches_jax(bert):
    """The JAX package's exact-reference tests (test_decepticon_exact.py) on both
    packages: planted tokens, a collided row and misplaced rows give the same outputs."""
    attacker, model, j_attacker, j_model = bert
    builder, j_builder = attacker._exact_reference_builder(model, SEQ), j_attacker._exact_reference_builder(j_model,
                                                                                                           SEQ)
    positions, tokens = np.arange(SEQ), np.random.default_rng(0).choice(np.arange(1, 500), SEQ, replace=False)
    _rel_close(_sliced(builder, positions, tokens), _sliced(j_builder, positions, tokens), 1e-12)
    ordered = _sliced(j_builder, positions, tokens)

    def both(method, *args):
        return (getattr(attacker, method)(*(a.copy() if isinstance(a, np.ndarray) else a for a in args[0])),
                getattr(j_attacker, method)(*(a.copy() if isinstance(a, np.ndarray) else a for a in args[1])))

    weak = (np.zeros(SEQ, np.int64), np.full(SEQ, -np.inf), ordered)
    got, want = both("_supplement_exact", (*weak, model, (1, SEQ), V, 0.8), (*weak, j_model, (1, SEQ), V, 0.8))
    np.testing.assert_array_equal(got, want)
    assert (got == tokens).all()

    state_a, state_b = _sliced(j_builder, [3], [101])[0], _sliced(j_builder, [7], [202])[0]
    collided = np.zeros((SEQ, state_a.shape[0]))
    collided[3] = collided[7] = 0.6 * state_a + 0.4 * state_b
    recovered, costs = np.zeros(SEQ, np.int64), np.full(SEQ, -np.inf)
    recovered[3], costs[3], costs[7] = 101, 0.9, 0.1
    leaked = np.asarray([101, 202])
    (got_tokens, got_costs), (want_tokens, want_costs) = both(
        "_recover_collisions", (model, collided, recovered, costs, leaked, (1, SEQ), V),
        (j_model, collided, recovered, costs, leaked, (1, SEQ), V))
    np.testing.assert_array_equal(got_tokens, want_tokens)
    np.testing.assert_allclose(got_costs, want_costs, rtol=1e-12)
    assert got_tokens[7] == 202

    misplaced = np.zeros_like(ordered)
    toks, costs = np.zeros(SEQ, np.int64), np.full(SEQ, -np.inf)
    for right, wrong in zip(range(0, SEQ, 2), range(1, SEQ, 2)):
        misplaced[wrong], toks[wrong], costs[wrong] = ordered[right], tokens[right], 0.8
    got, want = both("_exact_position_round", (model, misplaced, toks, costs, (1, SEQ), V),
                     (j_model, misplaced, toks, costs, (1, SEQ), V))
    assert got[0] and want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-12)
