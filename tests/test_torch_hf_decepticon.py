"""Decepticon on the port's HuggingFace architectures against the JAX package's Flax
models, on the CPU, at the JAX tests' sizes (tests/test_decepticon_hard.py:93-119,
tests/test_hf_families.py:119-130): ``random-tokens`` data, vocab 512, 12 tokens, one
sentence, seed 13, the victim's weights before the rewiring carried across by the weight
bridge, then each package rewires its own copy.

- The rewiring through each family's registry (GPT-2's fused Conv1D ``c_attn``, the
  encoders' separate query/key/value, the positions through the embedding LayerNorm,
  RoBERTa's position offset): every written entry equal to the JAX package's, the imprint
  bins (from forward passes) to 1e-5 relative; the secrets equal.
- On the JAX package's exchange: the readout's tokens and confidence as the JAX package's,
  for ``decepticons_hf_bert``'s exact-reference stack (``exact_supplement``,
  ``collision_recovery``, ``exact_refinement=2``) too.
- Each package on its own exchange: the JAX tests' thresholds on the port's, and the same
  tokens as the JAX package's.
"""

import types

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.malicious import transformer_rewiring as jax_rewiring
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.malicious import transformer_rewiring
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)
PMOD = "case.server.param_modification"
BASE = ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
        "case/data=random-tokens", "case.data.shape=[12]", "case.data.vocab_size=512",
        "case.data.default_clients=40", "case.server.has_external_data=False", "case.user.num_data_points=1",
        "seed=13", f"{PMOD}.eps=1e-8", f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm",
        "attack.embedding_token_weight=0.0"]
ENCODER = ["case.data.task=masked-lm", f"{PMOD}.reset_embedding=True", f"{PMOD}.v_length=16",
           f"{PMOD}.measurement_scale=1e8"]
EXACT = ["attack.exact_supplement=True", "attack.collision_recovery=True", "attack.exact_refinement=2",
         "attack.embedding_token_weight=0.8"]
# name -> (overrides, the JAX tests' thresholds on (token_acc, accuracy))
CASES = {
    "hf-gpt2-tiny": (["case.model=hf-gpt2-tiny", "case.data.task=causal-lm", f"{PMOD}.v_length=32",
                      f"{PMOD}.measurement_scale=1e6"], (0.8, 0.6)),
    "hf-bert-tiny": (["case.model=hf-bert-tiny", *ENCODER], (0.7, 0.4)),
    "hf-bert-tiny exact": (["case.model=hf-bert-tiny", *ENCODER, *EXACT], (0.7, 0.4)),
    "hf-roberta-tiny": (["case.model=hf-roberta-tiny", *ENCODER], (0.7, 0.5)),
    "hf-distilbert-tiny": (["case.model=hf-distilbert-tiny", *ENCODER], (0.7, 0.5)),
}


def _flat(tree):
    return {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_names(model, flat):
    """A flat JAX tree in the port's names and layouts of ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: np.ascontiguousarray(transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model)}


def build(name):
    """Both packages' cases, exchanges and attackers for CASES[name]."""
    overrides = BASE + CASES[name][0]
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
    secrets, j_secrets = e.server.secrets["ImprintBlock"], e.j_server.secrets["ImprintBlock"]
    bins = {"params/" + "/".join(path) + "/bias" for path in j_secrets["weight_paths"]}
    for key, value in ours.items():
        want = transforms[key](theirs[key]) if transforms[key] else theirs[key]
        if key in bins:  # the imprint bins, calibrated by forward passes
            _rel_close(value, want, 1e-5)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)
    assert set(secrets) == set(j_secrets)
    assert secrets["weight_paths"] == [".".join(p) for p in j_secrets["weight_paths"]]
    assert secrets["bias_paths"] == [".".join(p[:-1]) + ".bias" for p in j_secrets["bias_paths"]]
    assert secrets["kernel_layout"] == "out_in"
    assert j_secrets["kernel_layout"] == ("out_in" if "gpt2" in name else "in_out")
    _rel_close(secrets["bins"], j_secrets["bins"], 1e-5)
    np.testing.assert_array_equal(secrets["measurement"], j_secrets["measurement"])
    for key in ("data_shape", "structure", "v_length", "bin_setup", "hidden_dim"):
        assert secrets[key] == j_secrets[key], key


def test_readout_on_the_jax_exchange_matches_jax(case):
    """The JAX package's gradients through the port's readout: the tokens and confidence
    of the JAX package's readout on the same gradients."""
    name, e = case
    rec, _ = e.attacker().reconstruct(e.payloads, e.jax_exchange, e.server.secrets)
    j_rec, _ = e.j_attacker().reconstruct(e.j_payloads, [dict(d) for d in e.j_shared], e.j_server.secrets)
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))
    _rel_close(rec["confidence"].numpy(), np.asarray(j_rec["confidence"]), 1e-5)


def test_each_package_on_its_own_exchange(case):
    """Through the entry points, each package on its own exchange: the same tokens, and
    the JAX tests' thresholds on the port's."""
    name, e = case
    rec, stats = e.attacker().reconstruct(e.payloads, e.shared, e.server.secrets)
    j_rec, _ = e.j_attacker().reconstruct(e.j_payloads, e.j_shared, e.j_server.secrets)
    metrics = breaching.analysis.report(rec, e.true, e.payloads, e.server.model, cfg_case=e.cfg.case,
                                        setup=e.setup)
    np.testing.assert_array_equal(e.true["data"].numpy(), np.asarray(e.j_true["data"]))
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
    token_acc, accuracy = CASES[name][1]
    assert metrics["token_acc"] > token_acc and metrics["accuracy"] > accuracy, metrics
    assert set(stats["decepticon_seconds"]) == {"extraction", "clustering", "matching", "supplement"}


def test_positional_table_with_the_roberta_offset():
    """RoBERTa reads its position rows from pad_token_id + 1 = 2: the registry's
    ``pos_offset`` makes ``positional_table`` give those rows, as the JAX package's."""
    e = _built.get("hf-roberta-tiny") or build("hf-roberta-tiny")
    model = e.server.model
    assert model.registry["pos_offset"] == 2
    params = dict(model.named_parameters())
    table = transformer_rewiring.positional_table(model, params, 8)
    full = params["roberta.embeddings.position_embeddings.weight"].detach().numpy()
    np.testing.assert_array_equal(table, full[2:10])
    np.testing.assert_array_equal(table, jax_rewiring.positional_table(e.j_server.model, e.j_server.model.params, 8))


def _composed_scores(wte, pos_rows, emb_norm, n_scale, n_bias, states, v):
    """The exact references composed row by row, LN_first(embLN(wte + pos_slot)), the way the
    JAX package's ``_device_exact_vocab_match`` forms them, correlated with the states."""
    from breaching_tpu_torch.attacks import decepticon_attack as dec

    x = wte[None] + pos_rows[:, None]
    if emb_norm is not None:
        x = dec._torch_layer_norm(x, *emb_norm)
    refs = dec._unit_rows(dec._torch_layer_norm(x, n_scale, n_bias)[:, 1:, v:-1])
    return torch.einsum("svd,sd->sv", refs, dec._unit_rows(states))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("emb_norm", [True, False], ids=["embedding-norm", "no-embedding-norm"])
def test_exact_scores_equal_the_composed_references(emb_norm, dtype):
    """``exact_scores`` (the references' LayerNorm statistics from products of the table)
    against the references composed row by row: 1e-12 in float64, 1e-5 in float32 (sums in
    other orders), at 300 tokens of width 96, 20 slots, content slice [16:-1]."""
    from breaching_tpu_torch.attacks import decepticon_attack as dec

    gen = torch.Generator().manual_seed(3)
    vocab, dim, slots, v = 300, 96, 20, 16

    def draw(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, dtype=torch.float64) * scale + shift).to(dtype)

    wte, pos = draw(vocab, dim), draw(slots, dim, scale=0.3, shift=0.1)
    norm = (draw(dim, scale=0.3, shift=1.0), draw(dim, scale=0.1)) if emb_norm else None
    scale, bias, states = draw(dim, scale=0.3, shift=1.0), draw(dim, scale=0.2), draw(slots, dim - v - 1)
    want = _composed_scores(wte, pos, norm, scale, bias, states, v)
    got = torch.cat(list(dec.exact_scores(wte, pos, norm, scale, bias, states, v)))
    assert got.shape == want.shape == (slots, vocab - 1)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
