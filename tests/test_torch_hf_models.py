"""The port's HuggingFace architectures (``cases/models/hf_models.py``) against the JAX
package's Flax models, on the CPU.

The tiny families (``hf-gpt2-tiny``, ``hf-bert-tiny``, ``hf-roberta-tiny``,
``hf-distilbert-tiny``, vocab 128 over 8 tokens) and a 2-layer, 64-wide ReLU GPT-2 and BERT
(the widths of ``gpt2S`` and ``bert-sanity-check`` cut down; built here from
``transformers``' Flax classes through the JAX package's own wrapper), on the JAX
package's initial weights through the weight bridge (``load_flat_state``):

- parameter names, shapes and leaf order one to one with the Flax tree;
- the logits within 1e-5 of their largest entry, and the task loss's gradient with respect
  to every parameter within 1e-4 of that leaf's largest entry, from token ids and from
  float embeddings (HF's ``inputs_embeds``), with the LM heads and the three
  classification heads; GPT-2 with ``task=classification`` refused by both packages;
- the capture taps (``layer<i>/ff_input``, ``features``) within 1e-5; the causal mask
  (changing token t leaves the logits before t bit for bit); the heads' gradients
  (``head_grads``);
- the full-width parameter counts: the port's models on the ``meta`` device against
  the Flax models' shapes from ``jax.eval_shape`` (``_do_init=False``);
- an ``hf-gpt2-tiny`` and an ``hf-bert-tiny`` npz written by ``tools/convert_checkpoint.py``'s
  ``save_npz`` from the JAX package's model, loaded by the port's ``pretrained=True``:
  equal logits.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import transformers  # noqa: E402
from convert_checkpoint import save_npz  # noqa: E402

from breaching_tpu.cases.models import losses as jax_losses  # noqa: E402
from breaching_tpu.cases.models.language_models import construct_text_model as jax_construct_text_model  # noqa: E402
from breaching_tpu_torch.cases.models import losses  # noqa: E402
from breaching_tpu_torch.cases.models.hf_models import HFConfig, HFModel  # noqa: E402
from breaching_tpu_torch.cases.models.language_models import REGISTRIES, construct_text_model  # noqa: E402
from breaching_tpu_torch.cases.models.model_preparation import (_flat_entries, construct_model, head_grads,  # noqa: E402
                                                               jax_leaf_ranks, load_flat_state)

torch.set_num_threads(1)
VOCAB, TOKENS, CLASSES = 128, 8, 3
TINY = ["hf-gpt2-tiny", "hf-bert-tiny", "hf-roberta-tiny", "hf-distilbert-tiny"]
# the 2-layer, 64-wide ReLU widths of gpt2S and bert-sanity-check, built from transformers' configs
RELU = {"gpt2-relu": ("GPT2Config", dict(n_embd=64, n_layer=2, n_head=4, activation_function="relu")),
        "bert-relu": ("BertConfig", dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                         intermediate_size=256, hidden_act="relu"))}
ENCODERS = ["hf-bert-tiny", "hf-roberta-tiny", "hf-distilbert-tiny"]


class _Cfg(dict):
    __getattr__ = dict.__getitem__

    def get(self, key, default=None):
        return dict.get(self, key, default)


def _data_cfg(task, path="~/data"):
    return _Cfg(vocab_size=VOCAB, shape=[TOKENS], task=task, classes=CLASSES, name="wikitext", modality="text",
                path=path)


def _task(name):
    return "causal-lm" if "gpt2" in name else "masked-lm"


def flat_params(params) -> dict:
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@functools.lru_cache(maxsize=None)
def jax_model(name, task):
    """The JAX package's model; the ReLU widths through its ``hf-gpt2-tiny`` and
    ``hf-bert-tiny`` branches with transformers' config swapped for the test's."""
    if name not in RELU:
        return jax_construct_text_model(name, _data_cfg(task), key=jax.random.PRNGKey(1))[0]
    config_name, widths = RELU[name]
    original = getattr(transformers, config_name)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(transformers, config_name, lambda **kw: original(**{**kw, **widths}))
        tiny = "hf-gpt2-tiny" if "gpt2" in name else "hf-bert-tiny"
        return jax_construct_text_model(tiny, _data_cfg(task), key=jax.random.PRNGKey(1))[0]


def port_model(name, task):
    if name == "gpt2-relu":
        model = HFModel(HFConfig("gpt2", VOCAB, hidden=64, layers=2, heads=4, intermediate=256, max_positions=64,
                                 activation="relu", eps=1e-5))
    elif name == "bert-relu":
        model = HFModel(HFConfig("bert", VOCAB, hidden=64, layers=2, heads=4, intermediate=256, max_positions=64,
                                 activation="relu", num_labels=CLASSES if task == "classification" else None))
    else:
        return construct_text_model(name, _data_cfg(task), generator=torch.Generator().manual_seed(0))[0]
    model.registry = REGISTRIES[model.config.family](model.config.layers)
    return model


def bridged(name, task):
    """(JAX model, port model on the same weights, port loss)."""
    j_model = jax_model(name, task)
    model = port_model(name, task)
    flat = flat_params(j_model.params)
    assert load_flat_state(model, flat, strict=True) == len(flat) == len(list(model.parameters()))
    loss = {"causal-lm": losses.CausalLoss, "masked-lm": losses.MLMLoss,
            "classification": losses.CrossEntropyLoss}[task]
    return j_model, model, loss()


def _inputs(model, embeddings, rng):
    ids = rng.integers(0, VOCAB, (2, TOKENS))
    if not embeddings:
        return ids
    return (rng.standard_normal((2, TOKENS, model.ninp)) * 0.05).astype(np.float32)


def _labels(task, rng):
    if task == "classification":
        return rng.integers(0, CLASSES, (2,))
    labels = rng.integers(0, VOCAB, (2, TOKENS))
    if task == "masked-lm":
        labels[:, ::3] = -100
    return labels


def _rel_close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(name, task):
    """The JAX package's task loss and its parameter gradient, jitted once per model."""
    j_model = jax_model(name, task)
    j_loss = {"causal-lm": jax_losses.CausalLoss, "masked-lm": jax_losses.MLMLoss,
              "classification": jax_losses.CrossEntropyLoss}[task]()
    return jax.jit(jax.value_and_grad(lambda p, x, y: j_loss(j_model.apply(p, {}, x)[0], y)))


def _compare(name, task, j_model, model, loss, x, y):
    want = np.asarray(j_model.apply(j_model.params, {}, jnp.asarray(x))[0])
    got = model(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _rel_close(got.detach().numpy(), want, 1e-5, "logits")
    want_value, want_grads = jax_value_and_grad(name, task)(j_model.params, jnp.asarray(x), jnp.asarray(y))
    want_grads = flat_params(want_grads)
    params = dict(model.named_parameters())
    value = loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    grads = torch.autograd.grad(value, tuple(params.values()), allow_unused=True, materialize_grads=True)
    by_tensor = {id(p): g for p, g in zip(params.values(), grads)}
    largest = max(float(np.abs(g).max()) for g in want_grads.values())
    for key, tensor, transform in _flat_entries(model):
        expected = transform(want_grads[key]) if transform is not None else want_grads[key]
        if key.endswith(("key/bias", "k_lin/bias")):
            # zero in exact arithmetic (softmax ignores a shift shared by a query's scores):
            # both packages' rounding, held to the model's largest gradient entry
            np.testing.assert_allclose(by_tensor[id(tensor)].numpy(), expected, rtol=0, atol=1e-4 * largest)
            assert np.abs(expected).max() < 1e-6 * largest, key
            continue
        _rel_close(by_tensor[id(tensor)].numpy(), expected, 1e-4, key)
    np.testing.assert_allclose(float(value.detach()), float(want_value), rtol=1e-5)


CASES = [(name, _task(name)) for name in [*TINY, *RELU]] + [(name, "classification")
                                                             for name in [*ENCODERS, "bert-relu"]]


@pytest.mark.parametrize("name,task", CASES, ids=[f"{n}-{t}" for n, t in CASES])
def test_names_shapes_and_leaf_order_match_the_flax_tree(name, task):
    j_model, model = jax_model(name, task), port_model(name, task)
    flat = flat_params(j_model.params)
    entries = list(_flat_entries(model))
    assert sorted(key for key, _, _ in entries) == sorted(flat)
    names = {id(p): n for n, p in model.named_parameters()}
    for key, tensor, transform in entries:
        assert tuple((transform(flat[key]) if transform else flat[key]).shape) == tuple(tensor.shape), key
        # one name for one leaf: the Flax path, dotted, its last part the tensor's
        path = key[len("params/"):].split("/")
        assert names[id(tensor)] == ".".join(path[:-1] + ["bias" if path[-1] == "bias" else "weight"]), key
    # the gradient list's order: the JAX package's leaves in tree order
    keys = [key for key in (next(k for k, t, _ in entries if t is p) for p in model.parameters())]
    ranked = [k for _, k in sorted(zip(jax_leaf_ranks(model), keys))]
    leaves = ["params/" + "/".join(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(j_model.params)[0]]
    assert ranked == leaves


def test_twelve_layer_leaf_order():
    """At 12 layers flax sorts ``h/10`` and ``h/11`` before ``h/2``; so does the port."""
    config = transformers.GPT2Config(vocab_size=32, n_positions=16, n_embd=16, n_layer=12, n_head=2)
    flax = transformers.FlaxGPT2LMHeadModel(config, _do_init=False)
    shapes = jax.eval_shape(functools.partial(flax.init_weights, input_shape=(1, 8)), jax.random.PRNGKey(0))
    leaves = ["params/" + "/".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = HFModel(HFConfig("gpt2", 32, hidden=16, layers=12, heads=2, intermediate=64, max_positions=16, eps=1e-5))
    keys = {id(t): k for k, t, _ in _flat_entries(model)}
    ranked = [k for _, k in sorted(zip(jax_leaf_ranks(model), (keys[id(p)] for p in model.parameters())))]
    assert ranked == leaves and leaves.index("params/transformer/h/10/ln_1/bias") < leaves.index(
        "params/transformer/h/2/ln_1/bias")


@pytest.mark.parametrize("embeddings", [False, True], ids=["ids", "embeddings"])
@pytest.mark.parametrize("name,task", CASES, ids=[f"{n}-{t}" for n, t in CASES])
def test_logits_and_gradients_match_jax(name, task, embeddings):
    j_model, model, loss = bridged(name, task)
    rng = np.random.default_rng(3)
    x = _inputs(model, embeddings, rng)
    _compare(name, task, j_model, model, loss, x, _labels(task, rng))


@pytest.mark.parametrize("name", [*TINY, *RELU])
def test_capture_taps_match_jax(name):
    j_model, model, _ = bridged(name, _task(name))
    ids = np.random.default_rng(5).integers(0, VOCAB, (2, TOKENS))
    _, aux = j_model.apply(j_model.params, {}, jnp.asarray(ids), capture=True)
    want = aux["intermediates"]
    capture = {}
    feats = model(torch.from_numpy(ids), features=True, capture=capture)
    assert set(capture) == {f"layer{i}/ff_input" for i in range(model.nlayers)} | {"features"}
    for i in range(model.nlayers):
        _rel_close(capture[f"layer{i}/ff_input"].detach().numpy(), want[f"layer{i}"]["ff_input"][0], 1e-5, i)
    _rel_close(feats.detach().numpy(), want["features"][0], 1e-5, "features")
    assert feats is capture["features"]


@pytest.mark.parametrize("name", ["hf-gpt2-tiny", "gpt2-relu"])
def test_causal_mask(name):
    """Changing token t leaves every logit before t bit for bit, from ids and from
    embeddings; the encoders' logits before t move."""
    _, model, _ = bridged(name, "causal-lm")
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (1, TOKENS)))
    with torch.no_grad():
        base = model(ids)
        for t in range(TOKENS):
            changed = ids.clone()
            changed[0, t] = (changed[0, t] + 1) % VOCAB
            logits = model(changed)
            assert torch.equal(logits[:, :t], base[:, :t]), t
            assert not torch.equal(logits[:, t], base[:, t]), t
            embedded = model.word_embedding[changed]
            assert torch.equal(model(embedded)[:, :t], base[:, :t]), t
    _, encoder, _ = bridged("hf-bert-tiny", "masked-lm")
    with torch.no_grad():
        changed = ids.clone()
        changed[0, -1] = (changed[0, -1] + 1) % VOCAB
        assert not torch.equal(encoder(changed)[:, 0], encoder(ids)[:, 0])


@pytest.mark.parametrize("name", ["hf-gpt2-tiny", "gpt2S", "hf-gpt2"])
def test_gpt2_classification_refused(name):
    """Both packages refuse GPT-2 with ``task=classification`` (the JAX package checked at
    the test scale: it builds the full-width Flax model before it refuses)."""
    if name.endswith("-tiny"):
        with pytest.raises(ValueError):
            jax_construct_text_model(name, _data_cfg("classification"), key=jax.random.PRNGKey(1))
    with pytest.raises(ValueError):
        construct_text_model(name, _data_cfg("classification"))


@pytest.mark.parametrize("name,task", [(n, _task(n)) for n in TINY] + [(n, "classification") for n in ENCODERS])
def test_head_grads_match_jax(name, task):
    """The heads' gradients: the tied LM heads' weight is the word embedding's gradient and
    their bias zero (the JAX package's ``head_grads`` finds none; for BERT's MLM head it
    raises, so there only the port's is checked); the classifiers' weight and bias."""
    j_model, model, loss = bridged(name, task)
    rng = np.random.default_rng(11)
    x, y = rng.integers(0, VOCAB, (2, TOKENS)), _labels(task, rng)
    params = dict(model.named_parameters())
    value = loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    grads = dict(zip(params, torch.autograd.grad(value, tuple(params.values()))))
    weight, bias = head_grads(grads, model)
    if name == "hf-bert-tiny" and task == "masked-lm":
        assert torch.equal(weight, grads["bert.embeddings.word_embeddings.weight"]) and not bias.any()
        return
    _, j_grads = jax_value_and_grad(name, task)(j_model.params, jnp.asarray(x), jnp.asarray(y))
    j_weight, j_bias = j_model.head_grads(j_grads)
    _rel_close(weight.numpy(), j_weight, 1e-4, "weight")
    _rel_close(bias.numpy(), j_bias, 1e-4, "bias")
    assert weight.shape[0] == bias.shape[0]


# name -> (the Flax class and config the JAX package builds at full width, task, parameters, leaves)
FULL = {
    "gpt2S": ("FlaxGPT2LMHeadModel", ("GPT2Config", dict(activation_function="relu", resid_pdrop=0.0, embd_pdrop=0.0,
                                                         attn_pdrop=0.0)), "causal-lm", 50257, 124_439_808, 148),
    "hf-bert": ("FlaxBertForMaskedLM", ("BertConfig", {}), "masked-lm", 30522, 109_514_298, 202),
    "hf-roberta-base": ("FlaxRobertaForMaskedLM", ("RobertaConfig", dict(max_position_embeddings=514,
                                                                         pad_token_id=1)),
                        "masked-lm", 50257, 124_692_049, None),
    "hf-distilbert": ("FlaxDistilBertForMaskedLM", ("DistilBertConfig", {}), "masked-lm", 30522, 66_985_530, None),
    "bert-sanity-check": ("FlaxBertForSequenceClassification", ("BertConfig", dict(hidden_act="relu",
                                                                                   num_labels=2)),
                          "classification", 30522, 109_483_778, None),
}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_parameter_counts(name):
    flax_cls, (config_name, extra), task, vocab, count, leaves = FULL[name]
    config = getattr(transformers, config_name)(vocab_size=vocab, **extra)
    flax = getattr(transformers, flax_cls)(config, _do_init=False)
    tree = jax.eval_shape(functools.partial(flax.init_weights, input_shape=(1, 8)), jax.random.PRNGKey(0))
    shapes = {"params/" + "/".join(k.key for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    cfg = _Cfg(vocab_size=vocab, shape=[32], task=task, classes=2, name="wikitext")
    with torch.device("meta"):
        model, _ = construct_text_model(name, cfg)
    entries = list(_flat_entries(model))
    assert sorted(key for key, _, _ in entries) == sorted(shapes)
    for key, tensor, transform in entries:
        flax_shape = np.broadcast_to(np.zeros((), bool), shapes[key])
        assert (transform(flax_shape) if transform else flax_shape).shape == tuple(tensor.shape), key
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(v)) for v in shapes.values()) == count
    if leaves is not None:
        assert len(list(model.parameters())) == len(shapes) == leaves


@pytest.mark.parametrize("name", ["hf-gpt2-tiny", "hf-bert-tiny"])
def test_pretrained_npz_from_the_jax_package(name, tmp_path):
    """The npz layout of ``tools/convert_checkpoint.py convert_hf`` and ``save_npz`` (flat
    Flax keys), written from the JAX package's model, through the port's
    ``pretrained=True`` path: equal logits; the random init differs."""
    task = _task(name)
    j_model = jax_model(name, task)
    save_npz(flat_params(j_model.params), str(tmp_path), name)
    cfg = _data_cfg(task, path=str(tmp_path))
    model, _ = construct_model(name, cfg, pretrained=True, generator=torch.Generator().manual_seed(0))
    fresh, _ = construct_model(name, cfg, pretrained=False, generator=torch.Generator().manual_seed(0))
    assert model.name == name
    ids = np.random.default_rng(9).integers(0, VOCAB, (2, TOKENS))
    want = np.asarray(j_model.apply(j_model.params, {}, jnp.asarray(ids))[0])
    with torch.no_grad():
        _rel_close(model(torch.from_numpy(ids)).numpy(), want, 1e-5)
        assert not np.allclose(fresh(torch.from_numpy(ids)).numpy(), want, atol=1e-3)
