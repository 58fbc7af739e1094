"""The port's language models and text losses against the JAX package's, on the CPU.

Every non-HF text model (``construct_text_model``) at vocab 128 over 8 tokens, on the
JAX package's initial weights through the weight bridge (``load_flat_state``): the
logits within 1e-5 of their largest entry, and the gradient of the task loss with
respect to every parameter within 1e-4 of that leaf's largest entry, from token ids and
from float embeddings (the ``run-embedding`` path), with the LM head and with the
classifier head of ``task=classification``. A 12-layer transformer at width 16 gives
the leaf order of ``tag-euclidean`` at the depth of ``gpt2`` and ``bert``: flax sorts
``layer10`` and ``layer11`` before ``layer2``. The losses (causal, masked, mostly
causal) on hard and soft labels within 1e-6 (float32 on both sides, sums in other
orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.attacks.auxiliaries.objectives import EuclideanTag as JaxEuclideanTag
from breaching_tpu.cases.models import losses as jax_losses
from breaching_tpu.cases.models.language_models import TransformerModel as JaxTransformer
from breaching_tpu.cases.models.language_models import construct_text_model as jax_construct_text_model
from breaching_tpu.cases.models.model_preparation import JaxModel
from breaching_tpu_torch.attacks.auxiliaries.objectives import EuclideanTag
from breaching_tpu_torch.cases.models import losses
from breaching_tpu_torch.cases.models.language_models import TransformerModel, construct_text_model
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, jax_leaf_ranks, load_flat_state

torch.set_num_threads(1)
VOCAB, TOKENS = 128, 8
NAMES = ["transformer3f", "transformer3", "transformer3t", "transformer1", "transformerS", "LSTM", "linear",
         "gpt2-tiny", "bert-tiny"]


class _Cfg(dict):
    __getattr__ = dict.__getitem__

    def get(self, key, default=None):
        return dict.get(self, key, default)


def _data_cfg(task="causal-lm"):
    return _Cfg(vocab_size=VOCAB, shape=[TOKENS], task=task, classes=3, name="wikitext")


def flat_params(params) -> dict:
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@functools.lru_cache(maxsize=None)
def jax_model(name, task):
    """The JAX package's model, built once for the tests that share it."""
    return jax_construct_text_model(name, _data_cfg(task), key=jax.random.PRNGKey(1))[0]


def bridged(name, task="causal-lm"):
    """(JAX model, port model on the same weights, port loss)."""
    j_model = jax_model(name, task)
    model, loss_cls = construct_text_model(name, _data_cfg(task), generator=torch.Generator().manual_seed(0))
    flat = flat_params(j_model.params)
    assert load_flat_state(model, flat, strict=True) == len(flat) == len(list(model.parameters()))
    return j_model, model, loss_cls()


def _inputs(model, embeddings, rng):
    ids = rng.integers(0, VOCAB, (2, TOKENS))
    if not embeddings:
        return ids
    width = model.embedding.shape[1]
    return rng.standard_normal((2, TOKENS, width)).astype(np.float32)


def _labels(task, rng):
    if task == "classification":
        return rng.integers(0, 3, (2,))
    return rng.integers(0, VOCAB, (2, TOKENS))


def _compare_gradients(j_model, model, j_loss, loss, x, y):
    def objective(params):
        return j_loss(j_model.apply(params, {}, jnp.asarray(x))[0], jnp.asarray(y))

    want = flat_params(jax.jit(jax.grad(objective))(j_model.params))
    params = dict(model.named_parameters())
    value = loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    grads = torch.autograd.grad(value, tuple(params.values()), allow_unused=True, materialize_grads=True)
    by_tensor = {id(p): g for p, g in zip(params.values(), grads)}
    for key, tensor, transform in _flat_entries(model):
        expected = transform(want[key]) if transform is not None else want[key]
        got = by_tensor[id(tensor)].numpy()
        scale = max(float(np.abs(expected).max()), 1e-30)
        np.testing.assert_allclose(got, expected, rtol=0, atol=1e-4 * scale, err_msg=key)
    np.testing.assert_allclose(float(value.detach()), float(objective(j_model.params)), rtol=1e-5)


@pytest.mark.parametrize("embeddings", [False, True], ids=["ids", "embeddings"])
@pytest.mark.parametrize("name", NAMES)
def test_text_model_logits_and_gradients_match_jax(name, embeddings):
    j_model, model, loss = bridged(name)
    rng = np.random.default_rng(3)
    x = _inputs(model, embeddings, rng)
    want = np.asarray(j_model.apply(j_model.params, {}, jnp.asarray(x))[0])
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, TOKENS, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _compare_gradients(j_model, model, jax_losses.CausalLoss(), loss, x, _labels("causal-lm", rng))


@pytest.mark.parametrize("embeddings", [False, True], ids=["ids", "embeddings"])
@pytest.mark.parametrize("name", ["transformer3", "gpt2-tiny", "transformer1"])
def test_classifier_head_matches_jax(name, embeddings):
    j_model, model, loss = bridged(name, task="classification")
    assert not hasattr(model, "decoder") and model.head_param_keys == ("classifier.weight", "classifier.bias")
    rng = np.random.default_rng(4)
    x = _inputs(model, embeddings, rng)
    want = np.asarray(j_model.apply(j_model.params, {}, jnp.asarray(x))[0])
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _compare_gradients(j_model, model, jax_losses.CrossEntropyLoss(), loss, x, _labels("classification", rng))


def test_features_are_the_jax_packages_sown_features():
    j_model, model, _ = bridged("gpt2-tiny")
    ids = np.random.default_rng(5).integers(0, VOCAB, (2, TOKENS))
    _, aux = j_model.apply(j_model.params, {}, jnp.asarray(ids), capture=True)
    want = np.asarray(aux["intermediates"]["features"][0])
    captured = {}
    model(torch.from_numpy(ids), capture=captured)
    got = model(torch.from_numpy(ids), features=True).detach().numpy()
    np.testing.assert_array_equal(captured["features"].detach().numpy(), got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_twelve_layers_keep_the_jax_leaf_order():
    """At 12 layers flax sorts layer10 and layer11 before layer2: the port's ranks, and
    the TAG loss that weights each leaf by its rank, follow."""
    j_module = JaxTransformer(VOCAB, 16, 2, 32, 12, positional_embedding="learnable", norm_first=True,
                              tie_weights=True)
    params = j_module.init(jax.random.PRNGKey(0), jnp.zeros((1, TOKENS), jnp.int32))["params"]
    model = TransformerModel(VOCAB, 16, 2, 32, 12, positional_embedding="learnable", norm_first=True,
                             tie_weights=True, generator=torch.Generator().manual_seed(0))
    flat = flat_params(params)
    assert load_flat_state(model, flat, strict=True) == len(flat)
    ids = np.random.default_rng(6).integers(0, VOCAB, (1, TOKENS))
    want = np.asarray(j_module.apply({"params": params}, jnp.asarray(ids)))
    np.testing.assert_allclose(model(torch.from_numpy(ids)).detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

    jax_order = ["params/" + "/".join(k.key for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    keys = {id(tensor): key for key, tensor, _ in _flat_entries(model)}
    names = [keys[id(p)] for p in model.parameters()]
    ranks = jax_leaf_ranks(model)
    assert [name for _, name in sorted(zip(ranks, names))] == jax_order
    assert jax_order.index("params/layer10/attn_out/bias") < jax_order.index("params/layer2/attn_out/bias")

    rng = np.random.default_rng(7)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}
    targets = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in flat.items()}

    def tree(values):
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                            [jnp.asarray(values[k]) for k in jax_order])

    want = float(JaxEuclideanTag().gradient_based_loss(tree(grads), tree(targets)))
    objective = EuclideanTag()
    objective.initialize(None, model)
    transforms = {key: transform for key, _, transform in _flat_entries(model)}

    def port(values):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            transforms[n](values[n]) if transforms[n] is not None else values[n])) for n in names)

    got = float(objective.gradient_based_loss(port(grads), port(targets)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["gpt2", "bert-base-uncased"])
def test_full_width_names_build_the_jax_architectures(name, monkeypatch):
    """``gpt2`` (pre-LN, tied) and ``bert*`` (post-LN, untied) at 768 x 12, 3,072 FF, at a
    vocab of 128: the same parameter names and shapes as the JAX package's (whose init is
    only traced here, for its shapes)."""
    def shapes_only(self, key, input_example=None):
        example = input_example if input_example is not None else self.input_example
        variables = jax.eval_shape(lambda k: self.module.init(k, example, train=False), key)
        return dict(variables["params"]), {}

    monkeypatch.setattr(JaxModel, "init_state", shapes_only)
    j_model, _ = jax_construct_text_model(name, _data_cfg(), key=jax.random.PRNGKey(0))
    model, _ = construct_text_model(name, _data_cfg())
    want = {"params/" + "/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(j_model.params)[0]}
    # a dense kernel is (out, in) here, (in, out) there
    got = {key: tuple(tensor.shape[::-1]) if transform is not None else tuple(tensor.shape)
           for key, tensor, transform in _flat_entries(model)}
    assert got == want and len(want) == 3 + 12 * 12 + (name == "bert-base-uncased")
    assert model.nlayers == 12 and model.ninp == 768 and model.nhid == 3072
    assert model.tie_weights == (name == "gpt2") and model.layer0.norm_first == (name == "gpt2")


@pytest.mark.parametrize("name", ["gpt2S", "bert-sanity-check", "hf-gpt2", "hf-bert-tiny"])
def test_huggingface_architectures_are_refused_by_name(name):
    """The HuggingFace names are no longer refused: each builds the port's architecture
    (``hf_models.HFModel``, held against the JAX package's Flax models in
    tests/test_torch_hf_models.py) under the JAX package's name."""
    from breaching_tpu_torch.cases.models.hf_models import HFModel

    with torch.device("meta"):
        model, _ = construct_text_model(name, _data_cfg())
    assert isinstance(model, HFModel) and model.name == (name if name.startswith("hf-") else f"hf-{name}")


def test_classification_needs_a_transformer():
    for name in ("LSTM", "linear"):
        with pytest.raises(ValueError, match="needs a transformer"):
            construct_text_model(name, _data_cfg("classification"))


LOSS_NAMES = ["CausalLoss", "MLMLoss", "MostlyCausalLoss"]


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_text_losses_match_jax(name, soft):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((3, TOKENS, VOCAB)).astype(np.float32) * 3
    if soft:
        raw = rng.standard_normal((3, TOKENS, VOCAB)).astype(np.float32)
        labels = np.exp(raw) / np.exp(raw).sum(-1, keepdims=True)
    else:
        labels = rng.integers(0, VOCAB, (3, TOKENS))
        if name == "MLMLoss":
            labels[rng.uniform(size=labels.shape) < 0.7] = -100
    want = float(getattr(jax_losses, name)()(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(getattr(losses, name)()(torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mlm_loss_of_no_masked_position_is_zero():
    logits = torch.randn(1, TOKENS, VOCAB, generator=torch.Generator().manual_seed(0))
    assert float(losses.MLMLoss()(logits, torch.full((1, TOKENS), -100))) == 0.0
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
