"""The malicious model server and the imprint readout of the port against the JAX
package's, at small sizes (ConvNet-8 and ResNet-20 at 3x16x16, 8-32 bins), the victim's
weights carried across by the bridge and the imprint blocks built by each package from
the same hyperparameters:

- every imprint block's weights equal the JAX package's (transposed), bit for bit, and
  its output agrees to 1e-5 of the largest entry, for every ``linfunc``, connection and
  CAH (the sparse blocks against the JAX package's numpy construction: its flax modules
  of them cannot be initialized, ROADMAP Queue C);
- the imprinted model's user gradient, the readout (cumulative and sparse, ``sort_by_bias``,
  both ``breach_reduction``s, with and without the padding, on a gradient with tied and
  invalid rows), the deep placement at ``position=1`` with the identity prefix (and at
  ``position=2``, whose 8x8 readout is resized to the input's 16x16 as the JAX package
  resizes it) and
  ``_normalize_throughput`` on the JAX package's probe batch, each to 1e-5 of the
  largest entry;
- ``imprint_guarantee``'s formulas; the repaired ``label_strategy: None`` (labels None,
  as in the JAX package); the options the port refuses by name (the HuggingFace text
  models under Decepticon), and the JAX package's errors for what it refuses too (the transformer server on a model without a registry, the text placement
  on an LSTM).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.analysis import imprint_guarantee as jax_guarantee
from breaching_tpu.cases.malicious import imprint as jax_imprint
import breaching_tpu_torch as breaching
from breaching_tpu_torch.analysis import imprint_guarantee
from breaching_tpu_torch.cases.malicious import imprint
from breaching_tpu_torch.cases.malicious.parameter_utils import (fetch, introspect_model, param_names,
                                                               replace_module, set_tensor)
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)
RTF = ["case=1_single_image_small", "attack=imprint", "case/server=malicious-model-rtf", "case.model=ConvNet8",
       "case.data.shape=[3, 16, 16]", "case.server.model_modification.num_bins=16", "seed=12"]
DEEP = ["case=1_single_image_small", "attack=imprint", "case/server=malicious-model-rtf", "case.model=resnet20",
        "case.data.shape=[3, 16, 16]", "case.server.model_modification.position=1",
        "case.server.model_modification.num_bins=32", "case.user.num_data_points=1", "seed=12"]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _flat(params, buffers=None):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers or {})):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
    return flat


def _as_port(model, flat):
    """A flat JAX tree (parameters, or gradients under ``params/``) in the port's names
    and layouts of ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: (transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model) if key.startswith("params/")}


def _cases(overrides):
    """The JAX package's case and the port's, the port's victim on the JAX victim's weights."""
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    victim = getattr(j_server, "original_model", j_model)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, _flat(victim.params, victim.buffers), strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    model = server.vet_model(model)
    user = breaching.cases.construct_user(model, loss, cfg.case, setup)
    return dict(cfg=cfg, setup=setup, user=user, server=server, model=model, j_cfg=j_cfg, j_setup=j_setup,
                j_user=j_user, j_server=j_server, j_model=j_model)


def _exchange(e):
    shared, payloads, true = e["server"].run_protocol(e["user"])
    j_shared, j_payloads, j_true = e["j_server"].run_protocol(e["j_user"])
    return shared, payloads, true, j_shared, j_payloads, j_true


def _readouts(e, shared, payloads, j_shared, j_payloads):
    attacker = breaching.attacks.prepare_attack(e["server"].model, e["server"].loss, e["cfg"].attack, e["setup"])
    j_attacker = jax_breaching.attacks.prepare_attack(e["j_server"].model, e["j_server"].loss, e["j_cfg"].attack,
                                                      e["j_setup"])
    rec, _ = attacker.reconstruct(payloads, shared, e["server"].secrets)
    j_rec, _ = j_attacker.reconstruct(j_payloads, j_shared, e["j_server"].secrets)
    return rec, j_rec


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------- the blocks

BLOCKS = [(imprint.ImprintBlock, jax_imprint.ImprintBlock, dict(linfunc=linfunc, mode=mode, connection=connection))
          for linfunc, mode in (("fourier", 3), ("avg", 0), ("randn", 0), ("rand", 0))
          for connection in ("linear", "cat", "softmax", "addition")] + [
    (imprint.ImprintBlock, jax_imprint.ImprintBlock, dict(linfunc="fourier", mode=32, gain=1.0)),
    (imprint.SparseImprintBlock, jax_imprint.SparseImprintBlock, dict(linfunc="fourier", mode=2)),
    (imprint.SparseImprintBlock, jax_imprint.SparseImprintBlock, dict(linfunc="randn", connection="addition")),
    (imprint.OneShotBlock, jax_imprint.OneShotBlock, dict(num_bins=2, virtual_bins=16, target_val=0.3)),
    (imprint.OneShotBlockSparse, jax_imprint.OneShotBlockSparse, dict(num_bins=4, connection="addition")),
    (imprint.CuriousAbandonHonesty, jax_imprint.CuriousAbandonHonesty, dict(connection="linear", sigma=0.5)),
    (imprint.CuriousAbandonHonesty, jax_imprint.CuriousAbandonHonesty,
     dict(connection="addition", mu=0.1, scale_factor=0.99, seed=3)),
]


# The JAX package's SparseImprintBlock and OneShotBlockSparse cannot be initialized: their
# _bins sets an attribute inside __call__, which flax refuses (SetAttributeFrozenModuleError).
# Their weights are taken from the JAX package's own numpy construction, called on the
# block's fields, and their output from the JAX block's __call__ written out in numpy.
FROZEN = (jax_imprint.SparseImprintBlock, jax_imprint.OneShotBlockSparse)


def _jax_block_reference(jax_cls, shape, kwargs, x):
    """(the JAX block's parameters by flax name, its output on NHWC ``x``)."""
    if jax_cls not in FROZEN:
        j_block = jax_cls(data_shape=shape, **kwargs)
        variables = j_block.init(jax.random.PRNGKey(0), jnp.asarray(x))
        return {k: np.asarray(v) for k, v in variables["params"].items()}, np.asarray(
            j_block.apply(variables, jnp.asarray(x)))
    fields = {f.name: f.default for f in dataclasses.fields(jax_cls) if f.name not in ("parent", "name")}
    block = types.SimpleNamespace(**dict(fields, data_shape=shape, **kwargs))
    block._bins = types.MethodType(jax_cls._bins, block)
    weights, biases = jax_cls._weights_and_biases(block)
    size = int(np.prod(shape))
    params = dict(linear0_kernel=weights.T, linear0_bias=biases)
    flat = x.reshape(x.shape[0], -1)
    acts = np.clip(flat @ weights.T + biases, 0.0, block.gain)
    if block.connection == "linear":
        params.update(linear2_kernel=np.ones((block.num_bins, size), np.float32) / np.float32(block.gain),
                      linear2_bias=np.full((size,), -float(np.mean(block._bins())), np.float32))
        out = acts @ params["linear2_kernel"] + params["linear2_bias"]
    else:
        out = flat + acts.mean(axis=1, keepdims=True)
    return params, out.reshape(x.shape)


@pytest.mark.parametrize("port_cls,jax_cls,kwargs", BLOCKS,
                         ids=[f"{p.__name__}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for p, _, kw in BLOCKS])
def test_imprint_block_weights_and_output_match_jax(port_cls, jax_cls, kwargs):
    kwargs = dict(dict(num_bins=8), **kwargs)
    shape = (8, 8, 3)  # (H, W, C)
    block = port_cls(shape, **kwargs)
    x = np.random.default_rng(0).normal(size=(2, *shape)).astype(np.float32)
    params, want = _jax_block_reference(jax_cls, shape, kwargs, x)
    layers = {"linear0": block.linear0, "linear2": getattr(block, "linear2", None)}
    assert sorted(params) == sorted(f"{name}_{kind}" for name, layer in layers.items() if layer is not None
                                    for kind in ("kernel", "bias"))
    for name, layer in layers.items():
        if layer is not None:
            np.testing.assert_array_equal(layer.weight.detach().numpy(), params[f"{name}_kernel"].T)
            np.testing.assert_array_equal(layer.bias.detach().numpy(), params[f"{name}_bias"])
    assert block.structure == jax_cls.structure
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(_nhwc(out), want)


# ---------------------------------------------------------------- the imprinted model

@pytest.fixture(scope="module")
def rtf():
    e = _cases(RTF + ["case.user.num_data_points=4"])
    e["exchange"] = _exchange(e)
    return e


def test_imprinted_model_and_user_gradient_match_jax(rtf):
    model, j_model = rtf["model"], rtf["j_model"]
    assert list(dict(model.named_parameters())) == list(rtf["exchange"][0][0]["gradients"])
    assert model.head_name == "victim.head" and rtf["server"].secrets["ImprintBlock"]["shape"] == (16, 16, 3)
    want = _as_port(model, _flat(j_model.params))
    for name, value in model.named_parameters():
        np.testing.assert_array_equal(value.detach().numpy(), want[name], err_msg=name)
    shared, _, true, j_shared, _, j_true = rtf["exchange"]
    np.testing.assert_array_equal(_nhwc(true["data"]), np.asarray(j_true["data"]))
    grads, j_grads = shared[0]["gradients"], _as_port(model, _flat(j_shared[0]["gradients"]))
    scale = max(np.abs(g).max() for g in j_grads.values())
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), j_grads[name], rtol=0, atol=1e-5 * scale, err_msg=name)


def test_readout_of_the_user_gradient_matches_jax(rtf):
    shared, payloads, true, j_shared, j_payloads, _ = rtf["exchange"]
    rec, j_rec = _readouts(rtf, shared, payloads, j_shared, j_payloads)
    assert rec["data"].shape == true["data"].shape
    _close(_nhwc(rec["data"]), j_rec["data"])


def _crafted_gradient(bins, size, rng):
    """A weight gradient (bins, size) and bias gradient (bins,) with invalid rows (bias
    gradient 0, and below 1e-12), rows that tie in both scores, and rows that tie in
    |bias| only."""
    weight = rng.normal(size=(bins, size)).astype(np.float32)
    bias = rng.uniform(0.5, 2.0, size=bins).astype(np.float32) * rng.choice([-1, 1], size=bins).astype(np.float32)
    bias[[2, 9]] = 0.0
    bias[5] = 1e-13
    weight[7], bias[7] = weight[3], bias[3]       # tied rows
    weight[12], bias[12] = weight[4], -bias[4]    # tied |bias| and |mean weight|
    bias[14] = -bias[1]                           # tied |bias| only
    return weight, bias


@pytest.mark.parametrize("structure", ["cumulative", "sparse"])
@pytest.mark.parametrize("reduction", ["weight", "bias"])
@pytest.mark.parametrize("sort_by_bias", [False, True])
@pytest.mark.parametrize("num_data_points,padding", [(4, True), (20, True), (20, False)])
def test_readout_of_a_gradient_with_tied_and_invalid_rows_matches_jax(rtf, structure, reduction, sort_by_bias,
                                                                     num_data_points, padding):
    shared, payloads, _, j_shared, j_payloads, _ = rtf["exchange"]
    rng = np.random.default_rng(3)
    weight, bias = _crafted_gradient(16, 16 * 16 * 3, rng)
    params_bias = rng.normal(size=16).astype(np.float32)
    params_bias[6] = params_bias[11]  # a tie for the stable argsort
    shared = [dict(shared[0], gradients=dict(shared[0]["gradients"]), metadata=dict(shared[0]["metadata"]))]
    shared[0]["gradients"]["block.linear0.weight"] = torch.from_numpy(weight)
    shared[0]["gradients"]["block.linear0.bias"] = torch.from_numpy(bias)
    shared[0]["metadata"]["num_data_points"] = num_data_points
    payloads = [dict(payloads[0], parameters=dict(payloads[0]["parameters"]))]
    payloads[0]["parameters"]["block.linear0.bias"] = torch.from_numpy(params_bias)
    j_grads = jax.tree_util.tree_map(lambda v: v, j_shared[0]["gradients"])
    j_grads["block"] = dict(j_grads["block"], linear0_kernel=jnp.asarray(weight.T), linear0_bias=jnp.asarray(bias))
    j_shared = [dict(j_shared[0], gradients=j_grads, metadata=dict(j_shared[0]["metadata"],
                                                                   num_data_points=num_data_points))]
    j_params = dict(j_payloads[0]["parameters"])
    j_params["block"] = dict(j_params["block"], linear0_bias=jnp.asarray(params_bias))
    j_payloads = [dict(j_payloads[0], parameters=j_params)]
    for e in (rtf["server"], rtf["j_server"]):
        e.secrets["ImprintBlock"]["structure"] = structure
    for cfg in (rtf["cfg"], rtf["j_cfg"]):
        cfg.attack.sort_by_bias, cfg.attack.breach_reduction, cfg.attack.breach_padding = \
            sort_by_bias, reduction, padding
    try:
        rec, j_rec = _readouts(rtf, shared, payloads, j_shared, j_payloads)
    finally:
        for e in (rtf["server"], rtf["j_server"]):
            e.secrets["ImprintBlock"]["structure"] = "cumulative"
    assert rec["data"].shape[0] == (num_data_points if padding else min(num_data_points, 16))
    _close(_nhwc(rec["data"]), j_rec["data"])


def test_deep_placement_with_the_identity_prefix_matches_jax():
    e = _cases(DEEP)
    model, j_model = e["model"], e["j_model"]
    want = _as_port(model, _flat(j_model.params))
    assert sorted(want) == sorted(dict(model.named_parameters()))
    for name, value in model.named_parameters():
        np.testing.assert_array_equal(value.detach().numpy(), want[name], err_msg=name)
    buffers = _flat({}, j_model.buffers)
    for key, tensor, _ in _flat_entries(model):
        if key.startswith("buffers/") and not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(tensor.numpy(), buffers[key], err_msg=key)
    assert e["server"].secrets["ImprintBlock"]["weight_name"] == "imprint_block.linear0.weight"
    shared, payloads, true, j_shared, j_payloads, _ = _exchange(e)
    j_grads = _as_port(model, _flat(j_shared[0]["gradients"]))
    scale = max(np.abs(g).max() for g in j_grads.values())
    for name, grad in shared[0]["gradients"].items():
        np.testing.assert_allclose(grad.numpy(), j_grads[name], rtol=0, atol=1e-5 * scale, err_msg=name)
    rec, j_rec = _readouts(e, shared, payloads, j_shared, j_payloads)
    _close(_nhwc(rec["data"]), j_rec["data"])
    assert float(torch.mean((rec["data"] - true["data"]) ** 2)) < 1e-4


def test_deep_placement_on_a_smaller_map_is_resized_as_jax():
    """At ``position=2`` ResNet-20's stage sees 8x8 maps of 3x16x16 images: the readout's
    rows are resized to 16x16 by ``jax.image.resize``'s cubic interpolation in both
    packages, to 1e-5 of the largest entry."""
    e = _cases([o.replace("position=1", "position=2") for o in DEEP])
    assert e["server"].secrets["ImprintBlock"]["shape"][:2] == (8, 8)
    shared, payloads, _, j_shared, j_payloads, _ = _exchange(e)
    rec, j_rec = _readouts(e, shared, payloads, j_shared, j_payloads)
    assert rec["data"].shape == (1, 3, 16, 16)
    _close(_nhwc(rec["data"]), j_rec["data"])


@pytest.mark.parametrize("model_name", ["resnet20", "ConvNet8"])
def test_normalize_throughput_matches_jax_on_its_probe_batch(model_name):
    """Two rounds on the JAX package's probe batch (``jax.random.normal`` of key 7): each
    layer's weight and bias after each round to 1e-5 of the layer's largest entry (a
    normalized bias is a difference of its old value and mean / std, so its own scale can
    be 1e-3 of the weight's)."""
    e = _cases(RTF[:3] + [f"case.model={model_name}", "case.data.shape=[3, 16, 16]", "seed=12",
                          "case.server.model_modification.num_bins=8"])
    server, j_server = e["server"], e["j_server"]
    probe = torch.from_numpy(np.array(j_server._probe_batch())).permute(0, 3, 1, 2)
    for _ in range(2):
        server._normalize_throughput(server.model, probe=probe)
        j_server._normalize_throughput(j_server.model)
        want = _as_port(server.model, _flat(j_server.model.params))
        for name, module in server.model.named_modules():
            own = [f"{name}.{k}" for k, _ in module.named_parameters(recurse=False)]
            if own:  # a layer's weight and bias together, to 1e-5 of its largest entry
                _close(np.concatenate([fetch(server.model, k).detach().numpy().ravel() for k in own]),
                       np.concatenate([want[k].ravel() for k in own]))
    zeroed = [n for n, p in server.model.named_parameters() if "downsample_conv" in n]
    assert all(float(fetch(server.model, n).detach().abs().max()) == 0.0 for n in zeroed)
    assert bool(zeroed) == (model_name == "resnet20")


def test_cah_readout_matches_jax():
    e = _cases(["case=1_single_image_small", "attack=imprint", "case/server=malicious-model-cah",
                "case.model=ConvNet8", "case.data.shape=[3, 16, 16]", "case.server.model_modification.num_bins=24",
                "case.user.num_data_points=2", "seed=9"])
    shared, payloads, true, j_shared, j_payloads, _ = _exchange(e)
    assert e["server"].secrets["ImprintBlock"]["structure"] == "sparse"
    rec, j_rec = _readouts(e, shared, payloads, j_shared, j_payloads)
    _close(_nhwc(rec["data"]), j_rec["data"])
    assert rec["data"].shape == true["data"].shape and bool(torch.isfinite(rec["data"]).all())


def test_unset_label_strategy_leaves_the_labels_none_as_jax():
    """case 2's user shares no labels and imprint.yaml sets no label strategy: the labels
    stay None in both packages (the port raised here before)."""
    overrides = ["case=2_single_imagenet", "attack=imprint", "case/server=malicious-model-rtf",
                 "case.model=ConvNet8", "case.data.shape=[3, 16, 16]", "case.server.pretrained=False",
                 "case.server.model_modification.num_bins=8", "seed=7"]
    e = _cases(overrides)
    assert e["cfg"].attack.label_strategy is None and not e["cfg"].case.user.provide_labels
    shared, payloads, _, j_shared, j_payloads, _ = _exchange(e)
    attacker = breaching.attacks.prepare_attack(e["server"].model, e["server"].loss, e["cfg"].attack, e["setup"])
    assert attacker.prepare_attack(payloads, shared)[1] is None
    rec, j_rec = _readouts(e, shared, payloads, j_shared, j_payloads)
    assert rec["labels"] is None and j_rec["labels"] is None
    _close(_nhwc(rec["data"]), j_rec["data"])


@pytest.mark.parametrize("n,k", [(1, 64), (16, 64), (64, 64), (200, 512), (3, 1), (5, 0)])
def test_imprint_guarantee_matches_jax(n, k):
    for name in ("probability_of_recovery", "expected_number_of_recovered_points",
                 "expected_number_of_breached_bins"):
        assert getattr(imprint_guarantee, name)(n, k) == getattr(jax_guarantee, name)(n, k)


def test_parameter_utils_address_parameters_by_name(rtf):
    model = rtf["model"]
    shapes = introspect_model(model, (3, 16, 16))
    assert shapes["block"] == (1, 3, 16, 16) and shapes["block.linear0"] == (1, 16)
    assert shapes["__output__"] == (1, 10)
    assert fetch(model, "block.linear0.bias") is model.block.linear0.bias
    assert param_names(model, lambda name, p: name.startswith("block.")) == [
        "block.linear0.weight", "block.linear0.bias", "block.linear2.weight", "block.linear2.bias"]
    copy = imprint.ImprintBlock((16, 16, 3), 16, gain=1.0, linfunc="fourier", mode=32)
    set_tensor(copy, "linear0.bias", torch.zeros(16))
    assert float(copy.linear0.bias.abs().max()) == 0.0
    original = model.block
    try:
        replace_module(model, "block", copy)
        assert model.block is copy and fetch(model, "block.linear0.bias") is copy.linear0.bias
    finally:
        replace_module(model, "block", original)


TEXT = ["case=10_causal_lang_training", "case/data=random-tokens", "case.data.vocab_size=128", "case.data.shape=[8]",
        "case.server.has_external_data=False", "case.model=LSTM"]
REGISTRY_ERROR = "Transformer rewiring needs a populated architecture registry"


def _jax_raises_too(overrides, error, message):
    """The JAX package's case raises the same error on the same configuration."""
    cfg = jax_breaching.get_config(overrides)
    with pytest.raises(error, match=message):
        jax_breaching.cases.construct_case(cfg.case, jax_breaching.utils.system_startup(cfg=cfg))


@pytest.mark.parametrize("override,error,message", [
    # ported: the transformer server on a model without a registry raises the JAX package's error
    pytest.param("case/server=malicious-transformer", ValueError, REGISTRY_ERROR,
                 id="case/server=malicious-transformer-malicious_transformer"),
    # ported: Decepticon on a text model without attention (LSTM) raises it too
    pytest.param("attack=decepticon", ValueError, REGISTRY_ERROR, id="attack=decepticon-decepticon-readout"),
])
def test_unported_malicious_options_are_refused(override, error, message):
    if override == "attack=decepticon":
        overrides = TEXT + ["attack=decepticon", "case/server=malicious-transformer"]
    else:
        overrides = RTF[:2] + ["case/server=malicious-model-rtf", "case.model=resnet20",
                               "case.data.shape=[3, 16, 16]"] + override.split()
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    with pytest.raises(error, match=message):
        user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
        breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    if error is ValueError:
        _jax_raises_too(overrides, error, message)


def test_text_placement_is_refused():
    """Ported: the text placement takes the transformer family only, and on an LSTM raises
    the JAX package's ValueError of ``_vet_text_model``. The JAX package itself stops
    before it, at its block's shape: the LSTM's aux has no ``ninp`` (a KeyError; ROADMAP
    Queue C)."""
    overrides = TEXT + ["attack=imprint", "case/server=malicious-model-rtf"]
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="Text imprint placement is implemented for the flax TransformerModel family"):
        breaching.cases.construct_case(cfg.case, setup)
    _jax_raises_too(overrides, KeyError, "ninp")


@pytest.mark.parametrize("model", ["gpt2S", "bert-sanity-check", "hf-gpt2"])
def test_huggingface_models_under_decepticon_stay_refused(model):
    """No longer refused: the HuggingFace architectures are ported (tests/test_torch_hf_*.py),
    and the transformer server rewires each at full width through its registry, an imprint
    layer in every one of its 12 blocks (calibrated on batches of one sentence)."""
    cfg = breaching.get_config(TEXT[:-1] + ["attack=decepticon", "case/server=malicious-transformer",
                                            f"case.model={model}", "case.data.batch_size=1"])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    _, server, built, _ = breaching.cases.construct_case(cfg.case, setup)
    secrets = server.secrets["ImprintBlock"]
    assert built.name == (model if model.startswith("hf-") else f"hf-{model}")
    assert secrets["weight_paths"] == built.registry["ff_first"] and len(secrets["weight_paths"]) == 12
    assert len(secrets["bins"]) == 12 * 3072
