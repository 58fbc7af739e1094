"""The port's ResNets against the JAX package's, on the same seeded weights carried
across by ``load_flat_state``: logits, the user's parameter gradient and the attack
gradient (cosine matching) at small sizes; and ResNet-18 at 224x224 on the repo's
trained checkpoint, loaded by both packages, for one image.

Tolerances: both sides run float32 convolutions on the CPU in other summation
orders. Logits, loss and parameter gradients use 2e-5 of the largest reference
value, as ``tests/test_torch_models.py`` does for ConvNet; the attack gradient,
through a double backward, is held against two references:
- the port's own float64 evaluation: 1e-5 of its largest entry and 1e-6 of the
  distance [measured on ResNet-20: 1.0e-6 and 4e-8];
- the JAX package's, jitted: 1e-3 of its largest entry and 1e-4 of the distance,
  looser than the 1e-4 of ``tests/test_torch_attack.py`` because XLA's jitted double
  backward on the CPU is itself 6.7e-4 and 2.1e-5 from the float64 evaluation
  (ResNet-20); its op-by-op evaluation agrees with the port to 2e-5 but takes 15-20 s
  per model. ResNet-18 at 224x224 sums up to
4,608 products per output and runs 20 layers deep: its logits and gradient use
1e-4 of the largest reference value.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.objectives import CosineSimilarity as JaxCosine
from breaching_tpu.cases.models.model_preparation import JaxModel
from breaching_tpu.cases.models.resnets import ResNet as JaxResNet, build_resnet
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.objectives import CosineSimilarity
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.cases.models.resnets import ResNet

torch.set_num_threads(1)
REPO_CHECKPOINT = "assets/checkpoints/ResNet18.npz"


def _close(got, want, rel=2e-5, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _randomize_batchnorm(model, seed):
    """Non-trivial BN state, so that eval mode uses real running statistics."""
    rng = np.random.default_rng(seed)
    flat = _flat(model.params, model.buffers)
    for key, value in flat.items():
        if key.endswith(("/scale", "/var")):
            flat[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith("/mean") or (key.endswith("/bias") and "/dense/" not in key):
            flat[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
    jax_breaching.cases.models.model_preparation.load_flat_state(model, flat, strict=True)
    return flat


def _jax_model(module, size):
    example = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.jit(lambda key: module.init(key, example))(jax.random.PRNGKey(1))
    return JaxModel(name="resnet", module=module, params=dict(variables["params"]),
                    buffers=dict(variables["batch_stats"]), input_example=example)


def _cifar_resnet20():
    """Both packages' ResNet-20 by name, on CIFAR-10 data cut to 16x16."""
    port, _ = breaching.cases.construct_model("resnet20", breaching.get_config(
        ["case=1_single_image_small", "case.data.shape=[3, 16, 16]"]).case.data)
    return _jax_model(build_resnet("resnet20", 3, 10, is_imagenet_data=False), 16), port, (16, 16)


def _module_pair(size, **kwargs):
    return (_jax_model(JaxResNet(num_classes=10, **kwargs), size),
            ResNet(num_classes=10, shape=(3, size, size), **kwargs), (size, size))


MODELS = {
    "resnet20-cifar-16": _cifar_resnet20,
    "basic-1111-imagenet-width8-32": lambda: _module_pair(32, block="basic", layers=(1, 1, 1, 1),
                                                          stem="ImageNet", width=8),
    "bottleneck-cifar-width8-16": lambda: _module_pair(16, block="bottleneck", layers=(1, 1, 1),
                                                       stem="CIFAR", width=8, strides=(1, 2, 2)),
}


def _user_gradients(jax_model, port, x, y, jit=True):
    """Logits, loss and parameter gradients of one batch on both sides, the JAX
    gradient brought to the port's layout."""
    def loss_fn(p):
        out, _ = jax_model.apply(p, jax_model.buffers, jnp.asarray(x), train=False)
        return jax_breaching.cases.models.losses.CrossEntropyLoss()(out, jnp.asarray(y)), out

    value_and_grad = jax.value_and_grad(loss_fn, has_aux=True)
    (j_loss, j_out), j_grads = (jax.jit(value_and_grad) if jit else value_and_grad)(jax_model.params)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    loss = breaching.cases.models.losses.CrossEntropyLoss()(out, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(port.parameters()))
    return (out.detach(), loss.detach(), dict(zip([n for n, _ in port.named_parameters()], grads))), \
        (np.asarray(j_out), float(j_loss), _to_port_layout(port, j_grads)), j_grads


def _to_port_layout(port, jax_params):
    """A JAX parameter tree (weights or gradients) in the port's names and layouts."""
    twin = copy.deepcopy(port)
    assert load_flat_state(twin, _flat(jax_params, {})) == len(list(twin.parameters()))
    return {k: v.detach() for k, v in twin.named_parameters()}


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_logits_gradients_and_attack_gradient_match(name):
    jax_model, port, (h, w) = MODELS[name]()
    flat = _randomize_batchnorm(jax_model, seed=2)
    assert load_flat_state(port, flat, strict=True) == len(flat)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    y = rng.integers(0, 10, 2)

    (out, loss, grads), (j_out, j_loss, want), _ = _user_gradients(jax_model, port, x, y)
    _close(out, j_out)
    _close(loss, j_loss)
    scale = max(v.abs().max().item() for v in want.values())
    assert grads.keys() == want.keys()
    for key, g in grads.items():
        _close(g, want[key], scale=scale)

    # the attack gradient: the cosine distance between the candidate's user gradient and
    # a target, differentiated by the candidate. The target is the user gradient of x
    # under other labels, the JAX package's on both sides: with x's own labels the two
    # gradients point almost the same way, and the attack gradient is then the small
    # difference of two large terms
    candidate = rng.normal(size=x.shape).astype(np.float32)
    _, (_, _, target), target_tree = _user_gradients(jax_model, port, x, (y + 3) % 10)
    j_obj = JaxCosine()
    j_obj.initialize(jax_breaching.cases.models.losses.CrossEntropyLoss(), jax_model)
    j_value, j_grad = jax.jit(jax.value_and_grad(lambda c: j_obj(
        jax_model.params, jax_model.buffers, target_tree, c, jnp.asarray(y))[0]))(jnp.asarray(candidate))
    value, got = _attack_gradient(port, target, candidate, y, torch.float32)
    want_value, want = _attack_gradient(copy.deepcopy(port).double(), target, candidate, y, torch.float64)
    assert abs(value - float(j_value)) <= 1e-4 * abs(float(j_value))
    _close(got, np.transpose(np.asarray(j_grad), (0, 3, 1, 2)), rel=1e-3)
    assert abs(value - want_value) <= 1e-6 * abs(want_value)
    _close(got, want, rel=1e-5)


def _attack_gradient(port, target, candidate, labels, dtype):
    """The port's cosine objective and its gradient by the candidate (NHWC), in ``dtype``."""
    obj = CosineSimilarity()
    obj.initialize(breaching.cases.models.losses.CrossEntropyLoss(), port)
    params = {k: v.detach().requires_grad_(True) for k, v in port.named_parameters()}
    xt = torch.from_numpy(candidate).permute(0, 3, 1, 2).to(dtype).contiguous().requires_grad_(True)
    value, _ = obj(params, dict(port.named_buffers()), tuple(target[k].to(dtype) for k in params), xt,
                   torch.from_numpy(labels))
    grad, = torch.autograd.grad(value, xt)
    return value.item(), grad.double().numpy()


def test_resnet18_layout_at_imagenet_shapes():
    cfg = breaching.get_config(["case=2_single_imagenet"])
    model, _ = breaching.cases.construct_model(cfg.case.model, cfg.case.data)
    assert sum(p.numel() for p in model.parameters()) == 11_380_173
    assert sum(b.numel() for b in model.buffers()) == 9_620
    with np.load(REPO_CHECKPOINT) as blob:
        flat = dict(blob)
    assert len(flat) == 122
    assert load_flat_state(model, flat, strict=True) == 122
    assert model.stage1_block0.downsample_conv is not None and model.stage0_block0.downsample_conv is None


def test_resnet18_checkpoint_logits_and_gradient_match_at_224():
    cfg = jax_breaching.get_config(["case=2_single_imagenet"])
    jax_model, _ = jax_breaching.cases.construct_model(cfg.case.model, cfg.case.data, pretrained=True)
    port, _ = breaching.cases.construct_model(cfg.case.model, breaching.get_config(
        ["case=2_single_imagenet"]).case.data, pretrained=True)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    y = np.array([123])
    # XLA's jitted backward of ResNet-18 at 224x224 on the CPU is about 1e-3 (relative to
    # the largest entry) from its own op-by-op backward, which the port matches to 4e-7:
    # the reference runs op by op here
    (out, loss, grads), (j_out, j_loss, want), _ = _user_gradients(jax_model, port, x, y, jit=False)
    _close(out, j_out, rel=1e-4)
    _close(loss, j_loss, rel=1e-4)
    scale = max(v.abs().max().item() for v in want.values())
    for key, g in grads.items():
        _close(g, want[key], rel=1e-4, scale=scale)


def test_pretrained_checkpoint_is_found_in_the_data_path_then_the_repo(tmp_path, caplog):
    cfg = breaching.get_config(["case=2_single_imagenet", f"case.data.path={tmp_path}"])
    with caplog.at_level(logging.INFO):
        model, _ = breaching.cases.construct_model("ResNet18", cfg.case.data, pretrained=True)
    assert "Loaded 122 pretrained tensors" in caplog.text and "assets/checkpoints/ResNet18.npz" in caplog.text
    with np.load(REPO_CHECKPOINT) as blob:
        kernel = blob["params/head/dense/kernel"]
    assert torch.equal(model.head.weight, torch.from_numpy(kernel.T.copy()))

    # a checkpoint under <data.path>/checkpoints comes first
    small = breaching.get_config(["case=1_single_image_small", "case.data.shape=[3, 16, 16]",
                                  f"case.data.path={tmp_path}"]).case.data
    (tmp_path / "checkpoints").mkdir()
    jax_cfg = jax_breaching.get_config(["case=1_single_image_small", "case.data.shape=[3, 16, 16]"])
    jax_model, _ = jax_breaching.cases.construct_model("resnet20", jax_cfg.case.data, key=jax.random.PRNGKey(4))
    np.savez(tmp_path / "checkpoints" / "resnet20.npz", **_flat(jax_model.params, jax_model.buffers))
    caplog.clear()
    with caplog.at_level(logging.INFO):
        loaded, _ = breaching.cases.construct_model("resnet20", small, pretrained=True)
    assert str(tmp_path) in caplog.text
    want = jax_model.params["stem_conv"]["conv"]["kernel"]
    assert torch.equal(loaded.stem_conv.weight, torch.from_numpy(np.transpose(np.asarray(want), (3, 2, 0, 1)).copy()))


def test_a_head_that_does_not_fit_keeps_the_random_init_with_a_warning(caplog):
    cfg = breaching.get_config(["case=2_single_imagenet", "case.data.classes=1000"])
    generator = torch.Generator().manual_seed(0)
    with caplog.at_level(logging.WARNING):
        model, _ = breaching.cases.construct_model("ResNet18", cfg.case.data, pretrained=True,
                                                   generator=generator)
    assert "does not fit this model" in caplog.text and "params/head/dense/kernel" in caplog.text
    fresh, _ = breaching.cases.construct_model("ResNet18", cfg.case.data,
                                               generator=torch.Generator().manual_seed(0))
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), name
