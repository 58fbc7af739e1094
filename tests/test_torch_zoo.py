"""The port's model zoo against the JAX package's, model by model: every vision name of
the JAX ``test_forward_shapes`` list that slice 11 adds (the small nets, CNN6, the
GroupNorm ResNet, DenseNet-121, VGG11, NFNet-F0) and the APRIL ViT, plus the ImageNet
variants of the GroupNorm ResNet and VGG and a WSL name. Each is built by both packages'
``construct_model``, the JAX package's seeded weights are moved across by the weight
bridge (``load_flat_state``, strict, every JAX leaf used), and a batch from numpy goes
through both: the logits to 1e-5 of their largest entry and the parameter gradient of
the task loss to 1e-4 of its largest entry (float32 on both sides, convolutions and
sums in other orders), BatchNorm in eval mode.

Sizes: 2x3x32x32 and 10 classes, but ``convnet_beyond`` at 3x16x16 (its dense layer is
as wide as the flattened features: 16,384 squared at 32x32, over a gigabyte on each
side), NFNet-F0 with one image (71M parameters, as the JAX ``test_nfnet_f0_structure``
takes it) and the ViT with 20 classes (the setting of the JAX ``test_april_vit_inversion``).
The JAX models are initialized and differentiated under ``jax.jit`` (the same weights and
gradients as op by op; DenseNet-121's flax init alone takes 40 s op by op on one CPU core).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu.cases.models.model_preparation import JaxModel
from breaching_tpu.config.loader import ConfigNode as JaxConfigNode
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, jax_leaf_ranks, load_flat_state
from breaching_tpu_torch.config.loader import ConfigNode

torch.set_num_threads(1)

CIFAR, IMAGENET = "CIFAR10", "ImageNet"
MODELS = [  # (name, dataset name, shape, classes, batch)
    ("ConvNetSmall", CIFAR, (3, 32, 32), 10, 2),
    ("ConvNetSmall16", CIFAR, (3, 32, 32), 10, 2),
    ("lenet_zhu", CIFAR, (3, 32, 32), 10, 2),
    ("MLP", CIFAR, (3, 32, 32), 10, 2),
    ("cnn6", CIFAR, (3, 32, 32), 10, 2),
    ("convnet_beyond", CIFAR, (3, 16, 16), 10, 2),
    ("convnet-trivial", CIFAR, (3, 32, 32), 10, 2),
    ("resnetgn20", CIFAR, (3, 32, 32), 10, 2),
    ("resnetgn18", IMAGENET, (3, 32, 32), 10, 2),
    ("densenet121", CIFAR, (3, 32, 32), 10, 2),
    ("VGG11", CIFAR, (3, 32, 32), 10, 2),
    ("VGG11", IMAGENET, (3, 32, 32), 10, 2),
    ("nfnet_f0", CIFAR, (3, 32, 32), 10, 1),
    ("vit_small_april", CIFAR, (3, 32, 32), 20, 2),
    ("resnet50_swsl", CIFAR, (3, 32, 32), 10, 2),
]


@pytest.fixture(autouse=True)
def _jitted_init(monkeypatch):
    """``JaxModel.init_state`` with the flax init under ``jax.jit``."""
    def init_state(self, key, input_example=None):
        example = input_example if input_example is not None else self.input_example
        variables = jax.jit(functools.partial(self.module.init, train=False))(key, example)
        return dict(variables.get("params", {})), dict(variables.get("batch_stats", {}))

    monkeypatch.setattr(JaxModel, "init_state", init_state)


def _data(cls, name, shape, classes):
    return cls(name=name, modality="vision", task="classification", classes=classes, shape=list(shape),
               normalize=True, mean=[0.5] * 3, std=[0.25] * 3, path="~/nonexistent", size=50_000,
               examples_from_split="validation", partition="balanced", default_clients=10, batch_size=32,
               caching=False)


def _flat(params, buffers=None):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers or {})):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _as_port(model, flat):
    """A flat JAX parameter tree (weights or gradients) by the port's parameter names."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: (transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model) if key.startswith("params/")}


def _pair(name, dataset, shape, classes):
    j_model, j_loss = jax_breaching.cases.construct_model(name, _data(JaxConfigNode, dataset, shape, classes),
                                                          key=jax.random.PRNGKey(0))
    port, loss = breaching.cases.construct_model(name, _data(ConfigNode, dataset, shape, classes),
                                                 generator=torch.Generator().manual_seed(0))
    return j_model, j_loss, port, loss


@pytest.mark.parametrize("name,dataset,shape,classes,batch", MODELS,
                         ids=[f"{m[0]}-{m[1]}" for m in MODELS])
def test_model_matches_jax_through_the_bridge(name, dataset, shape, classes, batch):
    j_model, j_loss, port, loss = _pair(name, dataset, shape, classes)
    flat = _flat(j_model.params, j_model.buffers)
    assert load_flat_state(port, flat, strict=True) == len(flat)
    assert sum(p.numel() for p in port.parameters()) == sum(v.size for v in jax.tree_util.tree_leaves(j_model.params))
    assert any(True for _ in port.buffers()) == j_model.has_batchnorm
    # the parameters in the JAX pytree's leaf order, as the attack's gradient lists them
    assert sorted(jax_leaf_ranks(port)) == list(range(len(list(port.parameters()))))

    rng = np.random.default_rng(11)
    x = rng.normal(size=(batch, *shape[1:], shape[0])).astype(np.float32)
    y = rng.integers(0, classes, batch)

    def loss_fn(p):
        out, _ = j_model.apply(p, j_model.buffers, jnp.asarray(x), train=False)
        return j_loss(out, jnp.asarray(y)), out

    (j_value, j_out), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(j_model.params)
    out = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    value = loss(out, torch.from_numpy(y))
    grads = torch.autograd.grad(value, list(port.parameters()))
    want_out = np.asarray(j_out)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0, atol=1e-5 * np.abs(want_out).max())
    assert abs(value.item() - float(j_value)) <= 1e-5 * abs(float(j_value))
    want = _as_port(port, _flat(j_grads))
    scale = max(np.abs(g).max() for g in want.values())
    assert scale > 0
    for (key, _), g in zip(port.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0, atol=1e-4 * scale, err_msg=key)


def test_features_are_the_jax_models_sown_features():
    """``features=True`` gives what the JAX model sows as its features: the ViT's normed
    class token, CNN6's flattened map in height-width-channel order."""
    for name, classes in (("vit_small_april", 20), ("cnn6", 10)):
        j_model, _, port, _ = _pair(name, CIFAR, (3, 32, 32), classes)
        load_flat_state(port, _flat(j_model.params), strict=True)
        x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
        _, aux = j_model.apply(j_model.params, {}, jnp.asarray(x), capture=True)
        want = np.asarray(aux["intermediates"]["features"][0])
        got = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()), features=True)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_group_counts_and_recursion_plan():
    """The GroupNorm ResNet's groups are 4, capped at the channel count, as the JAX
    package's ``_make_norm`` and flax's GroupNorm take them; ``cnn6`` carries R-GAP's
    plan, the ViTs APRIL's accessors."""
    from breaching_tpu_torch.cases.models.layers import GroupNorm

    def port(name):
        return breaching.cases.construct_model(name, _data(ConfigNode, CIFAR, (3, 32, 32), 10))[0]

    resnet = port("resnetgn20")
    groups = {m.num_groups for m in resnet.modules() if isinstance(m, GroupNorm)}
    assert groups == {4} and resnet.stem_norm.eps == 1e-6
    assert [(layer["name"], layer["stride"], layer["padding"]) for layer in port("cnn6").rgap_layers] == [
        ("conv0", 2, 2), ("conv1", 2, 1), ("conv2", 1, 1), ("conv3", 1, 1), ("conv4", 2, 1), ("conv5", 1, 1)]
    vit = port("vit_base_april")
    refs = vit.april_refs(dict(vit.named_parameters()))
    assert refs["qkv_kernel"].shape == (768, 2304) and refs["patch_kernel"].shape == (768, 768)
    assert not hasattr(vit.block0, "norm1") and hasattr(vit.block1, "norm1")


def test_nfnet_imagenet_stem_takes_the_jax_packages_sizes():
    """NFNet's ImageNet stem leaves a 53x53 map at 224, where the first downsampling
    block's average-pool shortcut (26x26) and its strided 3x3 (27x27) disagree: the JAX
    package's NFNet fails there, and so does the port's. At 236 (a 58x58 map) both run;
    the port's logits have the expected shape."""
    import jax.numpy as jnp
    from breaching_tpu.cases.models.nfnets import NFNet as JaxNFNet

    from breaching_tpu_torch.cases.models.nfnets import NFNet

    jax_model = JaxNFNet(num_classes=10, stem="ImageNet")
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda k: jax_model.init(k, jnp.ones((1, 224, 224, 3))), jax.random.PRNGKey(0))
    jax.eval_shape(lambda k: jax_model.init(k, jnp.ones((1, 236, 236, 3))), jax.random.PRNGKey(0))
    port = NFNet(num_classes=10, stem="ImageNet", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="must match the size"):
            port(torch.zeros(1, 3, 224, 224))
        assert port(torch.zeros(1, 3, 236, 236)).shape == (1, 10)
