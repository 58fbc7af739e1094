"""The models of slice 5's presets against the JAX package's: ResNet-50
(``Bottleneck``, case 5 of ``see_through_gradients``) on the repo's checkpoint
``assets/checkpoints/ResNet50.npz``, loaded by both packages' ``construct_model``
(``pretrained=True``, the port through ``_maybe_load_pretrained``), at 32x32; and the
wide ``ResNet32-10`` (case 6 of ``inverting_large_batch_cifar``: CIFAR stem, three
stages of five basic blocks, width 160) on the JAX package's seeded weights, moved
across by ``load_flat_state``, at CIFAR-100's 32x32. Each: logits, task loss and the
user's parameter gradient for a batch of two images, BatchNorm in eval mode.

Tolerances (float32 on both sides, convolutions summed in other orders; the JAX side
runs op by op, as tests/test_torch_resnets.py runs its 224x224 reference): 1e-4 of
the largest reference value against the JAX package, as ResNet-18 at 224x224. Its
float32 gradient of ResNet32-10 on the CPU is itself 5.6e-5 of the largest entry from
the float64 evaluation (the port's: 4.5e-8), which the 2e-5 of slice 2's ResNets does
not cover. So each model is also held to the port's own float64 evaluation, to 1e-6
of the largest entry.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

torch.set_num_threads(1)
RESNET50 = "assets/checkpoints/ResNet50.npz"


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _models(overrides, pretrained):
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_model, j_loss = jax_breaching.cases.construct_model(j_cfg.case.model, j_cfg.case.data, pretrained=pretrained)
    port, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, pretrained=pretrained)
    return dict(j_model=j_model, j_loss=j_loss, port=port, loss=loss, data=cfg.case.data)


def _forward_and_gradient(m, rel, seed):
    j_model, j_loss, port, loss = m["j_model"], m["j_loss"], m["port"], m["loss"]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, int(port.head.weight.shape[0]), 2)

    def loss_fn(p):
        out, _ = j_model.apply(p, j_model.buffers, jnp.asarray(x), train=False)
        return j_loss(out, jnp.asarray(y)), out

    (j_value, j_out), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(j_model.params)
    out = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    value = loss(out, torch.from_numpy(y))
    grads = dict(zip([n for n, _ in port.named_parameters()], torch.autograd.grad(value, list(port.parameters()))))
    want_out = np.asarray(j_out)
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0, atol=rel * np.abs(want_out).max())
    assert abs(value.item() - float(j_value)) <= rel * abs(float(j_value))
    twin = breaching.cases.construct_model(port.name, m["data"])[0]
    assert load_flat_state(twin, _flat(j_grads, {})) == len(list(twin.parameters()))
    exact = copy.deepcopy(port).double()
    exact_grads = torch.autograd.grad(loss(exact(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()).double()),
                                           torch.from_numpy(y)), list(exact.parameters()))
    for reference, tol in ((dict(twin.named_parameters()), rel), (dict(zip(grads, exact_grads)), 1e-6)):
        scale = max(v.abs().max().item() for v in reference.values())
        assert grads.keys() == reference.keys()
        for key, g in grads.items():
            np.testing.assert_allclose(g.numpy(), reference[key].detach().double().numpy(), rtol=0,
                                       atol=tol * scale, err_msg=key)


def test_resnet50_checkpoint_loads_and_matches_jax_at_32(caplog):
    overrides = ["case=5_small_batch_imagenet", "case.data.shape=[3, 32, 32]"]
    with caplog.at_level(logging.INFO):
        m = _models(overrides, pretrained=True)
    port = m["port"]
    assert port.name == "ResNet50" and sum(p.numel() for p in port.parameters()) == 24_321_485
    assert any("Loaded 320 pretrained tensors for ResNet50" in r.getMessage() for r in caplog.records)
    with np.load(RESNET50) as blob:
        head = blob["params/head/dense/kernel"]
        assert torch.equal(port.head.weight.detach(), torch.from_numpy(head.T.copy()))
        assert torch.equal(port.stage3_block2.bn3.running_var, torch.from_numpy(blob["buffers/stage3_block2/bn3/var"]))
    _forward_and_gradient(m, 1e-4, seed=5)


def test_wide_resnet32_10_matches_jax_on_the_seeds_weights():
    overrides = ["case=6_large_batch_cifar"]
    m = _models(overrides, pretrained=False)
    port, flat = m["port"], _flat(m["j_model"].params, m["j_model"].buffers)
    assert port.stem == "CIFAR" and port.stem_conv.weight.shape[0] == 160 and len(port.blocks) == 15
    assert load_flat_state(port, flat, strict=True) == len(flat)
    _forward_and_gradient(m, 1e-4, seed=6)
