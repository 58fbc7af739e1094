"""The port's ConvNet, BatchNorm and loss against the JAX package's, through the
weight bridge ``ConvNet.from_jax_state``: logits, loss, parameter gradients and
train-mode running statistics on the same weights and inputs.

Tolerances: both sides run float32 convolutions on the CPU, XLA's and oneDNN's,
which sum the 3x3xC products in different orders; the values agree to a few
float32 roundings of the largest magnitude involved, so every comparison uses
2e-5 of the largest reference value (about 170 roundings of 2^-23).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.models.losses import CrossEntropyLoss as JaxCrossEntropyLoss
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.losses import CrossEntropyLoss
from breaching_tpu_torch.cases.models.vision_nets import ConvNet

torch.set_num_threads(1)
WIDTH = 8


def _close(got, want, rel=2e-5, scale=None):
    """|got - want| <= rel * scale, scale defaulting to the largest |want|."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _jax_model(seed=0):
    cfg = jax_breaching.get_config(["case=1_single_image_small"])
    model, _ = jax_breaching.cases.construct_model(f"ConvNet{WIDTH}", cfg.case.data,
                                                   key=jax.random.PRNGKey(seed))
    # non-trivial BN state, so that eval mode uses real running statistics
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, model.params)
    buffers = jax.tree_util.tree_map(np.asarray, model.buffers)
    for i in range(8):
        c = params[f"bn{i}"]["scale"].shape[0]
        params[f"bn{i}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params[f"bn{i}"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        buffers[f"bn{i}"]["mean"] = rng.normal(0, 0.2, c).astype(np.float32)
        buffers[f"bn{i}"]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    model.params = jax.tree_util.tree_map(jnp.asarray, params)
    model.buffers = jax.tree_util.tree_map(jnp.asarray, buffers)
    return model, params, buffers


def _port_layout(params_like, buffers):
    """Bring a JAX parameter tree (weights or gradients) into the port's names and layouts."""
    net = ConvNet(WIDTH).from_jax_state(jax.tree_util.tree_map(np.array, params_like),
                                        jax.tree_util.tree_map(np.array, buffers))
    return {k: v.detach() for k, v in net.named_parameters()}


def _inputs(batch=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, batch)
    return x, y


def test_parameter_count_and_layout_at_full_width():
    net = ConvNet(64)
    assert sum(p.numel() for p in net.parameters()) == 2_904_970
    assert len(list(net.parameters())) == 34
    assert sum(b.numel() for b in net.buffers()) == 3_208


def test_bridge_rejects_a_wrong_shape():
    _, params, buffers = _jax_model()
    params["head"]["dense"]["kernel"] = params["head"]["dense"]["kernel"][:-1]
    with pytest.raises(ValueError):
        ConvNet(WIDTH).from_jax_state(params, buffers)


@pytest.mark.parametrize("train", [False, True])
def test_logits_loss_and_gradients_match(train):
    jax_model, params, buffers = _jax_model()
    net = ConvNet(WIDTH).from_jax_state(params, buffers)
    x, y = _inputs()

    def jax_loss(p):
        out, aux = jax_model.apply(p, jax_model.buffers, jnp.asarray(x), train=train)
        return JaxCrossEntropyLoss()(out, jnp.asarray(y)), (out, aux)

    (j_loss, (j_out, j_aux)), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(jax_model.params)

    out = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), train=train)
    loss = CrossEntropyLoss()(out, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(net.parameters()))

    _close(out.detach(), j_out)
    _close(loss.detach(), j_loss)
    want = _port_layout(j_grads, buffers)
    # relative to the largest gradient entry of the whole model: in train mode the
    # conv biases before BatchNorm have a gradient of exactly 0, which both sides
    # compute as rounding noise
    scale = max(v.abs().max().item() for v in want.values())
    for (name, _), g in zip(net.named_parameters(), grads):
        _close(g, want[name], scale=scale)
    if train:  # cumulative running statistics: after one batch, that batch's statistics
        for i in range(8):
            bn = getattr(net, f"bn{i}")
            _close(bn.running_mean, j_aux["batch_stats"][f"bn{i}"]["mean"])
            _close(bn.running_var, j_aux["batch_stats"][f"bn{i}"]["var"])
            assert float(bn.num_batches_tracked) == float(j_aux["batch_stats"][f"bn{i}"]["num_batches_tracked"])


def test_soft_label_loss_matches():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 10)).astype(np.float32)
    soft = rng.dirichlet(np.ones(10), 4).astype(np.float32)
    _close(CrossEntropyLoss()(torch.from_numpy(logits), torch.from_numpy(soft)),
           JaxCrossEntropyLoss()(jnp.asarray(logits), jnp.asarray(soft)))


def test_pretrained_checkpoint_loads_through_the_bridge(tmp_path):
    _, params, buffers = _jax_model(seed=4)
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    (tmp_path / "checkpoints").mkdir()
    np.savez(tmp_path / "checkpoints" / f"ConvNet{WIDTH}.npz", **flat)
    cfg = breaching.get_config(["case=1_single_image_small", f"case.data.path={tmp_path}"])
    net, _ = breaching.cases.construct_model(f"ConvNet{WIDTH}", cfg.case.data, pretrained=True)
    want = ConvNet(WIDTH).from_jax_state(params, buffers)
    for (name, a), (_, b) in zip(net.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), name
