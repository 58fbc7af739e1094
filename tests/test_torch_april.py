"""APRIL (``AprilAttacker``) and the ViT's patch tiling against the JAX package's, and the
cubic resize of a deep imprint placement's readout.

- APRIL on ``vit_small_april`` at 3x32x32 with 20 classes, one image and its label, seed
  21 (the setting of the JAX package's ``test_april_vit_inversion``): both packages build
  the case, the port's ViT takes the JAX package's weights through the bridge, its user's
  gradient is held to the JAX user's (1e-5 of the largest entry), and both attacks invert
  the JAX user's gradient. The images agree to 1e-4 of the largest entry (float64 solves
  on the same float32 inputs on both sides), and each package's report puts the PSNR
  above 14 dB, the JAX test's bar.
- ``april_retile`` bit for bit against ``vit_april_retile`` (channels first), and
  ``april_refs``' patch kernel against the JAX package's reshaped flax kernel.
- ``cubic_resize`` against ``jax.image.resize(..., "cubic")``, up (7x7 and 56x56 to
  224x224, 5x9 to 16x16) and down (32x32 to 12x12), to 2e-6 of the largest entry (both
  float32; the weights are the same formula, the contraction orders differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threadpoolctl import threadpool_limits

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu.cases.models.vit import vit_april_refs, vit_april_retile
from breaching_tpu_torch.attacks.analytic_attack import cubic_resize
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's least squares on one BLAS thread: the test workers share the CPU's cores."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield

APRIL = ["case=2_single_imagenet", "attack=april_analytic", "case/data=ImageNet", "case.model=vit_small_april",
         "case.data.shape=[3, 32, 32]", "case.data.classes=20", "case.user.num_data_points=1",
         "case.user.provide_labels=True", "seed=21"]


def _flat(tree, prefix="params/"):
    return {prefix + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_port(model, flat):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: torch.from_numpy(np.ascontiguousarray(transform(flat[key]) if transform
                                                                      else flat[key]))
            for key, tensor, transform in _flat_entries(model) if key.startswith("params/")}


def test_april_on_the_same_gradient_matches_jax():
    j_cfg, cfg = jax_breaching.get_config(APRIL), breaching.get_config(APRIL)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, j_cfg.attack, j_setup)
    j_shared, j_payloads, j_true = j_server.run_protocol(j_user)
    j_rec, _ = j_attacker.reconstruct(j_payloads, j_shared, j_server.secrets)
    j_metrics = jax_breaching.analysis.report(j_rec, j_true, j_payloads, j_server.model, cfg_case=j_cfg.case,
                                              setup=j_setup)

    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, _flat(j_model.params), strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    user = breaching.cases.construct_user(server.vet_model(model), loss, cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, true = server.run_protocol(user)
    np.testing.assert_array_equal(true["data"].numpy(), np.transpose(np.asarray(j_true["data"]), (0, 3, 1, 2)))
    j_grads = _as_port(model, _flat(j_shared[0]["gradients"]))
    scale = max(g.abs().max().item() for g in j_grads.values())
    for name, grad in shared[0]["gradients"].items():
        np.testing.assert_allclose(grad.numpy(), j_grads[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)

    shared[0]["gradients"] = j_grads
    rec, _ = attacker.reconstruct(payloads, shared, server.secrets)
    want = np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))
    assert rec["data"].shape == (1, 3, 32, 32)
    np.testing.assert_allclose(rec["data"].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    metrics = breaching.analysis.report(rec, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
    assert metrics["psnr"] > 14 and j_metrics["psnr"] > 14, (metrics["psnr"], j_metrics["psnr"])
    assert abs(metrics["psnr"] - j_metrics["psnr"]) < 1e-3


def test_retile_and_refs_match_jax():
    cfg = breaching.get_config(APRIL)
    model, _ = breaching.cases.construct_model("vit_small_april", cfg.case.data,
                                               generator=torch.Generator().manual_seed(3))
    patches = np.random.default_rng(4).normal(size=(16 * 16 * 3, 4)).astype(np.float32)
    want = np.transpose(np.asarray(vit_april_retile(jnp.asarray(patches), 16)), (2, 0, 1))
    np.testing.assert_array_equal(model.april_retile(patches), want)
    params = dict(model.named_parameters())
    flat = {key.split("/", 1)[1]: tensor.detach().numpy() for key, tensor, _ in _flat_entries(model)}
    tree = dict(block0=dict(attn=dict(qkv=dict(kernel=flat["block0/attn/qkv/kernel"].T))),
                pos_embed=flat["pos_embed"],
                patch_embed=dict(kernel=np.transpose(flat["patch_embed/kernel"], (2, 3, 1, 0)),
                                 bias=flat["patch_embed/bias"]))
    for key, value in vit_april_refs(tree).items():
        np.testing.assert_array_equal(model.april_refs(params)[key].detach().numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize("shape,size", [((2, 7, 7, 3), (224, 224)), ((1, 56, 56, 64), (224, 224)),
                                        ((2, 5, 9, 3), (16, 16)), ((1, 32, 32, 3), (12, 12))])
def test_cubic_resize_matches_jax(shape, size):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]), "cubic"))
    got = cubic_resize(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()), size)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=0, atol=2e-6 * np.abs(want).max())
