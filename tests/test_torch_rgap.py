"""R-GAP (``attacks/recursive_attack.py``) against the JAX package's, on ``cnn6`` at
3x16x16 with one image and its label, seed 77: the setting of the JAX package's
``test_rgap_cnn6_recovers_input``. (At the preset's 3x32x32 the last layer's system is
76,928 x 1,600 in float64, about a gigabyte in each package.) Both packages build the case
from the same config; the port's model takes the JAX package's weights through the
bridge, its user's gradient is held to the JAX user's (1e-5 of the largest entry), and
both attacks then invert the JAX user's gradient: the reconstructions agree to 1e-4 of
the largest entry, and each recovers the input to a PSNR above 20 dB, the JAX test's bar.
``inverse_udldu`` (Adam on a scalar) against the JAX package's over 300 steps, to 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from threadpoolctl import threadpool_limits

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu.attacks import recursive_attack as jax_recursive
from breaching_tpu_torch.attacks import recursive_attack
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's least squares on one BLAS thread: the test workers share the CPU's cores."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield

RGAP = ["case=1_single_image_small", "attack=rgap", "case.model=cnn6", "case.data.shape=[3, 16, 16]",
        "case.user.provide_labels=True", "case.user.num_data_points=1", "seed=77"]


def _flat(tree, prefix="params/"):
    return {prefix + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_port(model, flat):
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: torch.from_numpy(np.ascontiguousarray(transform(flat[key]) if transform
                                                                      else flat[key]))
            for key, tensor, transform in _flat_entries(model) if key.startswith("params/")}


def _psnr(rec, true, mean, std):
    dm, ds = np.asarray(mean).reshape(1, -1, 1, 1), np.asarray(std).reshape(1, -1, 1, 1)
    mse = np.mean((np.clip(rec * ds + dm, 0, 1) - np.clip(true * ds + dm, 0, 1)) ** 2)
    return 10 * np.log10(1 / mse)


def test_rgap_on_the_same_gradient_matches_jax():
    j_cfg, cfg = jax_breaching.get_config(RGAP), breaching.get_config(RGAP)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, j_cfg.attack, j_setup)
    j_shared, j_payloads, j_true = j_server.run_protocol(j_user)

    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    load_flat_state(model, _flat(j_model.params), strict=True)
    server = breaching.cases.construct_server(model, loss, cfg.case, setup)
    user = breaching.cases.construct_user(server.vet_model(model), loss, cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, true = server.run_protocol(user)
    truth = np.transpose(np.asarray(j_true["data"]), (0, 3, 1, 2))
    np.testing.assert_array_equal(true["data"].numpy(), truth)

    j_grads = _as_port(model, _flat(j_shared[0]["gradients"]))
    scale = max(g.abs().max().item() for g in j_grads.values())
    for name, grad in shared[0]["gradients"].items():
        np.testing.assert_allclose(grad.numpy(), j_grads[name].numpy(), rtol=0, atol=1e-5 * scale, err_msg=name)

    shared[0]["gradients"] = j_grads
    rec, _ = attacker.reconstruct(payloads, shared, server.secrets)
    j_rec, _ = j_attacker.reconstruct(j_payloads, j_shared, j_server.secrets)
    want = np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))
    assert rec["data"].shape == (1, 3, 16, 16) and rec["data"].dtype == torch.float32
    np.testing.assert_allclose(rec["data"].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert rec["labels"].tolist() == np.asarray(j_rec["labels"]).tolist() == true["labels"].tolist()
    mean, std = cfg.case.data.mean, cfg.case.data.std
    assert _psnr(rec["data"].numpy(), truth, mean, std) > 20
    assert _psnr(want, truth, mean, std) > 20


def test_leakyrelu_helpers_and_inverse_udldu_match_jax():
    x = np.random.default_rng(0).normal(size=64)
    # the JAX package's come back in float32
    np.testing.assert_allclose(recursive_attack.derive_leakyrelu(x), np.asarray(jax_recursive.derive_leakyrelu(x)),
                               rtol=1e-6)
    np.testing.assert_allclose(recursive_attack.inverse_leakyrelu(x), np.asarray(jax_recursive.inverse_leakyrelu(x)),
                               rtol=1e-6)
    for target in (-0.2, 0.1):
        got = float(recursive_attack.inverse_udldu(target, steps=300))
        want = float(jax_recursive.inverse_udldu(target, steps=300))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (target, got, want)
