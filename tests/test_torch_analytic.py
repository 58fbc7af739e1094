"""The analytic sanity check of the port against the JAX package's: the ``linear`` model
(3x16x16, 10 classes) and ``none`` on the same weights, the FC inversion
(``invert_fc_layer``) on a gradient with invalid rows, and ``AnalyticAttacker`` through
case 0 with one image and with several labelled images, each to 1e-5 of the largest
entry; and the sanity check through ``main_process``, exact to MSE < 1e-6 as in
``tests/test_analytic_attacks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.analytic_attack import invert_fc_layer as jax_invert_fc_layer
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.analytic_attack import invert_fc_layer
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
SANITY = ["case=0_sanity_check", "attack=analytic", "case.data.shape=[3, 16, 16]", "case.data.classes=10",
          "case/data=CIFAR10", "case.model=linear", "seed=42"]


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _flat(params):
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _cases(overrides):
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    load_flat_state(model, _flat(j_model.params), strict=True)
    return dict(cfg=cfg, setup=setup, user=user, server=server, model=model, j_cfg=j_cfg, j_setup=j_setup,
                j_user=j_user, j_server=j_server, j_model=j_model)


@pytest.mark.parametrize("name", ["linear", "none"])
def test_linear_and_none_models_match_jax(name):
    cfg = breaching.get_config(SANITY + [f"case.model={name}"])
    model, _ = breaching.cases.construct_model(cfg.case.model, cfg.case.data)
    j_model, _ = jax_breaching.cases.construct_model(jax_breaching.get_config(SANITY + [f"case.model={name}"]).case.model,
                                                     cfg.case.data, key=jax.random.PRNGKey(3))
    load_flat_state(model, _flat(j_model.params), strict=True)
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32)
    inputs = torch.from_numpy(x).permute(0, 3, 1, 2)
    _close(model(inputs).detach(), j_model.apply(j_model.params, j_model.buffers, jnp.asarray(x))[0])
    _close(model(inputs, features=True).detach(), x.reshape(3, -1))
    assert sum(p.numel() for p in model.parameters()) == (16 * 16 * 3 * 10 + 10 if name == "linear" else 0)


@pytest.mark.parametrize("positions", [None, [0], [1, 4, 7]])
def test_invert_fc_layer_matches_jax(positions):
    rng = np.random.default_rng(1)
    weight = rng.normal(size=(10, 48)).astype(np.float32)
    bias = rng.normal(size=10).astype(np.float32)
    bias[[2, 5]] = [0.0, 1e-13]  # invalid rows
    got = invert_fc_layer(torch.from_numpy(weight), torch.from_numpy(bias), positions)
    _close(got, jax_invert_fc_layer(jnp.asarray(weight), jnp.asarray(bias), positions))


@pytest.mark.parametrize("num_data_points", [1, 3])
def test_analytic_attack_on_the_linear_model_matches_jax(num_data_points):
    e = _cases(SANITY + [f"case.user.num_data_points={num_data_points}", "case.data.partition=unique-class"]
               if num_data_points == 1 else SANITY + [f"case.user.num_data_points={num_data_points}"])
    shared, payloads, true = e["server"].run_protocol(e["user"])
    j_shared, j_payloads, j_true = e["j_server"].run_protocol(e["j_user"])
    np.testing.assert_array_equal(true["data"].permute(0, 2, 3, 1).numpy(), np.asarray(j_true["data"]))
    grads = shared[0]["gradients"]
    _close(grads["head.weight"].T, j_shared[0]["gradients"]["head"]["dense"]["kernel"])
    attacker = breaching.attacks.prepare_attack(e["server"].model, e["server"].loss, e["cfg"].attack, e["setup"])
    j_attacker = jax_breaching.attacks.prepare_attack(e["j_server"].model, e["j_server"].loss, e["j_cfg"].attack,
                                                      e["j_setup"])
    rec, _ = attacker.reconstruct(payloads, shared, e["server"].secrets)
    j_rec, _ = j_attacker.reconstruct(j_payloads, j_shared, e["j_server"].secrets)
    assert rec["data"].shape == true["data"].shape
    _close(rec["data"].permute(0, 2, 3, 1), j_rec["data"])
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))
    if num_data_points == 1:  # one image: every valid row is the image itself
        assert float(torch.mean((rec["data"] - true["data"]) ** 2)) < 1e-6


def test_sanity_check_through_the_entry_point_is_exact(tmp_path):
    cfg = breaching.get_config(SANITY + ["case.user.num_data_points=1"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    metrics = main_process(cfg, device="cpu")
    assert metrics["mse"] < 1e-6 and metrics["label_acc"] == 1.0
    assert metrics["parameters"] == 16 * 16 * 3 * 10 + 10
