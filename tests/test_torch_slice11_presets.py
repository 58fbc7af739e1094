"""Slice 11's presets of ``examples/run_example.py`` and case 8 through the port's entry
point (``simulate_breach.main_process(cfg, device="cpu")``), each against the JAX package's
run of the same config, cut to size (3x32x32 images, or 3x16x16 for ``cnn6``; fewer users
and images, each cut in ``PRESETS``). The port's model takes the JAX package's weights
through the bridge (ResNet-18 loads the repo's checkpoint in both), and the optimization
attacks start both packages from the JAX package's initial candidate. Each runs to a
report.

Every run: the same true images and labels, user queries, fishing secrets and
reconstructed labels. The optimization attacks (``fishing_optimization_cross_silo``: a silo
of one user with 16 of the preset's 256 images over 32 clients, ResNet-18, ``clsattack``;
case 8: ``MultiUserAggregate`` of 2 users x 2 images on ResNet-18, ``invertinggradients``;
each a dry run of one step) hold the first loss to 1e-3 relative, as tests/test_torch_presets.py
holds the optimization presets. The analytic attacks (``rgap`` on cnn6 with one image;
``april`` on ``vit_base_april``; ``fishing_analytic_cross_silo`` on ``vit_small_april`` with 4
images of one class; ``fishing_feature_cross_device`` on ``vit_small_april`` at 224x224, the
training split's images coming at 224 whatever the data's shape, with 2 images and 2 of the
preset's 55 estimation users) hold the port's attack on the JAX package's final payload and
gradient to 1e-4 of the largest entry of the JAX package's reconstruction (R-GAP's and
APRIL's float64 solves on the same float32 inputs), and the port's reconstruction from its
own run, whose user gradient agrees to about 1e-6 and whose solves amplify that, to:
``april`` 1e-4 (its 768 x 768 patch embedding is square at P = 16, a PSNR above 100 dB in
both), ``fishing_analytic_cross_silo`` 1e-3, ``rgap`` 3e-2 (measured 1.5e-2; singular
values down to 1e-3 in every layer; a PSNR above 20 dB in both). On
``fishing_feature_cross_device`` the two runs' images are not held to each other: the
ViT-S patch solve at 224 is underdetermined (384 unknowns for 768 pixels a patch) and
many pixels land on the box's bounds, so the users' last-bit differences move 2.8% (four
CPU threads) to 26% (one thread) of the pixels by more than 1e-3; only the run on the
JAX exchange is held. A fishing attack's image sits at the target's slot, zeros elsewhere.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch

from threadpoolctl import threadpool_limits

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu.cases.models.model_preparation import JaxModel
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
CASE2 = ["case=2_single_imagenet", "case.data.shape=[3, 32, 32]"]
PRESETS = {  # examples/run_example.py, cut to size
    "rgap": ["case=1_single_image_small", "attack=rgap", "case.model=cnn6", "case.data.shape=[3, 16, 16]",
             "seed=77"],
    "april": CASE2 + ["attack=april_analytic", "case.model=vit_base_april", "seed=21"],
    "fishing_optimization_cross_silo": CASE2 + [
        "attack=clsattack", "case/server=malicious-fishing", "case/user=multiuser_aggregate",
        "case.user.user_range=[0,1]", "case.data.partition=random", "case.user.num_data_points=16",
        "case.data.default_clients=32", "case.user.provide_labels=True", "case.server.target_cls_idx=0", "seed=5"],
    "fishing_analytic_cross_silo": CASE2 + [
        "attack=april_analytic", "case/server=malicious-fishing", "case.model=vit_small_april",
        "case.data.partition=unique-class", "case.user.num_data_points=4", "case.user.user_idx=1",
        "case.user.provide_labels=True", "case.server.target_cls_idx=0", "case.server.bias_multiplier=0",
        "case.server.reset_param_weights=False", "seed=5"],
    "fishing_feature_cross_device": CASE2 + [
        "attack=april_analytic", "case/server=malicious-fishing", "case.model=vit_small_april",
        "case.data.shape=[3, 224, 224]", "case.data.partition=feat_est", "case.data.examples_from_split=training",
        "case.data.default_clients=56",
        "case.server.target_cls_idx=2", "case.data.target_label=2", "case.user.num_data_points=2",
        "case.data.num_data_points=2", "case.user.provide_labels=True", "case.server.feature_estimation_users=2",
        "seed=5"],
    "case8": ["case=8_industry_scale_fl", "attack=invertinggradients", "case.data.shape=[3, 32, 32]",
              "case.user.user_range=[0,2]", "case.user.num_data_points=2", "seed=2"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's least squares on one BLAS thread: the test workers share the CPU's cores."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@pytest.fixture(autouse=True)
def _jitted_init(monkeypatch):
    """``JaxModel.init_state`` with the flax init under ``jax.jit`` (the same weights; the
    ViT-B's init takes minutes op by op on one CPU core)."""
    def init_state(self, key, input_example=None):
        example = input_example if input_example is not None else self.input_example
        variables = jax.jit(functools.partial(self.module.init, train=False))(key, example)
        return dict(variables.get("params", {})), dict(variables.get("batch_stats", {}))

    monkeypatch.setattr(JaxModel, "init_state", init_state)


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _jax_run(overrides):
    """The JAX package's ``simulate_breach.main_process``, keeping what it computes; an
    optimization attack keeps its initial candidate (drawn from key 5) under ``init``."""
    cfg = jax_breaching.get_config(overrides + ["dryrun=True"])
    setup = jax_breaching.utils.system_startup(cfg=cfg)
    user, server, model, _ = jax_breaching.cases.construct_case(cfg.case, setup)
    flat = _flat(model.params, model.buffers)
    attacker = jax_breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    init = {}
    if hasattr(attacker, "_init_candidate_tree"):
        draw = attacker._init_candidate_tree

        def init_candidate_tree(num_points, key, labels):
            init.update({k: np.asarray(v) for k, v in draw(num_points, jax.random.PRNGKey(5), labels).items()})
            return draw(num_points, jax.random.PRNGKey(5), labels)

        attacker._init_candidate_tree = init_candidate_tree
    n_extra = int(cfg.case.server.get("feature_estimation_users", 0) or 0)
    if n_extra:
        base_idx = int(cfg.case.user.get("user_idx") or 0)
        extra = []
        for idx in range(base_idx + 1, base_idx + 1 + n_extra):
            cfg.case.user.user_idx = idx
            extra.append(jax_breaching.cases.construct_user(model, server.loss, cfg.case, setup))
        cfg.case.user.user_idx = base_idx
        shared, payloads, true = server.run_protocol(user, additional_users=extra)
    else:
        shared, payloads, true = server.run_protocol(user)
    rec, stats = attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)
    return dict(cfg=cfg, setup=setup, flat=flat, init=init, user=user, server=server, shared=shared,
                payloads=payloads, stats=stats, rec=rec, true=true)


def _port_run(overrides, flat, init, tmp_path, monkeypatch):
    """The port's entry point on the JAX package's weights, an optimization attack from
    the JAX package's initial candidate."""
    from breaching_tpu_torch.attacks.optimization_based_attack import OptimizationBasedAttacker

    build = breaching.cases.construct_model

    def construct_model(*args, **kwargs):
        model, loss = build(*args, **kwargs)
        load_flat_state(model, flat, strict=True)
        return model, loss

    monkeypatch.setattr(breaching.cases, "construct_model", construct_model)
    if init:
        start = torch.from_numpy(_nchw(init["data"]).copy())[None]
        monkeypatch.setattr(OptimizationBasedAttacker, "_init_candidate_tree",
                            lambda self, num_trials, n: dict(data=start.clone()))
    cfg = breaching.get_config(overrides + ["dryrun=True"])
    cfg.base_dir = str(tmp_path)
    out = {}
    metrics = main_process(cfg, device="cpu", outputs=out)
    return dict(out, metrics=metrics)


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("preset", ["rgap", "april", "fishing_optimization_cross_silo"])
def test_preset_runs_through_main_process_as_the_jax_package(preset, tmp_path, monkeypatch, caplog):
    check_preset(preset, tmp_path, monkeypatch, caplog)


def check_preset(preset, tmp_path, monkeypatch, caplog):
    """Run ``preset`` through both packages and hold the port's run to the JAX package's."""
    j = _jax_run(PRESETS[preset])
    with caplog.at_level(logging.INFO):
        p = _port_run(PRESETS[preset], j["flat"], j["init"], tmp_path, monkeypatch)
    assert "METRICS:" in caplog.text and np.isfinite(p["metrics"]["mse"])
    rec, j_rec, true = p["reconstruction"], j["rec"], p["true"]
    np.testing.assert_array_equal(true["data"].numpy(), _nchw(j["true"]["data"]))
    np.testing.assert_array_equal(torch.as_tensor(true["labels"]).numpy(), np.asarray(j["true"]["labels"]))
    assert rec["data"].shape == true["data"].shape
    assert p["user"].counted_queries == j["user"].counted_queries
    secrets, j_secrets = p["server"].secrets.get("ClassAttack"), j["server"].secrets.get("ClassAttack")
    assert (secrets is None) == (j_secrets is None)
    if secrets is not None:
        np.testing.assert_array_equal(np.asarray(secrets["target_indx"]).reshape(-1),
                                      np.asarray(j_secrets["target_indx"]).reshape(-1))
    if rec.get("labels") is not None:
        np.testing.assert_array_equal(torch.as_tensor(rec["labels"]).numpy(), np.asarray(j_rec["labels"]))
    losses, j_losses = p["stats"].get("Trial_0_Val"), j["stats"].get("Trial_0_Val")
    if losses:  # the optimization attacks: the dry run's step
        assert len(losses) == len(j_losses) == 1
        assert abs(losses[0] - j_losses[0]) <= 1e-3 * abs(j_losses[0]), (losses, j_losses)
        return
    j_data = _nchw(j_rec["data"])
    _close(_attack_on_the_jax_exchange(preset, p, j)["data"].numpy(), j_data, 1e-4)
    got = rec["data"].numpy()
    assert np.isfinite(got).all()
    if preset != "fishing_feature_cross_device":
        _close(got, j_data, {"april": 1e-4, "rgap": 3e-2}.get(preset, 1e-3))
    if secrets is not None:  # one image at the target's slot, zeros elsewhere
        others = np.ones(j_data.shape[0], bool)
        others[int(np.asarray(secrets["target_indx"]).reshape(-1)[0])] = False
        assert not got[others].any()
    if preset in ("rgap", "april"):
        j_metrics = jax_breaching.analysis.report(j_rec, j["true"], j["payloads"], j["server"].model,
                                                  cfg_case=j["cfg"].case, setup=j["setup"])
        bar = 20 if preset == "rgap" else 100
        assert p["metrics"]["psnr"] > bar and j_metrics["psnr"] > bar


def _attack_on_the_jax_exchange(preset, p, j):
    """The port's attack of ``preset`` on the JAX package's final payload and shared
    gradient, moved across by the bridge."""
    from breaching_tpu_torch.cases.models.model_preparation import _flat_entries

    model = p["server"].model
    names = {id(t): n for n, t in model.named_parameters()}

    def as_port(tree):
        flat = _flat(tree, {})
        return {names[id(t)]: torch.from_numpy(np.ascontiguousarray(transform(flat[k]) if transform else flat[k]))
                for k, t, transform in _flat_entries(model) if k.startswith("params/")}

    cfg = breaching.get_config(PRESETS[preset])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    attacker = breaching.attacks.prepare_attack(model, p["server"].loss, cfg.attack, setup)
    payload = dict(p["server"].distribute_payload(), parameters=as_port(j["payloads"][0]["parameters"]))
    metadata = dict(j["shared"][0]["metadata"])
    if metadata["labels"] is not None:
        metadata["labels"] = torch.as_tensor(np.asarray(metadata["labels"]))
    shared = [dict(gradients=as_port(j["shared"][0]["gradients"]), buffers=None, metadata=metadata)]
    rec, _ = attacker.reconstruct([payload], shared, p["server"].secrets)
    return rec
