"""The JAX package's named optimization presets of ``examples/run_example.py`` in the
port, against the JAX package, on the CPU: ``deep_leakage`` (the joint attack), its
fused-euclidean variant, ``wei_framework``, ``beyond_inferring``,
``modern_hyperparams`` and ``legacy_hyperparams``; with the candidate
initializations and label strategies they rest on.

- Initializations: ``patterned-N`` and ``patterned-rand-N`` tile the same seed tile
  as the JAX package's (its own draw, given to the port's ``tile_pattern``), and the
  colours and their ``-true`` variants equal the JAX package's bit for bit.
- Label strategies: each on the same user gradients, from both packages' FL exchange
  of 4 images on the same weights (ConvNet-8 on CIFAR-10 shapes at 16x16, ResNet-18 on
  the repo's checkpoint at 32x32), ``random`` and the random padding from the JAX
  package's own numpy seed: the same labels.
- Presets: each through the port's entry point (``main_process``, a dry run), and 2
  (L-BFGS) or 3 (Adam) steps through both packages' ``reconstruct`` from the JAX
  package's own initial candidate tree (data and, for the joint attack, label logits),
  given to both by overriding each attacker's candidate initialization. Case 1 runs
  ConvNet-8 at 16x16, case 2 ResNet-18 on the checkpoint at 32x32 with the labels
  left to ``bias-corrected``.

Tolerances, as tests/test_torch_attack.py and tests/test_torch_lbfgs.py hold the
attack (float32 on both sides, sums in other orders, through a double backward):
every loss of the trajectory 1e-3 relative, at most 1% of the pixels of the
reconstruction 1e-3 apart, the labels equal. The fused euclidean loss is a difference
of sums far larger than itself, so its losses also take the absolute 1e-5 of
|target gradient|^2 that tests/test_torch_objectives.py states for it. Its value is
quantized to float32 ulps of those sums (about 1e-7 here): two trial steps of L-BFGS
then give equal values, and its break on a loss change below 1e-9 fires, at an inner
step that differs between the packages (measured: both candidates 1.8e-3 from the
start, 2.1e-3 apart, at losses 0.0017415 and 0.0017335, the plain objective's
0.0017345). Its gradient equals the plain objective's in both packages; its
reconstruction is not compared, its losses and labels are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.initializations import init_candidate as jax_init_candidate
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.initializations import init_candidate, tile_pattern
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
CASE1 = ["case=1_single_image_small", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]", "seed=0"]
CASE2 = ["case=2_single_imagenet", "case.data.shape=[3, 32, 32]", "seed=7"]
PRESETS = {  # examples/run_example.py, cut to size
    "deep_leakage": CASE1 + ["attack=deepleakage", "case.user.provide_labels=False"],
    "deep_leakage_fused": CASE1 + ["attack=deepleakage", "case.user.provide_labels=False",
                                   "attack.objective.type=fused-euclidean"],
    "wei_framework": CASE1 + ["attack=wei"],
    "beyond_inferring": CASE1 + ["attack=beyondinfering", "case.data.partition=unique-class",
                                 "case.user.user_idx=1", "attack.regularization.total_variation.scale=1e-4"],
    "modern_hyperparams": CASE2 + ["attack=modern"],
    "legacy_hyperparams": CASE2 + ["attack=legacy"],
}


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


# ---------------------------------------------------------------- initializations

@pytest.mark.parametrize("init", ["patterned-4", "patterned-16", "patterned-rand-8", "wei-5", "patterned"])
def test_patterned_inits_tile_the_jax_packages_seed_tile(init):
    shape = (2, 3, 20, 18)
    want = np.asarray(jax_init_candidate(jax.random.PRNGKey(1), init, (2, 20, 18, 3)))
    width = int("".join(filter(str.isdigit, init)) or "4")
    tile = _nchw(want[:, :width, :width, :])
    np.testing.assert_array_equal(tile_pattern(torch.from_numpy(tile.copy()), 20, 18).numpy(), _nchw(want))
    got = init_candidate(torch.Generator().manual_seed(0), init, shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), tile_pattern(got[..., :width, :width], 20, 18).numpy())
    if "rand" in init and "randn" not in init:
        assert got.min() >= -1 and got.max() < 1


@pytest.mark.parametrize("init", ["red", "green", "blue", "dark", "light", "red-true", "green-true",
                                  "blue-true", "dark-true", "light-true"])
def test_colour_inits_match_jax(init):
    mean, std = np.asarray([0.5, 0.4, 0.3], np.float32), np.asarray([0.2, 0.25, 0.3], np.float32)
    want = jax_init_candidate(jax.random.PRNGKey(0), init, (2, 5, 4, 3), dm=jnp.asarray(mean).reshape(1, 1, 1, 3),
                              ds=jnp.asarray(std).reshape(1, 1, 1, 3))
    got = init_candidate(None, init, (2, 3, 5, 4), mean=torch.from_numpy(mean), std=torch.from_numpy(std))
    np.testing.assert_array_equal(got.numpy(), _nchw(want))


# ---------------------------------------------------------------- label strategies

def _both_cases(overrides):
    """Both packages' case on the same weights and their FL exchange; the attackers
    prepared up to label recovery."""
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    flat = {}
    for prefix, tree in (("params/", j_model.params), ("buffers/", j_model.buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    load_flat_state(model, flat, strict=True)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, j_true = j_server.run_protocol(j_user)
    shared, payloads, true = server.run_protocol(user)
    return dict(cfg=cfg, setup=setup, server=server, attacker=attacker, shared=shared, payloads=payloads,
                true=true, j_setup=jax_setup, j_server=j_server, j_attacker=j_attacker, j_shared=j_shared,
                j_payloads=j_payloads, j_true=j_true)


@pytest.fixture(scope="module", params=["convnet", "resnet18"])
def four_images(request):
    base = CASE1 if request.param == "convnet" else CASE2
    return _both_cases(base + ["attack=invertinggradients", "case.user.provide_labels=False",
                               "case.user.num_data_points=4", "case.data.batch_size=4"])


@pytest.mark.parametrize("strategy", ["iDLG", "analytic", "yin", "wainakh-simple", "bias-corrected", "random"])
def test_label_strategies_match_jax(four_images, strategy):
    e = four_images
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    j_attacker.cfg.label_strategy = attacker.cfg.label_strategy = strategy
    j_models, _, _ = j_attacker.prepare_attack(e["j_payloads"], e["j_shared"])
    want = np.asarray(j_attacker._recover_label_information(j_attacker._shared_data_cache, e["j_payloads"],
                                                            j_models))
    attacker.prepare_attack(e["payloads"], e["shared"])
    # the JAX package seeds its numpy generator from its PRNG key; the port draws from setup["python_rng"]
    seed = np.asarray(jax.random.key_data(e["j_setup"]["key"]))[-1]
    attacker.setup["python_rng"] = np.random.default_rng(seed)
    got = attacker._recover_label_information(attacker._shared_data_cache)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 4


def test_unported_label_strategies_are_refused(four_images):
    """``bias-text`` recovers a text payload's tokens and is refused on images;
    ``exhaustive`` raises the JAX package's ``ValueError`` (``wainakh-whitebox`` runs:
    tests/test_torch_labels.py)."""
    attacker = four_images["attacker"]
    for strategy, error, message in (("bias-text", NotImplementedError, "bias-text"),
                                     ("exhaustive", ValueError, "Exhaustive label searching is not implemented")):
        attacker.cfg.label_strategy = strategy
        with pytest.raises(error, match=message):
            attacker.prepare_attack(four_images["payloads"], four_images["shared"])


# ---------------------------------------------------------------- presets

@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_dry_run_through_the_entry_point(preset, caplog, tmp_path):
    cfg = breaching.get_config(PRESETS[preset] + ["dryrun=True"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    metrics = main_process(cfg, device="cpu")
    assert np.isfinite(metrics["mse"]) and np.isfinite(metrics["psnr"])
    assert 0.0 <= metrics["label_acc"] <= 1.0


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_steps_match_jax(preset):
    lbfgs = preset in ("deep_leakage", "deep_leakage_fused", "wei_framework", "beyond_inferring")
    steps = 2 if lbfgs else 3
    e = _both_cases(PRESETS[preset] + [f"attack.optim.max_iterations={steps}", "attack.optim.callback=1"])
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    # the JAX package's own initial candidate tree for this preset, given to both
    _, j_labels, _ = j_attacker.prepare_attack(e["j_payloads"], e["j_shared"])
    if preset.startswith("deep_leakage"):
        j_attacker._num_classes, j_attacker._task = e["j_payloads"][0]["metadata"]["classes"], "classification"
    num_points = int(e["j_shared"][0]["metadata"]["num_data_points"])
    tree = {k: np.asarray(v) for k, v in j_attacker._init_candidate_tree(num_points, jax.random.PRNGKey(5),
                                                                         j_labels).items()}
    j_attacker._init_candidate_tree = lambda n, key, labels: {k: jnp.asarray(v) for k, v in tree.items()}
    port_tree = dict(data=torch.from_numpy(_nchw(tree["data"]).copy())[None])
    if "labels" in tree:
        port_tree["labels"] = torch.from_numpy(tree["labels"].copy())[None]
    attacker._init_candidate_tree = lambda num_trials, n: {k: v.clone() for k, v in port_tree.items()}

    j_rec, j_stats = j_attacker.reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    rec, stats = attacker.reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == steps and np.isfinite(got).all()
    fused_atol = 0.0
    if "fused" in preset:
        fused_atol = 1e-5 * sum(float((g * g).sum()) for g in e["shared"][0]["gradients"].values())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=fused_atol)
    if "fused" not in preset:
        differing = np.abs(rec["data"].numpy() - _nchw(j_rec["data"])) > 1e-3
        assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))
    if lbfgs:
        assert steps < stats["objective_evaluations"] <= steps * 21
    metrics = breaching.analysis.report(rec, e["true"], e["payloads"], e["server"].model, cfg_case=e["cfg"].case,
                                        setup=e["setup"])
    assert np.isfinite(metrics["psnr"])
