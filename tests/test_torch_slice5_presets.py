"""Slice 5's presets of ``examples/run_example.py`` in the port, against the JAX package,
on the CPU: ``see_through_gradients`` (case 5: ResNet-50 on the repo's checkpoint, the
euclidean objective, TV, the norm prior, DeepInversion, ``yin`` labels, Langevin noise
and the user's BatchNorm buffers), the three Inverting Gradients presets
``inverting_gradients_fedavg`` (an untrained CIFAR-stem ResNet-18, a fedAVG user of 4
images and 4 local steps), ``inverting_gradients_fedavg_cifar`` (the same user on the
ConvNet) and ``inverting_gradients_resnet18`` (case 2), and
``inverting_large_batch_cifar`` (case 6 with ``attack.impl.grad_accum=10``).

Each runs through the port's entry point (``main_process``, a dry run), and 3 Adam
steps through both packages' ``reconstruct`` from the JAX package's own initial
candidate, given to both by overriding each attacker's candidate initialization, as
tests/test_torch_presets.py runs the other presets. Cut to size: 32x32 images (16x16
for the ConvNet and for case 6), ConvNet-8, and for case 6 20 images on
``ResNet32-1`` (the depth and the wide-ResNet parse of ``ResNet32-10``, width 16) with
grad_accum=10 (2 images a micro-batch). Langevin noise is injected into both packages
(one standard normal draw from a numpy seed, as tests/test_torch_optim.py does).

``inverting_gradients_fedavg`` is held otherwise. On its untrained CIFAR-stem ResNet-18
the JAX package's float32 objective through the user's 4 unrolled local steps is
itself far from the exact value on the CPU: at the initial candidate, 1.6e-3 (op by
op), 1.4e-2 (jitted) and 8e-3 (jitted under the trials' vmap) relative to the float64
evaluation, and 9% at the attack's own step 0 (0.1070 against 0.1175), where the port
is 9.1e-7 from float64 (measured at the preset's local learning rate 0.001; at 0.1,
1.6e-3, 1.4e-2, 8e-3 and 7%, the port 1e-7 relative). So its objective and attack
gradient at the JAX package's initial candidate are held to the port's float64
evaluation, the value 1 - cos to 16 float32 ulps of the cosine (9.5e-7) and the
gradient, as tests/test_torch_attack.py holds the attack gradient, to 1e-4 of its
largest entry [measured: 4.5e-5; the delta of 0.001-sized steps on weights near 0.06
keeps few float32 digits]; and its value to the JAX package's op-by-op one within
5e-3 relative.

Tolerances of the other presets, as tests/test_torch_presets.py holds them: every loss 1e-3 relative,
at most 1% of the pixels of the reconstruction 1e-3 apart, the labels equal. DeepInversion
is 0 on ``see_through_gradients`` in both packages: the user's buffers put BatchNorm in
eval mode, and the JAX BatchNorm sows its statistics only in train mode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
FEDAVG = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
          "case.user.provide_labels=True"]
PRESETS = {  # examples/run_example.py, cut to size
    "see_through_gradients": ["case=5_small_batch_imagenet", "attack=seethroughgradients",
                              "case.data.partition=unique-class", "case.user.num_data_points=1",
                              "case.server.provide_public_buffers=False", "case.user.provide_buffers=True",
                              "case.data.shape=[3, 32, 32]", "seed=7"],
    "inverting_gradients_fedavg": FEDAVG + ["case/data=CIFAR10", "case.data.partition=random",
                                            "case.model=ResNet18", "case.server.pretrained=False",
                                            "case.user.user_idx=1",
                                            "attack.regularization.total_variation.scale=1e-3",
                                            "case.data.shape=[3, 32, 32]", "seed=7"],
    "inverting_gradients_fedavg_cifar": FEDAVG + ["case/data=CIFAR10", "case.model=ConvNet8",
                                                  "case.data.shape=[3, 16, 16]", "seed=7"],
    "inverting_gradients_resnet18": ["case=2_single_imagenet", "attack=invertinggradients",
                                     "case.data.shape=[3, 32, 32]", "seed=7"],
    "inverting_large_batch_cifar": ["case=6_large_batch_cifar", "attack=invertinggradients",
                                    "attack.impl.grad_accum=10", "attack.optim.callback=100",
                                    "case.model=ResNet32-1", "case.user.num_data_points=20",
                                    "case.data.batch_size=20", "case.data.shape=[3, 16, 16]", "seed=7"],
}
# the presets whose steps are held to the JAX package's; inverting_gradients_fedavg is
# held to the float64 evaluation instead (test_fedavg_resnet18_objective_matches_float64)
STEPS = sorted(set(PRESETS) - {"inverting_gradients_fedavg"})


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _both_cases(overrides):
    """Both packages' case on the same weights and their FL exchange."""
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
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    shared, payloads, true = server.run_protocol(user)
    return dict(cfg=cfg, setup=setup, server=server, attacker=attacker, shared=shared, payloads=payloads,
                true=true, j_server=j_server, j_attacker=j_attacker, j_shared=j_shared, j_payloads=j_payloads)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_dry_run_through_the_entry_point(preset, tmp_path):
    cfg = breaching.get_config(PRESETS[preset] + ["dryrun=True"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    metrics = main_process(cfg, device="cpu")
    assert np.isfinite(metrics["mse"]) and np.isfinite(metrics["psnr"])
    assert 0.0 <= metrics["label_acc"] <= 1.0


@pytest.mark.parametrize("preset", STEPS)
def test_preset_steps_match_jax(preset, monkeypatch):
    steps = 3
    e = _both_cases(PRESETS[preset] + [f"attack.optim.max_iterations={steps}", "attack.optim.callback=1"])
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    _, j_labels, _ = j_attacker.prepare_attack(e["j_payloads"], e["j_shared"])
    num_points = int(e["j_shared"][0]["metadata"]["num_data_points"])
    data = np.asarray(j_attacker._init_candidate_tree(num_points, jax.random.PRNGKey(5), j_labels)["data"])
    j_attacker._init_candidate_tree = lambda n, key, labels: dict(data=jnp.asarray(data))
    attacker._init_candidate_tree = lambda num_trials, n: dict(data=torch.from_numpy(_nchw(data).copy())[None])
    if float(e["cfg"].attack.optim.langevin_noise or 0) > 0:
        noise = np.random.default_rng(9).normal(size=data.shape).astype(np.float32)
        real_normal = jax.random.normal
        monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
            noise, dtype) if tuple(shape) == noise.shape else real_normal(key, shape, dtype))
        attacker._noise = lambda like: torch.from_numpy(_nchw(noise).copy())

    j_rec, j_stats = j_attacker.reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    monkeypatch.undo()
    rec, stats = attacker.reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == steps and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    differing = np.abs(rec["data"].numpy() - _nchw(j_rec["data"])) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))
    metrics = breaching.analysis.report(rec, e["true"], e["payloads"], e["server"].model, cfg_case=e["cfg"].case,
                                        setup=e["setup"])
    assert np.isfinite(metrics["psnr"])


def test_fedavg_resnet18_objective_matches_float64():
    e = _both_cases(PRESETS["inverting_gradients_fedavg"])
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    j_models, j_labels, _ = j_attacker.prepare_attack(e["j_payloads"], e["j_shared"])
    data = np.asarray(j_attacker._init_candidate_tree(4, jax.random.PRNGKey(5), j_labels)["data"])
    hyper = dict(j_attacker._shared_data_cache[0]["metadata"]["local_hyperparams"])
    hyper["labels"] = jnp.asarray(np.stack([np.asarray(step) for step in hyper["labels"]]))
    j_attacker.objective.initialize(j_attacker.loss_fn, j_models[0], hyper, j_attacker.cfg.impl)
    j_value, _, _ = j_attacker.objective(j_models[0].params, j_models[0].buffers,
                                         j_attacker._shared_data_cache[0]["gradients"], jnp.asarray(data), j_labels)

    models, labels, _ = attacker.prepare_attack(e["payloads"], e["shared"])
    target = tuple(attacker._shared_data_cache[0]["gradients"][k] for k in models[0].params)
    results = []
    for dtype in (torch.float64, torch.float32):
        module = copy.deepcopy(models[0].module).to(dtype)
        attacker.objective.initialize(attacker.loss_fn, module,
                                      attacker._local_hyperparams(attacker._shared_data_cache[0]["metadata"]),
                                      attacker.cfg.impl)
        params = {k: v.detach().to(dtype).requires_grad_(True) for k, v in models[0].params.items()}
        buffers = {k: v.to(dtype) for k, v in models[0].buffers.items()}
        x = torch.from_numpy(_nchw(data).copy()).to(dtype).requires_grad_(True)
        value, _ = attacker.objective(params, buffers, tuple(t.to(dtype) for t in target), x, labels)
        grad, = torch.autograd.grad(value, x)
        results.append((value.item(), grad.double()))
    (exact_value, exact), (value, grad) = results
    assert abs(value - exact_value) <= 16 * np.finfo(np.float32).eps / 2
    np.testing.assert_allclose(grad.numpy(), exact.numpy(), rtol=0, atol=1e-4 * exact.abs().max().item())
    assert abs(value - float(j_value)) <= 5e-3 * abs(value)
