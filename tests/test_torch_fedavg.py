"""The fedAVG user (case 4) in the port against the JAX package: the user's parameter
delta and metadata, the attack's unrolled multi-step objective and its gradient,
``bias-corrected`` labels recovered from the delta, a short hard-signed
reconstruction and its score, the unrolled steps on a candidate where they
diverge, the candidate an attack stops at when its loss is not finite, the
refusals, and the CPU dry run of the entry point.

Both packages build the same case; the port's model takes the JAX model's weights
through ``load_flat_state``. ConvNet-8 runs on CIFAR-10 shapes cut to 16x16 with
K = 3 local steps of m = 2 of N = 4 images at learning rate 0.1; ResNet-18 (the
ImageNet stem, on the repo's checkpoint) at 64x64 with the case's own 0.001.

Tolerances (float32 on both sides, convolutions summed in other orders; the
agreement measured on these tests in brackets):
- the delta: 2e-5 of its largest entry, as tests/test_torch_users.py holds the
  fedSGD gradient [ConvNet-8 2.1e-7, in train mode 3.5e-6; ResNet-18 1.0e-5]; the
  running statistics of train mode 2e-5 of their largest entry [4.8e-6];
- the objective's value, 1 - cos with cos near 1 (1.8e-3 and 5.4e-4 here), 1e-6
  absolute, 16 float32 ulps of cos [0; 6e-8 fused]; the last local step's task loss
  1e-5 relative [0]; the gradient with respect to the candidate 1e-4 of its largest
  entry, as tests/test_torch_attack.py holds the fedSGD one [2.5e-6];
- 3 hard-signed steps: losses 1e-3 relative [1.3e-5], at most 1% of the pixels more
  than 1e-3 apart [none; 6e-8 at most], as tests/test_torch_attack.py; the score of
  the reconstruction, 1 - cos near 1.2e-3, 1e-5 absolute as there [4.6e-6; a
  scorer without the local hyperparameters gives a one-step gradient's 1.9].
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
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.objectives import CosineSimilarity, objective_lookup
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
FEDAVG = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.data.batch_size=4",
          "case.user.num_data_points=4", "case.user.num_local_updates=3",
          "case.user.num_data_per_local_update_step=2", "seed=8"]
CONVNET = FEDAVG + ["case/data=CIFAR10", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]",
                    "case.user.local_learning_rate=0.1", "case.user.provide_labels=True"]
RESNET = FEDAVG + ["case.data.shape=[3, 64, 64]", "case.user.provide_labels=True"]


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _both(overrides):
    """Both packages' case on the same weights, data and exchange."""
    runs = {}
    for name, package in (("ref", jax_breaching), ("port", breaching)):
        cfg = package.get_config(overrides)
        setup = (package.utils.system_startup(cfg=cfg, device="cpu") if name == "port"
                 else package.utils.system_startup(cfg=cfg))
        user, server, model, loss_fn = package.cases.construct_case(cfg.case, setup)
        if name == "port":
            ref_model = runs["ref"]["model"]
            load_flat_state(model, _flat(ref_model.params, ref_model.buffers), strict=True)
        shared, payloads, true = server.run_protocol(user)
        runs[name] = dict(cfg=cfg, setup=setup, server=server, model=model, loss_fn=loss_fn, shared=shared,
                          payloads=payloads, true=true,
                          attacker=package.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup))
    return runs["port"], runs["ref"]


def _in_port_layout(model, params, buffers=None):
    """A JAX parameter tree (and buffers) in the port's names and layouts."""
    twin = copy.deepcopy(model)
    load_flat_state(twin, _flat(params, buffers or {}))
    return dict(twin.named_parameters()), dict(twin.named_buffers())


@pytest.fixture(scope="module")
def convnet():
    return _both(CONVNET)


@pytest.fixture(scope="module")
def resnet():
    return _both(RESNET)


@pytest.mark.parametrize("model,public_buffers", [("ConvNet-8", True), ("ConvNet-8", False), ("ResNet-18", True)])
def test_user_delta_and_metadata_match_the_jax_package(model, public_buffers, resnet):
    if model == "ResNet-18":
        port, ref = resnet
    else:
        port, ref = _both(CONVNET + [f"case.server.provide_public_buffers={public_buffers}"])
    np.testing.assert_array_equal(port["true"]["data"].numpy(),
                                  np.transpose(np.asarray(ref["true"]["data"]), (0, 3, 1, 2)))
    shared, j_shared = port["shared"][0], ref["shared"][0]
    want, want_buffers = _in_port_layout(port["model"], j_shared["gradients"], ref["true"]["buffers"])
    assert list(shared["gradients"]) == list(want)
    scale = max(v.abs().max().item() for v in want.values())
    for name, delta in shared["gradients"].items():
        np.testing.assert_allclose(delta.numpy(), want[name].detach().numpy(), rtol=0, atol=2e-5 * scale)
    if not public_buffers:  # train mode: the running statistics carry over the three steps
        for name, buffer in port["true"]["buffers"].items():
            if name.endswith(("running_mean", "running_var")):
                expected = want_buffers[name].numpy()
                np.testing.assert_allclose(buffer.numpy(), expected, rtol=0, atol=2e-5 * np.abs(expected).max())

    metadata, j_metadata = shared["metadata"], j_shared["metadata"]
    # the shared labels in data order; each step's labels sorted
    np.testing.assert_array_equal(metadata["labels"].numpy(), np.asarray(j_metadata["labels"]))
    np.testing.assert_array_equal(metadata["labels"].numpy(), port["true"]["labels"].numpy())
    hp, j_hp = metadata["local_hyperparams"], j_metadata["local_hyperparams"]
    assert (hp["lr"], hp["steps"], hp["data_per_step"]) == (j_hp["lr"], j_hp["steps"], j_hp["data_per_step"])
    assert len(hp["labels"]) == len(j_hp["labels"]) == 3
    for step_labels, j_step_labels in zip(hp["labels"], j_hp["labels"]):
        np.testing.assert_array_equal(step_labels.numpy(), np.asarray(j_step_labels))
        assert torch.equal(step_labels, torch.sort(step_labels).values)
    assert metadata["num_data_points"] == j_metadata["num_data_points"] == 4


def _port_objective(port, objective_type):
    attacker = port["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(port["payloads"], port["shared"])
    objective = objective_lookup[objective_type]()
    objective.initialize(port["loss_fn"], rec_models[0].module,
                         attacker._local_hyperparams(port["shared"][0]["metadata"]), attacker.cfg.impl)
    targets = tuple(attacker._shared_data_cache[0]["gradients"][k] for k in rec_models[0].params)
    model = rec_models[0]

    def evaluate(x):
        xt = torch.as_tensor(x).clone().requires_grad_(True)
        value, task_loss = objective(model.params, model.buffers, targets, xt, labels)
        grad, = torch.autograd.grad(value, xt)
        return value.item(), task_loss.item(), grad.numpy()
    return evaluate


def _jax_objective(ref):
    attacker = ref["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(ref["payloads"], ref["shared"])
    local_hp = dict(ref["shared"][0]["metadata"]["local_hyperparams"])
    local_hp["labels"] = jnp.asarray(np.stack([np.asarray(step) for step in local_hp["labels"]]))
    objective = JaxCosine()
    objective.initialize(ref["loss_fn"], rec_models[0], local_hp, attacker.cfg.impl)
    model, targets = rec_models[0], attacker._shared_data_cache[0]["gradients"]

    def evaluate(x):
        def value_fn(candidate):
            value, task_loss, _ = objective(model.params, model.buffers, targets, candidate, labels)
            return value, task_loss
        (value, task_loss), grad = jax.value_and_grad(value_fn, has_aux=True)(
            jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
        return float(value), float(task_loss), np.transpose(np.asarray(grad), (0, 3, 1, 2))
    return evaluate


@pytest.mark.parametrize("objective_type", ["cosine-similarity", "fused-cosine-similarity"])
def test_unrolled_objective_and_attack_gradient_match_the_jax_package(convnet, objective_type):
    port, ref = convnet
    x = np.random.default_rng(4).normal(size=(4, 3, 16, 16)).astype(np.float32)
    value, task_loss, grad = _port_objective(port, objective_type)(x)
    j_value, j_task_loss, j_grad = _jax_objective(ref)(x)
    assert abs(value - j_value) <= 1e-6, (value, j_value)
    assert abs(task_loss - j_task_loss) <= 1e-5 * abs(j_task_loss)  # the last local step's
    np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-4 * np.abs(j_grad).max())


def _port_only(overrides):
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, true = server.run_protocol(user)
    return dict(shared=shared, payloads=payloads, true=true, loss_fn=loss_fn,
                attacker=breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup))


def test_objective_is_zero_at_the_truth_only_where_sorting_changes_nothing(convnet):
    """The shared per-step labels are sorted while the candidate is taken in data
    order: on a single-class partition the unrolled steps at the true data give the
    user's delta, elsewhere they need not (the JAX package behaves alike). With 3
    images and 2 a step, the second step's rows (2, 0) wrap around the data."""
    for num_points in (4, 3):
        port = _port_only(CONVNET + ["case.data.partition=unique-class", "case.user.user_idx=2",
                                     f"case.user.num_data_points={num_points}"])
        truth = port["true"]["data"].numpy()
        assert len(set(port["true"]["labels"].tolist())) == 1 and len(truth) == num_points
        at_truth, _, _ = _port_objective(port, "cosine-similarity")(truth)
        perturbed, _, _ = _port_objective(port, "cosine-similarity")(truth + 0.5)
        assert at_truth < 1e-6 and perturbed > 100 * max(at_truth, 1e-8), (num_points, at_truth, perturbed)

    port, ref = convnet  # labels [8, 0, 7, 6]: step 0 trains images (8, 0) on labels (0, 8)
    truth = port["true"]["data"].numpy()
    mixed, _, _ = _port_objective(port, "cosine-similarity")(truth)
    j_mixed, _, _ = _jax_objective(ref)(truth)
    assert mixed > 100 * max(at_truth, 1e-8) and abs(mixed - j_mixed) <= 1e-6, (mixed, j_mixed)


@pytest.mark.parametrize("candidate", ["constant", "contrast x3"])
def test_local_steps_diverge_alike_on_a_saturated_candidate(resnet, candidate):
    """On a saturated candidate the simulated local SGD of ResNet-18 diverges (the
    delta grows past 1e6 times the user's; a few steps more and the attack's loss is
    not finite); the JAX package's unrolled steps diverge alike, to 1e-4 of the
    largest entry [7.5e-6 and 1.4e-5]."""
    port, ref = resnet
    truth = port["true"]["data"]
    x = torch.full_like(truth, -2.1) if candidate == "constant" else (3 * truth).clamp(-2.1, 2.6)
    attacker, j_attacker = port["attacker"], ref["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(port["payloads"], port["shared"])
    objective = CosineSimilarity()
    objective.initialize(port["loss_fn"], rec_models[0].module,
                         attacker._local_hyperparams(port["shared"][0]["metadata"]))
    delta, _ = objective.grad_fn(rec_models[0].params, rec_models[0].buffers, x, labels)
    j_models, j_labels, _ = j_attacker.prepare_attack(ref["payloads"], ref["shared"])
    local_hp = dict(ref["shared"][0]["metadata"]["local_hyperparams"])
    local_hp["labels"] = jnp.asarray(np.stack([np.asarray(step) for step in local_hp["labels"]]))
    j_objective = JaxCosine()
    j_objective.initialize(ref["loss_fn"], j_models[0], local_hp, j_attacker.cfg.impl)
    j_delta, _, _ = j_objective.grad_fn(j_models[0].params, j_models[0].buffers,
                                        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), j_labels)
    want, _ = _in_port_layout(port["model"], j_delta)
    scale = max(v.abs().max().item() for v in want.values())
    user_scale = max(v.abs().max().item() for v in port["shared"][0]["gradients"].values())
    assert scale > 1e6 * user_scale, (scale, user_scale)
    for name, value in zip(rec_models[0].params, delta):
        np.testing.assert_allclose(value.detach().numpy(), want[name].detach().numpy(), rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("overrides", [CONVNET, RESNET], ids=["ConvNet-8", "ResNet-18"])
def test_bias_corrected_labels_from_the_delta_match_the_jax_package(overrides):
    port, ref = _both(overrides + ["case.user.provide_labels=False"])
    assert port["shared"][0]["metadata"]["labels"] is None
    _, labels, _ = port["attacker"].prepare_attack(port["payloads"], port["shared"])
    _, j_labels, _ = ref["attacker"].prepare_attack(ref["payloads"], ref["shared"])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    assert len(labels) == 4


@pytest.fixture(scope="module")
def reconstructions():
    """Three hard-signed steps of both packages from the same initial candidate."""
    port, ref = _both(CONVNET + ["attack.optim.max_iterations=3", "attack.optim.callback=3"])
    x = np.random.default_rng(3).normal(size=(4, 3, 16, 16)).astype(np.float32)
    rec = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                       initial_data=torch.from_numpy(x))
    j_rec = ref["attacker"].reconstruct(ref["payloads"], ref["shared"], ref["server"].secrets,
                                        initial_data=np.transpose(x, (0, 2, 3, 1)))
    return dict(port=rec, ref=j_rec, run=port)


def test_short_signed_reconstruction_matches_the_jax_package(reconstructions):
    (rec, stats), (j_rec, j_stats) = reconstructions["port"], reconstructions["ref"]
    assert len(stats["Trial_0_Val"]) == len(j_stats["Trial_0_Val"]) == 3
    np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-3)
    differing = np.abs(rec["data"].numpy() - np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))


def test_scoring_matches_a_fedavg_update_with_the_local_steps(reconstructions):
    """The chosen trial's score is the multi-step cosine distance of the delta, as in
    the JAX package, not a single-step gradient's distance to the delta."""
    (rec, stats), (_, j_stats) = reconstructions["port"], reconstructions["ref"]
    assert abs(stats["opt_value"] - j_stats["opt_value"]) <= 1e-5, (stats["opt_value"], j_stats["opt_value"])
    multi_step, _, _ = _port_objective(reconstructions["run"], "cosine-similarity")(rec["data"].numpy())
    assert abs(stats["opt_value"] - multi_step) <= 1e-6


def test_a_trial_whose_loss_turns_non_finite_keeps_the_candidate_it_stopped_at(convnet, reconstructions):
    """A step whose loss is not finite keeps its candidate, as in the JAX package; a
    trial whose loss ends non-finite leaves that candidate in the stats, and a trial
    whose loss stays finite leaves none."""
    port, _ = convnet
    attacker = copy.copy(port["attacker"])
    attacker.cfg = copy.deepcopy(attacker.cfg)
    attacker.cfg.optim.max_iterations = attacker.cfg.optim.callback = 2
    x = np.random.default_rng(4).normal(size=(4, 3, 16, 16)).astype(np.float32)
    x[1, 2, 3, 4] = np.nan
    _, stats = attacker.reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                    initial_data=torch.from_numpy(x))
    assert len(stats["Trial_0_Val"]) == 2 and np.isnan(stats["Trial_0_Val"]).all()
    torch.testing.assert_close(stats["Trial_0_nonfinite_candidate"], torch.from_numpy(x),
                               rtol=0, atol=0, equal_nan=True)
    assert "Trial_0_nonfinite_candidate" not in reconstructions["port"][1]


def test_restarts_and_fleets_of_fedavg_users_are_refused(convnet):
    port, _ = convnet
    attacker = copy.copy(port["attacker"])
    attacker.cfg = copy.deepcopy(attacker.cfg)
    attacker.cfg.restarts.num_trials = 2
    with pytest.raises(NotImplementedError, match="num_trials=1"):
        attacker.reconstruct(port["payloads"], port["shared"], dryrun=True)
    with pytest.raises(NotImplementedError, match="Fleets of fedAVG users"):
        port["attacker"].reconstruct_fleet([port["payloads"]] * 2, [port["shared"]] * 2, dryrun=True)
    objective = CosineSimilarity()
    objective.initialize(port["loss_fn"], port["model"], dict(lr=0.1, steps=1, data_per_step=1,
                                                              labels=torch.zeros(1, 1, dtype=torch.int64)))
    with pytest.raises(NotImplementedError, match="fedAVG"):
        objective.trials({}, {}, (), torch.zeros(2, 1, 3, 16, 16), torch.zeros(2, 1, dtype=torch.int64))


@pytest.mark.parametrize("overrides", [
    [],  # the case's own defaults: labels left to the attack, one image per local step
    ["case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
     "case.user.provide_labels=True", "case.user.user_idx=1"],  # the notebook preset
], ids=["case-defaults", "notebook-preset"])
def test_entry_point_dry_run_on_the_cpu(overrides, caplog, tmp_path):
    """Case 4 (ResNet-18 on the repo's checkpoint, ImageNetAnimals cut to 32x32)
    through ``main_process``; the report orders the batch of 4."""
    cfg = breaching.get_config(["case=4_fedavg_small_scale", "attack=invertinggradients", "dryrun=True",
                                "case.data.shape=[3, 32, 32]", "case.data.batch_size=4", "seed=7"] + overrides)
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    with caplog.at_level(logging.INFO):
        metrics = main_process(cfg, device="cpu")
    assert "User (of type UserMultiStep)" in caplog.text and "METRICS: | MSE:" in caplog.text
    assert ("through strategy bias-corrected" in caplog.text) == (not overrides)
    assert sorted(metrics["order"].tolist()) == [0, 1, 2, 3]
    assert np.isfinite(metrics["mse"]) and np.isnan(metrics["lpips"]) and metrics["parameters"] == 11_380_173
