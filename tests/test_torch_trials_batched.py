"""The batched trial step on what it took only one trial at a time before, against the
JAX package's vmapped trials, on the CPU: BatchNorm in train mode with DeepInversion, the
feature regularizer (both read the objective's intermediates), the multiscale preset's
augmentation (``continuous_shift``) on the JAX package's own draws, a fedAVG user's
restarts and a fleet of two fedAVG users, and ``grad_accum``.

Both packages build the same case (ConvNet-8 at 3x16x16; the port's model takes the JAX
model's weights through ``load_flat_state``) and run 3 steps of unsigned Adam for 2 trials
(or a fleet of 2 experiments), each trial from its own candidate: the JAX attacker draws
each trial's candidate from its own key inside a vmap, so its ``_initialize_data`` maps
the key to its trial and returns that trial's row of a numpy table, which the port's
``_initialize_data`` returns too. With the augmentation, every trial's draw at every step
is the JAX package's own (``jax.random.uniform`` of the key the JAX attack folds from the
trial's key, the step and the augmentation's place), handed to the port's ``sample`` in
the order the batched step asks for them (step by step, trial by trial).

The feature regularizer runs at scale 1e5: at the preset's 0.1 it adds 1e-8 to a loss
of 0.4 on ConvNet-8, and no comparison would see it.

Tolerance: every loss of every trial 1e-4 relative, as tests/test_torch_attack.py holds
10 unsigned steps (float32 on both sides, sums in other orders) [measured: 1.2e-7
(DeepInversion), 5.8e-6 (features), 6.8e-6 (augmentations), 4.1e-6 and 4.9e-7 (fedAVG
restarts and fleet), 1.7e-5 (grad_accum)]. The trials must differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

torch.set_num_threads(1)
FEDSGD = ["case=1_single_image_small", "attack=invertinggradients", "case.model=ConvNet8",
          "case.data.shape=[3, 16, 16]", "case.user.provide_labels=True", "seed=4"]
FEDAVG = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case/data=CIFAR10", "case.model=ConvNet8",
          "case.data.shape=[3, 16, 16]", "case.data.batch_size=4", "case.user.num_data_points=4",
          "case.user.num_local_updates=3", "case.user.num_data_per_local_update_step=2",
          "case.user.local_learning_rate=0.1", "case.user.provide_labels=True", "seed=8"]
STEPS = ["attack.optim.max_iterations=3", "attack.optim.callback=3", "attack.optim.signed=False"]
SHIFT = {"continuous_shift": {"shift": 4, "padding": "circular"}}
CASES = {
    "bn-train-deep-inversion": (FEDSGD + ["case.server.provide_public_buffers=False",
                                          "attack.regularization.deep_inversion.scale=0.1"], "restarts"),
    "features": (FEDSGD + ["case.user.num_data_points=2", "attack.regularization.features.scale=1e5"],
                 "restarts"),
    "augmentations": (FEDSGD, "restarts"),
    "fedavg-restarts": (FEDAVG, "restarts"),
    "fedavg-fleet": (FEDAVG, "fleet"),
    "grad-accum": (FEDSGD + ["case.user.num_data_points=4", "attack.impl.grad_accum=2"], "restarts"),
}


def _flat(params, buffers):
    flat = {}
    for prefix, tree in (("params/", params), ("buffers/", buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    return flat


def _exchanges(package, overrides, users, weights=None, augmentations=None):
    """One server and model, and ``users`` users' exchanges with it; the attack takes
    ``augmentations`` where given."""
    cfg = package.get_config(overrides)
    setup = package.utils.system_startup(cfg=cfg, device="cpu") if weights is not None \
        else package.utils.system_startup(cfg=cfg)
    user, server, model, _ = package.cases.construct_case(cfg.case, setup)
    if weights is not None:
        load_flat_state(model, weights, strict=True)
    payloads, shared = [], []
    for idx in range(users):
        cfg.case.user.user_idx = idx
        user = package.cases.construct_user(model, server.loss, cfg.case, setup)
        s, p, _ = server.run_protocol(user)
        payloads.append(p)
        shared.append(s)
    if augmentations:
        cfg.attack.augmentations = augmentations
    attacker = package.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    return dict(setup=setup, model=model, attacker=attacker, payloads=payloads, shared=shared)


def _run(case):
    overrides, mode = CASES[case]
    overrides = overrides + STEPS + ["attack.restarts.num_trials=1" if mode == "fleet"
                                     else "attack.restarts.num_trials=2"]
    augmentations = SHIFT if case == "augmentations" else None
    users = 2 if mode == "fleet" else 1
    ref = _exchanges(jax_breaching, overrides, users, augmentations=augmentations)
    port = _exchanges(breaching, overrides, users, weights=_flat(ref["model"].params, ref["model"].buffers),
                      augmentations=augmentations)
    assert bool(port["attacker"].augmentations) == bool(ref["attacker"].augmentations) == (case == "augmentations")
    trials = 2
    num_points = int(ref["shared"][0][0]["metadata"]["num_data_points"])
    x0 = np.random.default_rng(21).normal(size=(trials, num_points, 3, 16, 16)).astype(np.float32)

    # the JAX attack's first split of the setup's key draws the candidates, the second
    # the trials' keys of the augmentations (breaching_tpu.utils.split_key)
    k0 = ref["setup"]["key"]
    k1, init_key = jax.random.split(k0)
    _, noise_key = jax.random.split(k1)
    init_keys = jax.random.split(init_key, trials)
    table = jnp.asarray(np.transpose(x0, (0, 1, 3, 4, 2)))
    ref["attacker"]._initialize_data = lambda shape, key: table[jnp.argmax(jnp.all(init_keys == key, axis=-1))]
    port["attacker"]._initialize_data = lambda shape: torch.from_numpy(x0.reshape(shape))
    if case == "augmentations":
        trial_keys = jax.random.split(noise_key, trials)
        draws = [torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(trial_keys[t], i), 0), (num_points, 4))))
            for i in range(3) for t in range(trials)]
        port["attacker"].augmentations[0].sample = lambda shape, generator: draws.pop(0)

    if mode == "fleet":
        _, j_stats = ref["attacker"].reconstruct_fleet(ref["payloads"], ref["shared"])
        _, stats = port["attacker"].reconstruct_fleet(port["payloads"], port["shared"])
    else:
        _, j_stats = ref["attacker"].reconstruct(ref["payloads"][0], ref["shared"][0])
        _, stats = port["attacker"].reconstruct(port["payloads"][0], port["shared"][0])
    return port, stats, j_stats


@pytest.mark.parametrize("case", list(CASES))
def test_trials_losses_match_the_jax_packages_vmapped_trials(case):
    port, stats, j_stats = _run(case)
    for t in range(2):
        got, want = np.asarray(stats[f"Trial_{t}_Val"]), np.asarray(j_stats[f"Trial_{t}_Val"])
        assert len(got) == len(want) == 3 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert stats["Trial_0_Val"] != stats["Trial_1_Val"]
    # each ran through the batched step: one evaluation per trial and step
    assert stats["objective_evaluations"] == 6
