"""The port's multi-device layer (``breaching_tpu_torch/parallel``, ``attack.impl.sharding``,
the silo over ranks) against the JAX package's, which runs on its 8 virtual CPU devices in
this process. The ranks are 4 spawned processes of one gloo process group on the CPU
(``parallel.dryrun.run_ranks``, rendezvous through a ``FileStore`` under ``tmp_path``), one
spawn for the whole file; each rank runs the functions of ``parallel.dryrun`` and returns
its results here.

- mesh shapes: ``make_mesh`` and ``make_attack_mesh`` for n = 1..8, every trial count 1..8
  and each mode, equal to the JAX package's;
- ``params_partition_specs`` on ConvNet-8 and ResNet-20 at model axes of 2 and 4: the same
  leaves sharded as the JAX rule shards, on the same logical axis, through the bridge;
- ``sharded_user_aggregate`` (ConvNetSmall16 at 3x8x8, 8 users x 2 on a 2 x 2 mesh) against
  the JAX function on 8 devices and against the sequential mean, to 1e-6 of the largest
  entry (float32 sums of the users in other orders);
- the production attack (``dryrun_multichip``'s case: ConvNetSmall16 at 3x16x16, 6
  unsigned Adam steps, seed 11) over the 4 ranks against solo: "restarts" on 4 trials
  (4 x 1), on 3 trials (1 x 1, ranks 1-3 idle) and on 2 L-BFGS trials run one after the
  other (2 x 1, ranks 2-3 idle; 2 outer steps), "batch" and "experimental-2d" (also with
  the fused cosine objective) on 2 trials of 2 images (2 x 2; "experimental-2d" runs the
  trials over ``restarts``, each line of the model axis the same trials), at
  ``dryrun_multichip``'s tolerances: every trial's losses
  at rtol 1e-5 (atol 1e-6 for "restarts", 2e-5 for the others, whose sums run in other
  orders), the selected value at rtol 1e-4, the pixels at rtol 1e-3 (atol 1e-4, 5e-3);
  every rank returns the same reconstruction;
- ``dryrun_multichip``'s rank function, whose own asserts run on each of the 4 ranks;
- two attacks in one process run on one mesh and its process groups (no groups per attack);
- ``sharded_attack_step`` on 4 trials over 2 x 2, 1 x 4 and 4 x 1 meshes against the same
  step on all 4 trials in this process (no process group): 3 steps' values at rtol 1e-5,
  the candidates at rtol 1e-5 (atol 1e-6), and Adam's first moment after the first step,
  (1 - beta1) times the attack gradient, to 1e-6 of the largest entry of the autograd
  gradient of the objective (float32 convolutions over stacks of other sizes);
- each rank's "batch" attack gradient (4 images on a 1 x 4 mesh) against its slice of the
  solo gradient at the same candidate, to 1e-6 of the largest entry: the mean's backward
  is the cotangent / m, not a second all-reduce (which would make it 4 times too large);
- the "batch" refusals in the JAX package's words (``tests/test_parallel.py``), at the same
  model axis of 2, and an unknown mode's ValueError;
- case 8's single-step silo of 8 users over the 4 ranks against the mean of the 8 users'
  own gradients (rtol 2e-5, atol 2e-6, as ``tests/test_attack_matrix_holes.py``);
- the port's solo attack on the dryrun's case (one trial) against the JAX package's on the
  same weights and initial candidate: the losses of 6 unsigned Adam steps at rtol 1e-4 (the
  baseline of ``tests/test_torch_attack.py``, which measured 3e-6 on ConvNet-8).
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, dump_flat_state, load_flat_state
from breaching_tpu_torch.parallel import mesh as port_mesh
from breaching_tpu_torch.parallel.dryrun import BATCH_OVERRIDES, OVERRIDES, run_each, run_ranks, step_inputs

torch.set_num_threads(1)
RANKS = 4
BATCH = OVERRIDES + BATCH_OVERRIDES + ["attack.restarts.num_trials=2"]
THREE = OVERRIDES + ["attack.restarts.num_trials=3"]
GRADIENT = OVERRIDES + ["case.user.num_data_points=4", "case.data.batch_size=4", "attack.restarts.num_trials=1"]
SILO = ["case=8_industry_scale_fl", "attack=invertinggradients", "case/data=CIFAR10", "case.model=ConvNetSmall16",
        "case.data.shape=[3, 16, 16]", "case.data.default_clients=16", "case.user.user_range=[0, 8]",
        "case.user.num_data_points=1", "case.user.provide_labels=True", "seed=6"]
REFUSALS = {
    "lbfgs": (["attack.optim.optimizer=L-BFGS", "case.user.num_data_points=2", "case.data.batch_size=2"], "batch"),
    "indivisible": (["case.user.num_data_points=1"], "batch"),
    "unknown": ([], "bogus"),
}
CFG_DATA = dict(name="CIFAR10", modality="vision", task="classification", classes=10, shape=[3, 8, 8],
                normalize=True, mean=[0.5] * 3, std=[0.25] * 3, path="~/x", size=100,
                examples_from_split="validation", partition="none", default_clients=1, batch_size=4, caching=False)
USERS, PER_USER = 8, 2
FUSED = ["attack.objective.type=fused-cosine-similarity"]
STEP_MESHES = [(2, 2), (1, 4), (4, 1)]
LBFGS = OVERRIDES + ["attack.optim.optimizer=L-BFGS", "attack.restarts.num_trials=2", "attack.optim.max_iterations=2",
                     "attack.optim.callback=1"]
# name -> (overrides, mode, the mesh); each against solo on the same overrides
ATTACKS = {"restarts": (OVERRIDES, "restarts", (4, 1)), "restarts idle": (THREE, "restarts", (1, 1)),
           "restarts one by one": (LBFGS, "restarts", (2, 1)), "batch": (BATCH, "batch", (2, 2)),
           "experimental-2d": (BATCH, "experimental-2d", (2, 2)),
           "experimental-2d fused": (BATCH + FUSED, "experimental-2d", (2, 2))}


def _aggregate_inputs():
    rng = np.random.default_rng(1)
    inputs = rng.normal(size=(USERS, PER_USER, 3, 8, 8)).astype(np.float32)
    labels = rng.integers(0, 10, size=(USERS, PER_USER))
    return inputs, labels


def _aggregate_state():
    """ConvNetSmall16's weights drawn by the port from seed 0, in the flat layout: both
    packages load them, and no JAX computation runs before the ranks start."""
    model, _ = breaching.cases.construct_model("ConvNetSmall16", breaching.ConfigNode(**CFG_DATA),
                                               generator=torch.Generator().manual_seed(0))
    return dump_flat_state(model)


def _jax_aggregate_model():
    from breaching_tpu.config.loader import ConfigNode

    model, loss_fn = jax_breaching.cases.construct_model("ConvNetSmall16", ConfigNode(**CFG_DATA),
                                                         key=jax.random.PRNGKey(0))
    params = {}
    for key, value in _aggregate_state().items():
        node = params
        *path, leaf = key.split("/")[1:]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = jax.numpy.asarray(value)
    model.params = params
    return model, loss_fn


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Every rank's results of every call, one spawn of 4 ranks for the file, started before
    this process runs any JAX computation (whose thread pools slow the ranks' start)."""
    state = _aggregate_state()
    inputs, labels = _aggregate_inputs()
    calls = {}
    for name, (overrides, mode, _) in ATTACKS.items():
        calls[f"attack {name}"] = ("attack_run", (overrides, mode))
        calls[f"solo {name}"] = ("attack_run", (overrides, None))
    calls.update({"gradient": ("batch_gradient", (GRADIENT,)), "silo": ("silo_run", (SILO,)),
                  "dryrun": ("_dryrun_rank", (RANKS,)), "reuse": ("mesh_reuse", (BATCH, "batch")),
                  "aggregate": ("aggregate_run", ("ConvNetSmall16", CFG_DATA, state, inputs, labels))})
    calls.update({f"step {mesh}": ("attack_step_run", ("ConvNetSmall16", CFG_DATA, *mesh)) for mesh in STEP_MESHES})
    calls.update({f"refusal {name}": ("refusal", (OVERRIDES + extra + ["attack.restarts.num_trials=2"], mode))
                  for name, (extra, mode) in REFUSALS.items()})
    # the ranks run a function of the port (a spawned rank imports the module of its function)
    results = run_ranks(RANKS, run_each, list(calls.values()), workdir=str(tmp_path_factory.mktemp("ranks")))
    return [dict(zip(calls, result)) for result in results]


def _flat(tree):
    """A JAX pytree of arrays as the flat layout's ``params/a/b`` keys."""
    return {"params/" + "/".join(str(p.key) for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_equal_the_jax_meshes(n):
    from breaching_tpu.parallel import make_attack_mesh, make_mesh

    jax_shape = make_mesh(n).shape
    assert port_mesh.mesh_shape(n) == (jax_shape["restarts"], jax_shape["model"])
    for trials in range(1, 9):
        for mode in ("restarts", "batch", "2d", "model", "experimental-2d"):
            want = make_attack_mesh(trials, mode, n).shape
            assert port_mesh.attack_mesh_shape(n, trials, mode) == (want["restarts"], want["model"]), (trials, mode)


@functools.cache
def _jax_model(name):
    return jax_breaching.cases.construct_model(name, jax_breaching.get_config(
        ["case=1_single_image_small", f"case.model={name}"]).case.data, key=jax.random.PRNGKey(0))[0]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", ["ConvNet8", "resnet20"])
def test_partition_specs_shard_the_leaves_the_jax_rule_shards(name, size):
    from jax.sharding import Mesh

    from breaching_tpu.parallel import params_partition_specs

    cfg = breaching.get_config(["case=1_single_image_small", f"case.model={name}"])
    jax_model = _jax_model(name)
    mesh = Mesh(np.asarray(jax.devices()[:size]).reshape(1, size), ("restarts", "model"))
    specs_tree = params_partition_specs(jax_model.params, mesh)
    flat_specs = {"params/" + "/".join(str(p.key) for p in path): tuple(spec) for path, spec in
                  jax.tree_util.tree_flatten_with_path(
                      specs_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    flat_shapes = {key: leaf.shape for key, leaf in _flat(jax_model.params).items()}
    model, _ = breaching.cases.construct_model(name, cfg.case.data)
    specs = port_mesh.params_partition_specs(model, types.SimpleNamespace(shape=dict(restarts=1, model=size)))
    names = {id(p): n for n, p in model.named_parameters()}
    seen = 0
    for key, tensor, _ in _flat_entries(model):
        if id(tensor) not in names:
            continue
        spec, want = specs[names[id(tensor)]], flat_specs[key]
        assert ("model" in spec) == ("model" in want), key
        if "model" in spec:  # the same logical axis: the JAX leaf's last
            assert tensor.shape[spec.index("model")] == flat_shapes[key][-1], key
        seen += 1
    assert seen == len(flat_specs) and any("model" in s for s in specs.values())


def test_user_aggregate_equals_the_jax_function_and_the_sequential_mean(ranks):
    from breaching_tpu.parallel import make_mesh, sharded_user_aggregate

    model, loss_fn = _jax_aggregate_model()
    inputs, labels = _aggregate_inputs()
    want = _flat(sharded_user_aggregate(model, loss_fn, make_mesh(8), np.transpose(inputs, (0, 1, 3, 4, 2)),
                                        labels))
    got = ranks[0]["aggregate"]["gradients"]
    assert ranks[0]["aggregate"]["mesh"] == dict(restarts=2, model=2)
    port, port_loss = breaching.cases.construct_model("ConvNetSmall16", breaching.ConfigNode(**CFG_DATA))
    load_flat_state(port, _aggregate_state(), strict=True)
    names = {id(p): n for n, p in port.named_parameters()}
    compared = 0
    for key, tensor, transform in _flat_entries(port):
        if id(tensor) in names:
            expected = transform(want[key]) if transform is not None else want[key]
            np.testing.assert_allclose(got[names[id(tensor)]], expected, rtol=0,
                                       atol=1e-6 * np.abs(expected).max(), err_msg=key)
            compared += 1
    assert compared == len(want) == len(got)
    sequential = None
    for x, y in zip(torch.as_tensor(inputs), torch.as_tensor(labels)):
        grads = torch.autograd.grad(port_loss(port(x), y), tuple(port.parameters()))
        sequential = list(grads) if sequential is None else [a + b for a, b in zip(sequential, grads)]
    for (name, _), total in zip(port.named_parameters(), sequential):
        mean = total.numpy() / USERS
        np.testing.assert_allclose(got[name], mean, rtol=0, atol=1e-6 * np.abs(mean).max(), err_msg=name)
    for rank in ranks[1:]:
        for name, value in rank["aggregate"]["gradients"].items():
            np.testing.assert_array_equal(value, got[name])


@pytest.mark.parametrize("name", list(ATTACKS))
def test_sharded_attack_matches_solo(ranks, name):
    tight = name.startswith("restarts")
    atol, data_atol = (1e-6, 1e-4) if tight else (2e-5, 5e-3)
    for rank in ranks:
        got, solo = rank[f"attack {name}"], rank[f"solo {name}"]
        assert set(got["trials"]) == set(solo["trials"])
        for key in solo["trials"]:
            np.testing.assert_allclose(got["trials"][key], solo["trials"][key], rtol=1e-5, atol=atol, err_msg=key)
        np.testing.assert_allclose(got["opt_value"], solo["opt_value"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["data"], solo["data"], rtol=1e-3, atol=data_atol)
        np.testing.assert_array_equal(got["data"], ranks[0][f"attack {name}"]["data"])
    parts = [rank[f"attack {name}"]["part"] for rank in ranks]
    mode, (restarts, model) = ATTACKS[name][1:]
    assert all(part["mesh"] == dict(restarts=restarts, model=model) and part["mode"] == mode for part in parts)
    assert [part["idle"] for part in parts] == [rank >= restarts * model for rank in range(RANKS)]
    if name == "batch":
        assert [part["images"] for part in parts] == [(0, 1), (1, 2), (0, 1), (1, 2)]


def test_dryrun_multichip_asserts_hold_on_every_rank(ranks):
    """``parallel.dryrun.dryrun_multichip``'s rank function: its own asserts passed on every
    rank (the JAX package's 4 trials for "restarts", n / 2 = 2 for the others)."""
    for rank in ranks:
        modes = [part["mode"] for part in rank["dryrun"]["parts"]]
        assert modes == ["restarts", "batch", "experimental-2d"]
        assert rank["dryrun"]["restarts"] == ranks[0]["dryrun"]["restarts"]


def test_each_ranks_batch_gradient_is_its_slice_of_solos(ranks):
    images = [rank["gradient"]["images"] for rank in ranks]
    assert images == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for rank in ranks:
        solo = rank["gradient"]["solo"]
        start, stop = rank["gradient"]["images"]
        np.testing.assert_allclose(rank["gradient"]["grad"], solo[start:stop], rtol=0, atol=1e-6 * np.abs(solo).max())
        np.testing.assert_array_equal(solo, ranks[0]["gradient"]["solo"])


@pytest.fixture(scope="module")
def jax_refusals():
    """The JAX package's words for the same refusals at a model axis of 2 (4 trials on its
    8 devices)."""
    words = {}
    for name, (extra, mode) in REFUSALS.items():
        cfg = jax_breaching.get_config(OVERRIDES + extra)
        cfg.attack.impl.sharding = mode
        setup = jax_breaching.utils.system_startup(cfg=cfg)
        user, server, _, _ = jax_breaching.cases.construct_case(cfg.case, setup)
        shared, payloads, _ = server.run_protocol(user)
        attacker = jax_breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        with pytest.raises(ValueError) as error:
            attacker.reconstruct(payloads, shared, server.secrets)
        words[name] = str(error.value)
    return words


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_use_the_jax_words(ranks, jax_refusals, name):
    assert jax.device_count() == 8
    for rank in ranks:
        assert rank[f"refusal {name}"] == jax_refusals[name]


def test_silo_over_ranks_equals_the_sequential_mean(ranks):
    from breaching_tpu_torch.cases.users import UserSingleStep

    cfg = breaching.get_config(SILO)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    payload = server.distribute_payload()
    total = None
    for idx, loader in zip(user.user_indices, user.dataloaders):
        single = UserSingleStep(user.model, user.loss, loader, setup, idx, cfg.case.user)
        grads = single.compute_local_updates(payload)[0]["gradients"]
        total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
    for rank in ranks:
        assert rank["silo"]["world"][1] == RANKS and rank["silo"]["backend"] == "gloo"
        for name, value in rank["silo"]["gradients"].items():
            np.testing.assert_allclose(value, total[name].numpy() / 8, rtol=2e-5, atol=2e-6, err_msg=name)


def test_port_solo_matches_the_jax_solo_attack():
    overrides = OVERRIDES + ["attack.restarts.num_trials=1"]
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    load_flat_state(model, _flat(j_model.params), strict=True)
    x = np.random.default_rng(3).normal(size=(1, 3, 16, 16)).astype(np.float32)
    shared, payloads, _ = server.run_protocol(user)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    _, stats = attacker.reconstruct(payloads, shared, server.secrets, initial_data=torch.from_numpy(x))
    _, j_stats = j_attacker.reconstruct(j_payloads, j_shared, j_server.secrets,
                                        initial_data=np.transpose(x, (0, 2, 3, 1)))
    assert len(stats["Trial_0_Val"]) == 6
    np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-4)


def test_two_attacks_in_one_process_share_one_mesh(ranks):
    for rank in ranks:
        assert rank["reuse"] == dict(same_mesh=True, same_groups=True, mesh=dict(restarts=2, model=2))


@functools.cache
def _solo_step():
    """``sharded_attack_step`` on all 4 trials without a process group (the 1 x 1 mesh), and
    the autograd gradient of the objective at the first candidates."""
    model, loss_fn, params, objective, target, labels, candidates = step_inputs("ConvNetSmall16", CFG_DATA)
    x = candidates.clone().requires_grad_(True)
    trials = x.shape[0]
    values, _ = objective.trials(params, {}, tuple(t.expand(trials, *t.shape) for t in target), x,
                                labels.expand(trials, *labels.shape))
    grad, = torch.autograd.grad(values.sum(), x)
    mesh = port_mesh.make_mesh()
    step, _ = port_mesh.sharded_attack_step(model, loss_fn, objective, mesh, params)
    assert mesh.shape == dict(restarts=1, model=1)
    state, steps = step.init_state(candidates), []
    for _ in range(3):
        candidates, state, value = step(candidates, state, params, {}, target, labels)
        steps.append(value.numpy())
    return dict(values=np.stack(steps), candidates=candidates.numpy(), grad=grad.numpy())


@pytest.mark.parametrize("mesh", STEP_MESHES, ids=lambda mesh: f"{mesh[0]}x{mesh[1]}")
def test_sharded_attack_step_matches_the_unsharded_step(ranks, mesh):
    solo = _solo_step()
    restarts, model = mesh
    for index, rank in enumerate(ranks):
        got = rank[f"step {mesh}"]
        start, stop = got["trials"]
        assert (start, stop) == (index // model * (4 // restarts), (index // model + 1) * (4 // restarts))
        np.testing.assert_allclose(got["values"], solo["values"][:, start:stop], rtol=1e-5)
        np.testing.assert_allclose(got["candidates"], solo["candidates"][start:stop], rtol=1e-5, atol=1e-6)
        want = (1 - 0.9) * solo["grad"][start:stop]
        np.testing.assert_allclose(got["first_moment"], want, rtol=0, atol=1e-6 * np.abs(want).max())
        assert got["sharded"] == ranks[0][f"step {mesh}"]["sharded"]
    assert ranks[0][f"step {mesh}"]["sharded"]  # the specs name the leaves the JAX package places by them
