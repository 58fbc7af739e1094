"""The production attack over ranks against solo (counterpart of ``__graft_entry__.py``
``dryrun_multichip``), and the functions each rank runs in the multi-device checks.

``run_ranks(n, fn, *args)`` spawns n ranks, joins them into one process group through a
``FileStore`` in a scratch directory (no TCP port to race for), runs ``fn(*args,
device=...)`` on each and returns their results in rank order; a rank that fails fails
the call with its traceback. Kernels are built in the caller before the ranks start, so
that no two ranks run ``nvcc`` into one directory. The rank functions live here, in a
module that imports no JAX: a spawned rank imports the module of the function it runs.

    python3 -m breaching_tpu_torch.parallel.dryrun [N] [--device cuda]

runs ``dryrun_multichip(N)``: ConvNetSmall16 at 3x16x16, 6 unsigned Adam steps, seed 11,
solo and in every ``attack.impl.sharding`` mode, asserted as ``dryrun_multichip`` asserts.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

from . import _dist

OVERRIDES = [
    "case=1_single_image_small", "attack=invertinggradients",
    "case.model=ConvNetSmall16", "case.data.shape=[3,16,16]",
    "attack.optim.max_iterations=6", "attack.optim.callback=3",
    "attack.restarts.num_trials=4", "case.user.provide_labels=True",
    # unsigned updates: a sign turns reduction-order noise across ranks into sign flips
    "attack.optim.signed=False",
    "seed=11", "name=dryrun", "dryrun=False",
]
BATCH_OVERRIDES = ["case.user.num_data_points=2", "case.data.batch_size=2"]


def _rank_entry(rank, world_size, workdir, device):
    torch.set_num_threads(1)
    outcome = {}
    try:
        with open(os.path.join(workdir, "call.pkl"), "rb") as fh:
            fn, args = pickle.load(fh)
        store = torch.distributed.FileStore(os.path.join(workdir, "store"), world_size)
        device = _dist.start(torch.device(device), rank, world_size, store=store)
        outcome["result"] = fn(*args, device=device)
    except BaseException:  # noqa: BLE001 (the traceback goes to the caller, which raises it)
        outcome["error"] = traceback.format_exc()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(outcome, fh)


def run_ranks(n: int, fn, *args, device: str = "cpu", timeout: float = 600.0, workdir: str | None = None) -> list:
    """``fn(*args, device=...)`` on each of n spawned ranks of one process group; their
    results in rank order. Raises RuntimeError with a failed rank's traceback, and
    TimeoutError (every rank stopped) where they outlast ``timeout`` seconds."""
    if torch.device(device).type == "cuda":
        from ..ops import _build

        _build.load_ops()
    context = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        # the call goes through a file: a spawned process's arguments go through a pipe that
        # blocks its start until the process has booted and read them
        with open(os.path.join(tmp, "call.pkl"), "wb") as fh:
            pickle.dump((fn, args), fh)
        ranks = [context.Process(target=_rank_entry, args=(rank, n, tmp, device)) for rank in range(n)]
        for process in ranks:
            process.start()
        deadline = time.monotonic() + timeout
        try:
            for process in ranks:
                process.join(max(deadline - time.monotonic(), 0.0))
            if any(process.is_alive() for process in ranks):
                raise TimeoutError(f"{n} ranks of {fn.__name__} did not end within {timeout} s.")
        finally:
            for process in ranks:
                if process.is_alive():
                    process.kill()
                    process.join()
        outcomes = []
        for rank in range(n):
            path = os.path.join(tmp, f"rank{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"Rank {rank} of {fn.__name__} ended without a result "
                                   f"(exit code {ranks[rank].exitcode}).")
            with open(path, "rb") as fh:
                outcomes.append(pickle.load(fh))
    for rank, outcome in enumerate(outcomes):
        if "error" in outcome:
            raise RuntimeError(f"Rank {rank} of {fn.__name__} failed:\n{outcome['error']}")
    return [outcome["result"] for outcome in outcomes]


def _case(overrides, device):
    import breaching_tpu_torch as breaching

    cfg = breaching.get_config(list(overrides))
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    return breaching, cfg, setup, user, server


def attack_run(overrides, mode=None, warmup=False, device="cpu") -> dict:
    """The exchange and the production attack of ``overrides`` with
    ``attack.impl.sharding=mode``: the reconstruction, every trial's losses, the selected
    value, the kernels' launches during the attack, its seconds, and the rank's trials and
    images. With ``warmup`` a dry run of the attack (one step) goes first, so that the
    seconds are the steps' and not a new process's first calls."""
    from .. import ops

    breaching, cfg, setup, user, server = _case(overrides, device)
    cfg.attack.impl.sharding = mode
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    if warmup:
        attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)
    ops.reset_launch_counts()
    start = time.perf_counter()
    rec, stats = attacker.reconstruct(payloads, shared, server.secrets)
    if setup["device"].type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    shards = attacker._shards
    return dict(data=rec["data"].detach().cpu().numpy(), seconds=seconds, launches=ops.launch_counts(),
                trials={k: v for k, v in stats.items() if k.startswith("Trial_") and k.endswith("_Val")},
                opt_value=stats["opt_value"], backend=_dist.backend(), world=_dist.world(),
                part=None if shards is None else dict(mode=shards.mode, mesh=shards.mesh.shape, trials=(
                    shards.lo, shards.hi), images=(shards.start, shards.start + shards.length), idle=shards.idle))


def batch_gradient(overrides, device="cpu") -> dict:
    """The batch-sharded attack gradient of this rank's images at the initial candidate
    (objective and regularizers through ``attack.impl.sharding="batch"``'s means), beside
    the solo gradient of the whole batch at the same candidate."""
    from ..attacks.sharding import AttackShards
    from .mesh import make_attack_mesh

    breaching, cfg, setup, user, server = _case(overrides, device)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    rec_models, labels, stats = attacker.prepare_attack(payloads, shared)
    targets = [tuple(d["gradients"][k] for k in model.params) for d, model in zip(attacker._shared_data_cache,
                                                                                  rec_models)]
    attacker.objective.initialize(attacker.loss_fn, rec_models[0].module, None, cfg.attack.impl)
    for reg in attacker.regularizers:
        reg.initialize(rec_models, attacker._shared_data_cache, labels)
    num_points = labels.shape[0]
    candidate = attacker._init_candidate_tree(1, num_points)["data"][0]
    solo = attacker._value_and_grad(dict(data=candidate), rec_models, targets, labels, stats)[2]["data"]
    mesh = make_attack_mesh(1, "model")
    shards = attacker._shards = AttackShards("batch", mesh, 1, num_points)
    attacker.objective.shard_batch(shards.model_group, shards.m)
    value, _, grads = attacker._value_and_grad(dict(data=shards.batch_part(candidate)), rec_models, targets,
                                               shards.batch_part(labels), stats)
    return dict(grad=grads["data"].cpu().numpy(), solo=solo.cpu().numpy(), images=(shards.start, shards.start
                                                                                    + shards.length),
                value=float(value))


def silo_run(overrides, device="cpu") -> dict:
    """The single-step silo's shared aggregate of ``overrides`` by name, and the users' true
    images and labels."""
    breaching, cfg, setup, user, server = _case(overrides, device)
    shared, true = user.compute_local_updates(server.distribute_payload())
    return dict(gradients={k: v.cpu().numpy() for k, v in shared["gradients"].items()},
                true=dict(data=true["data"].cpu().numpy(), labels=true["labels"].cpu().numpy()),
                world=_dist.world(), backend=_dist.backend())


def aggregate_run(name, cfg_data, state, inputs, labels, device="cpu") -> dict:
    """``sharded_user_aggregate`` over ``make_mesh()`` of the world on the model ``name`` of
    the data config ``cfg_data`` (a dict) holding ``state`` (the flat layout's arrays,
    through the weight bridge); ``inputs`` (U, B, C, H, W) and ``labels`` (U, B) as numpy."""
    import breaching_tpu_torch as breaching
    from ..cases.models.model_preparation import load_flat_state
    from .federated import sharded_user_aggregate
    from .mesh import make_mesh

    model, loss_fn = breaching.cases.construct_model(name, breaching.ConfigNode(**cfg_data))
    load_flat_state(model, state, strict=True)
    model.to(device)
    mesh = make_mesh()
    grads = sharded_user_aggregate(model, loss_fn, mesh, torch.as_tensor(inputs, device=device),
                                   torch.as_tensor(labels, device=device))
    return dict(gradients={k: v.cpu().numpy() for k, v in grads.items()}, mesh=mesh.shape)


def step_inputs(name, cfg_data, trials=4, images=2):
    """The model ``name`` of the data config ``cfg_data`` drawn from seed 0, its parameters,
    the Euclidean objective, the target gradient of ``images`` seeded images, their labels
    and a (trials, images, C, H, W) stack of seeded candidates: ``sharded_attack_step``'s
    inputs, the same in every process."""
    import breaching_tpu_torch as breaching
    from ..attacks.auxiliaries.objectives import Euclidean

    model, loss_fn = breaching.cases.construct_model(name, breaching.ConfigNode(**cfg_data),
                                                     generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.named_parameters()}
    labels = torch.arange(images) % int(cfg_data["classes"])
    x_true = torch.randn(images, *cfg_data["shape"], generator=torch.Generator().manual_seed(1))
    target = torch.autograd.grad(loss_fn(model(x_true), labels), tuple(model.parameters()))
    objective = Euclidean()
    objective.initialize(loss_fn, model)
    candidates = torch.randn(trials, images, *cfg_data["shape"], generator=torch.Generator().manual_seed(2))
    return model, loss_fn, params, objective, target, labels, candidates


def attack_step_run(name, cfg_data, restarts, model_axis, steps=3, device="cpu") -> dict:
    """``sharded_attack_step`` on this rank's trials of a ``restarts`` x ``model_axis`` mesh
    (``step_inputs``' 4 trials): every step's values, the candidates after ``steps`` steps,
    and Adam's first moment after the first step, (1 - beta1) times the attack gradient."""
    from .mesh import mesh_of, sharded_attack_step

    model, loss_fn, params, objective, target, labels, candidates = step_inputs(name, cfg_data)
    mesh = mesh_of(restarts, model_axis)
    start, count = mesh.part("restarts", candidates.shape[0])
    mine = candidates[start:start + count].clone()
    step, specs = sharded_attack_step(model, loss_fn, objective, mesh, params)
    state = step.init_state(mine)
    values, first_moment = [], None
    for _ in range(steps):
        mine, state, value = step(mine, state, params, {}, target, labels)
        values.append(value.numpy())
        if first_moment is None:
            first_moment = state["mu"].clone().numpy()
    return dict(trials=(start, start + count), values=np.stack(values), candidates=mine.numpy(),
                first_moment=first_moment, sharded=sorted(k for k, spec in specs.items() if "model" in spec))


def mesh_reuse(overrides, mode, device="cpu") -> dict:
    """Two attacks of ``overrides`` under ``attack.impl.sharding=mode`` in this process (a
    dry run each): whether the second ran on the first's mesh and its process groups."""
    meshes = []
    for _ in range(2):
        breaching, cfg, setup, user, server = _case(overrides, device)
        cfg.attack.impl.sharding = mode
        shared, payloads, _ = server.run_protocol(user)
        attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)
        meshes.append(attacker._shards.mesh)
    first, second = meshes
    return dict(same_mesh=first is second, same_groups=all(
        first.group(axis) is second.group(axis) for axis in ("restarts", "model")) and first.active is second.active,
        mesh=first.shape)


def refusal(overrides, mode, device="cpu") -> str | None:
    """The ValueError's words where ``attack.impl.sharding=mode`` refuses the attack of
    ``overrides`` (a dry run), else None."""
    breaching, cfg, setup, user, server = _case(overrides, device)
    cfg.attack.impl.sharding = mode
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    try:
        attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)
    except ValueError as error:
        return str(error)
    return None


def run_each(calls, device="cpu") -> list:
    """The results of ``calls``, (name of a function of this module, args), in order."""
    return [globals()[name](*args, device=device) for name, args in calls]


def _assert_tight(shard, solo, label, num_trials, atol=1e-6, data_atol=1e-4):
    for t in range(num_trials):
        np.testing.assert_allclose(shard["trials"][f"Trial_{t}_Val"], solo["trials"][f"Trial_{t}_Val"], rtol=1e-5,
                                   atol=atol, err_msg=f"{label} trial {t} trajectory diverged from solo")
    np.testing.assert_allclose(shard["opt_value"], solo["opt_value"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(shard["data"], solo["data"], rtol=1e-3, atol=data_atol)


def _dryrun_rank(n, device="cpu"):
    """Every rank runs solo and each mode and asserts as ``dryrun_multichip`` does; the batch
    and 2d runs take n / 2 trials, so that the mesh has a model axis of 2 (the JAX
    package's 4 trials on 8 devices)."""
    solo = attack_run(OVERRIDES, None, device=device)
    restarts = attack_run(OVERRIDES, "restarts", device=device)
    _assert_tight(restarts, solo, "restarts-sharded", 4)
    trials = max(n // 2, 1)
    batch_over = OVERRIDES + BATCH_OVERRIDES + [f"attack.restarts.num_trials={trials}"]
    bsolo = attack_run(batch_over, None, device=device)
    batch = attack_run(batch_over, "batch", device=device)
    _assert_tight(batch, bsolo, "batch-sharded", trials, atol=2e-5, data_atol=5e-3)
    two_d = attack_run(batch_over, "experimental-2d", device=device)
    _assert_tight(two_d, bsolo, "experimental-2d", trials, atol=2e-5, data_atol=5e-3)
    return dict(restarts=restarts["opt_value"], batch=batch["opt_value"], two_d=two_d["opt_value"],
                parts=[run["part"] for run in (restarts, batch, two_d)])


def dryrun_multichip(n_devices: int, device: str = "cpu") -> list:
    """The production attack on ``n_devices`` ranks in every ``attack.impl.sharding`` mode
    against solo: "restarts" on 4 trials at rtol 1e-5 on every trial's losses (atol
    1e-6), "batch" and "experimental-2d" on 2 images at rtol 1e-5 (atol 2e-5; 5e-3 on
    the pixels, where Adam's normalization amplifies reduction-order noise at pixels of
    nearly zero gradient). Returns each rank's summary."""
    results = run_ranks(n_devices, _dryrun_rank, n_devices, device=device)
    print(f"dryrun_multichip OK on {n_devices} ranks: the production attack matches solo for 'restarts' "
          f"(opt_value {results[0]['restarts']:.6f}), 'batch' (opt_value {results[0]['batch']:.6f}) and "
          f"'experimental-2d' (opt_value {results[0]['two_d']:.6f}) at rtol 1e-5.", flush=True)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=2)
    parser.add_argument("--device", default="cpu")
    options = parser.parse_args()
    dryrun_multichip(options.n, options.device)
