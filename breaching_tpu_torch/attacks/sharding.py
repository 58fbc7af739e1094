"""``attack.impl.sharding``: the optimization attack over the ranks of a mesh (counterpart of
``breaching_tpu/attacks/optimization_based_attack.py`` ``_shard_attack_state``).

Every rank builds the same case and draws the whole candidate tree, every trial's
augmentation generators and the Langevin noise as the solo run draws them, then keeps
its slice, so that a rank's trials are the solo run's. The modes, on the mesh of
``parallel.make_attack_mesh``:

- ``"restarts"``: rank (i, 0) runs trials i of the restarts axis through the solo program
  (the batched trial step where solo takes it, else the trials one after the other);
- ``"batch"``: trials over ``restarts`` and the candidate batch over ``model``; the
  objective averages its user gradient and task loss over ``model`` (the task loss is a
  batch mean over equal micro-batches), and so do the regularizers of the candidate
  alone, all batch means; a clip norm is summed over ``model``. It refuses what it cannot
  reproduce, in the JAX package's words (``batch_problems``);
- ``"experimental-2d"`` (formerly ``"2d"``/``"model"``): the mesh of the JAX mode, with
  its model axis, and the trials over ``restarts`` as ``"restarts"`` runs them; the ranks
  of one line of the model axis run the same trials. The JAX package shards the
  parameters and the target gradient over ``model`` by GSPMD and matches solo only
  loosely (rtol 0.15 in ``dryrun_multichip``); here every rank keeps them whole, which
  computes the solo function and saves no memory.

A model axis of 1 runs ``"restarts"``. At the end the best iterates, their values and each
trial's loss history are gathered to every rank (``_dist.gather``), idle ranks included;
the run stops where no trial of any rank has a finite loss, as solo does. Trials that
run one after the other under ``"restarts"`` draw their Langevin noise from the rank's own
generator, trial after trial: with ``optim.langevin_noise`` they are not solo's draws.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..parallel import _dist, make_attack_mesh

log = logging.getLogger(__name__)


def resolve_mode(mode: str) -> str:
    """The mode's current name; the JAX package's warning for the renamed ones, its
    ValueError for an unknown one."""
    if mode in ("2d", "model"):
        log.warning(f"attack.impl.sharding={mode!r} is renamed 'experimental-2d' (numerically demo-grade; see "
                    f"docstring). Prefer 'batch' or 'restarts'.")
        mode = "experimental-2d"
    if mode not in ("restarts", "batch", "experimental-2d"):
        raise ValueError(f"Unknown attack.impl.sharding mode {mode!r}; use 'restarts', 'batch', or "
                         f"'experimental-2d'.")
    return mode


def _has_consts(attacker) -> bool:
    """Whether the attack's loss is the base class's matching loss (the JAX package's
    "consts protocol", which its subclasses with a loss of their own lack)."""
    from .optimization_based_attack import OptimizationBasedAttacker

    return type(attacker)._loss is OptimizationBasedAttacker._loss


def batch_problems(attacker, num_points, m, rec_models, lbfgs, fleet) -> list[str]:
    """What ``"batch"`` cannot reproduce, in the JAX package's words and order
    (optimization_based_attack.py:733-757)."""
    from .auxiliaries.regularizers import CAPTURING, OrthogonalityRegularization

    problems = []
    if not _has_consts(attacker):
        problems.append("attack loss without the consts protocol")
    if num_points is None or num_points % m != 0:
        problems.append(f"batch of {num_points} not divisible by the model axis ({m})")
    if attacker.objective.local_hyperparams is not None:
        problems.append("multi-step (fedAVG-unrolled) objective")
    if any(model.bn_train for model in rec_models):
        problems.append("BatchNorm train mode (batch stats span shards)")
    if any(isinstance(reg, CAPTURING) for reg in attacker.regularizers):
        problems.append("capture-intermediates regularizers (DeepInversion/FeatureRegularization)")
    if any(isinstance(reg, OrthogonalityRegularization) for reg in attacker.regularizers):
        problems.append("cross-example OrthogonalityRegularization")
    if lbfgs:
        problems.append("closure optimizers (L-BFGS inner products span the full candidate)")
    if fleet:
        problems.append("fleet mode (per-trial targets would need their own batch specs)")
    return problems


class AttackShards:
    """This rank's part of a sharded attack: its trials ``lo:hi`` of T and its images
    ``start:start + length`` of N, the mesh, and the collectives the attack needs."""

    def __init__(self, mode, mesh, num_trials, num_points):
        self.mode, self.mesh = mode, mesh
        self.num_trials, self.num_points = num_trials, num_points
        self.idle = mesh.coordinate is None
        self.lo, count = mesh.part("restarts", num_trials)
        self.hi = self.lo + count
        self.m = mesh.shape["model"]
        self.start, self.length = mesh.part("model", num_points) if mode == "batch" else (0, num_points)
        self.model_group = mesh.group("model")
        # the ranks that write their part of the best iterates into the gather: all under
        # "batch" (each holds other images), else one of each line of the model axis
        self.writes = not self.idle and (mode == "batch" or mesh.coordinate[1] == 0)

    @property
    def batch(self) -> slice:
        return slice(self.start, self.start + self.length)

    def trials_part(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's trials and images of a (T, N, ...) stack."""
        return full[self.lo:self.hi, self.batch]

    def batch_part(self, full: torch.Tensor, axis: int | None = 0) -> torch.Tensor:
        """This rank's images of a tensor with the batch on ``axis`` (None: no batch axis)."""
        return full if axis is None or self.mode != "batch" else full.narrow(axis, self.start, self.length)

    def full_shape(self, shape, per_trial: bool):
        """The solo shape of a local (T', N', ...) stack, or (N', ...) leaf."""
        if per_trial:
            return (self.num_trials, self.num_points, *shape[2:])
        return (self.num_points, *shape[1:])

    def local(self, full: torch.Tensor, per_trial: bool) -> torch.Tensor:
        return self.trials_part(full) if per_trial else self.batch_part(full)

    def over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of a batch-mean over the batch's ranks ("batch"), differentiable."""
        return _dist.mean_over(x, self.model_group, self.m) if self.mode == "batch" else x

    def sum_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's images summed over the batch's ranks ("batch")."""
        return _dist.all_reduce_(x, self.model_group) if self.mode == "batch" and self.m > 1 else x

    def any_finite(self, values: np.ndarray) -> bool:
        """Whether any trial of any rank has a finite loss."""
        flag = torch.tensor([float(np.isfinite(values).any())], dtype=torch.float64)
        return bool(_dist.all_reduce_(flag, self.mesh.active)[0] > 0)

    def gather(self, best: dict, values, stats) -> tuple[dict, np.ndarray]:
        """Every trial's best iterate (each leaf (T, N, ...)) and value (T,), and its loss
        history into ``stats``, on every rank. An idle rank passes leaves of the whole
        shape, which it does not write."""
        T = self.num_trials
        index = (slice(self.lo, self.hi), self.batch)
        out = {}
        for key in sorted(best):
            leaf = best[key]
            shape = (T, self.num_points, *leaf.shape[2:]) if self.mode == "batch" else (T, *leaf.shape[1:])
            part = leaf if self.writes else None
            out[key] = _dist.gather(part, shape, index if self.mode == "batch" else index[:1],
                                    dtype=leaf.dtype, device=leaf.device)
        writes_trials = not self.idle and self.mesh.coordinate[1] == 0
        values = torch.as_tensor(np.asarray(values, dtype=np.float64))
        values = _dist.gather(values if writes_trials else None, (T,), (slice(self.lo, self.hi),),
                              dtype=torch.float64)
        # histories of trials run one after the other may differ in length: padded, with lengths
        mine = [stats.pop(f"Trial_{t}_Val", []) for t in range(self.lo, self.hi)] if writes_trials else []
        lengths = _dist.gather(torch.tensor([len(h) for h in mine], dtype=torch.float64) if writes_trials
                               else None, (T,), (slice(self.lo, self.hi),), dtype=torch.float64)
        longest = int(lengths.max()) if T else 0
        padded = None
        if writes_trials:
            padded = torch.zeros(len(mine), longest, dtype=torch.float64)
            for row, history in zip(padded, mine):
                row[:len(history)] = torch.tensor(history, dtype=torch.float64)
        histories = _dist.gather(padded, (T, longest), (slice(self.lo, self.hi),), dtype=torch.float64)
        for t in range(T):
            stats[f"Trial_{t}_Val"] = histories[t, :int(lengths[t])].tolist()
        evaluations = torch.tensor([float(stats.get("objective_evaluations", 0) if writes_trials else 0)],
                                   dtype=torch.float64)
        stats["objective_evaluations"] = int(_dist.all_reduce_(evaluations)[0])
        return out, values.numpy()


def plan(attacker, mode, num_trials, num_points, rec_models, lbfgs, fleet) -> AttackShards:
    """The rank's ``AttackShards`` for ``mode``, with the objective shared out as "batch"
    needs; raises the JAX package's ValueError where "batch" cannot shard the attack."""
    mode = resolve_mode(mode)
    mesh = make_attack_mesh(num_trials, "model" if mode != "restarts" else "restarts")
    m = mesh.shape["model"]
    if mode == "batch" and m > 1:
        problems = batch_problems(attacker, num_points, m, rec_models, lbfgs, fleet)
        if problems:
            raise ValueError("attack.impl.sharding='batch' cannot shard this attack: " + "; ".join(problems)
                             + ". Use sharding='restarts'.")
    if m == 1:
        mode = "restarts"
    shards = AttackShards(mode, mesh, num_trials, num_points)
    if mode == "batch":
        attacker.objective.shard_batch(shards.model_group, m)
    elif mode == "experimental-2d":
        log.warning("sharding='experimental-2d' runs the trials over the restarts axis with the parameters whole "
                    "on every rank: the ranks of a line of the model axis compute the same trials. 'batch' "
                    "splits the candidate batch over the model axis.")
    part = "idle" if shards.idle else \
        f"trials {shards.lo}:{shards.hi}, images {shards.start}:{shards.start + shards.length}"
    log.info(f"Attack state sharded over mesh {mesh.shape} ({mesh.size} ranks, mode={mode}); this rank: {part}.")
    return shards
