"""Optimization-based gradient inversion (counterpart of
``breaching_tpu/attacks/optimization_based_attack.py``).

Each step computes grad_x [distance(grad_theta L(theta, x), g*) + reg(x)] by double
backward; then one call of ``ops.adam_box_step`` (one kernel launch on the card)
takes its sign (hard-signed attacks), takes an Adam step, clamps the candidate to
the data box, rejects a step whose loss is not finite and keeps the best iterate.
The step runs eagerly; nothing in it waits on the host except the loss readout
every ``optim.callback`` steps. Restart trials run one after the other, each from
its own initial candidate, and are then scored.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops import adam_box_step
from .auxiliaries.objectives import CosineSimilarity, objective_lookup
from .auxiliaries.optimizers import optimizer_lookup
from .auxiliaries.regularizers import regularizer_lookup
from .base_attack import _BaseAttacker

log = logging.getLogger(__name__)


class OptimizationBasedAttacker(_BaseAttacker):
    """The optimization attack for single-query vision payloads."""

    def __init__(self, model, loss_fn, cfg_attack, setup):
        super().__init__(model, loss_fn, cfg_attack, setup)
        objective_cls = objective_lookup.get(self.cfg.objective.type)
        if objective_cls is None:
            raise NotImplementedError(f"Objective {self.cfg.objective.type} is not ported yet.")
        self.objective = objective_cls(**self.cfg.objective)
        self.regularizers = []
        for key, rcfg in (self.cfg.regularization or {}).items():
            if rcfg and float(rcfg.get("scale", 0) or 0) > 0:
                if key not in regularizer_lookup:
                    raise NotImplementedError(f"Regularizer {key} is not ported yet.")
                self.regularizers.append(regularizer_lookup[key](self.setup, **rcfg))
        if self.cfg.get("augmentations"):
            raise NotImplementedError("Attack augmentations are not ported yet.")
        optim = self.cfg.optim
        if float(optim.get("langevin_noise") or 0.0) > 0 or optim.grad_clip is not None \
                or optim.signed not in (None, False, "hard", True):
            raise NotImplementedError("Of the gradient transforms only the hard sign is ported yet.")

    def __repr__(self):
        n = "\n" + " " * 18
        return f"""Attacker (of type {self.__class__.__name__}) with settings:
    Hyperparameter Template: {self.cfg.type}

    Objective: {repr(self.objective)}
    Regularizers: {n.join(repr(r) for r in self.regularizers)}

    Optimization Setup: {dict(self.cfg.optim)}"""

    def reconstruct(self, server_payload, shared_data, server_secrets=None,
                    initial_data=None, dryrun=False):
        """Reconstruct the user's data; ``initial_data`` (NCHW) replaces the random
        initial candidate of every trial."""
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        shared_data = self._shared_data_cache
        best = self._run_all_trials(rec_models, shared_data, labels, stats, initial_data, dryrun)
        scores = self._score_all_trials(best, labels, rec_models, shared_data)
        optimal = self._select_optimal_reconstruction(best, scores, stats)
        return dict(data=optimal, labels=labels), stats

    def _loss(self, candidate, rec_models, targets, labels):
        """Matching objective over all queries plus the regularizers: (value, task loss)."""
        total, task_total = 0.0, 0.0
        for model, target in zip(rec_models, targets):
            obj, task = self.objective(model.params, model.buffers, target, candidate, labels,
                                       bn_train=model.bn_train)
            total, task_total = total + obj, task_total + task
        for reg in self.regularizers:
            total = total + reg(candidate)
        return total, task_total

    def _run_all_trials(self, rec_models, shared_data, labels, stats, initial_data, dryrun):
        cfg_optim = self.cfg.optim
        num_trials = int(self.cfg.restarts.num_trials)
        max_iterations = 1 if dryrun else int(cfg_optim.max_iterations)
        callback = int(cfg_optim.callback or 0) or max_iterations
        metadata = shared_data[0]["metadata"]
        num_points = int(metadata["num_data_points"]) if metadata["num_data_points"] else len(labels)

        self.objective.initialize(self.loss_fn, rec_models[0].module,
                                  metadata.get("local_hyperparams"), self.cfg.impl)
        for reg in self.regularizers:
            reg.initialize(rec_models, shared_data, labels)
        targets = [tuple(d["gradients"][k] for k in model.params)
                   for d, model in zip(shared_data, rec_models)]

        candidates = self._initialize_data((num_trials, num_points, *self.data_shape))
        if initial_data is not None:
            candidates = torch.as_tensor(initial_data, dtype=candidates.dtype,
                                         device=candidates.device).expand_as(candidates)
        min_box, max_box = (-self.dm / self.ds).contiguous(), ((1 - self.dm) / self.ds).contiguous()

        best_trials = []
        for trial in range(num_trials):
            optimizer = optimizer_lookup(cfg_optim.optimizer, float(cfg_optim.step_size),
                                         scheduler=cfg_optim.step_size_decay,
                                         warmup=int(cfg_optim.warmup or 0),
                                         max_iterations=max_iterations)
            candidate = candidates[trial].clone()
            state = optimizer.init(candidate)
            best = candidate.clone()
            # the step reads one and writes the other; they swap after every step
            best_vals = [torch.tensor(float("inf"), device=candidate.device),
                         torch.empty((), device=candidate.device)]
            history = stats.setdefault(f"Trial_{trial}_Val", [])
            iteration, wallclock = 0, time.time()
            while iteration < max_iterations:
                values, task_losses = [], []
                for _ in range(min(callback, max_iterations - iteration)):
                    x = candidate.detach().requires_grad_(True)
                    value, task_loss = self._loss(x, rec_models, targets, labels)
                    grad, = torch.autograd.grad(value, x)
                    value = value.detach()
                    adam_box_step(candidate, grad.contiguous(), state["mu"], state["nu"], best,
                                  min_box, max_box, value, *best_vals, optimizer.advance(state),
                                  signed=bool(cfg_optim.signed), boxed=bool(cfg_optim.boxed))
                    best_vals.reverse()
                    values.append(value)
                    task_losses.append(task_loss)
                    iteration += 1
                values = torch.stack(values).cpu().numpy()
                history.extend(values.tolist())
                now = time.time()
                log.info(f"| It: {iteration} | Rec. loss: {values[-1]:2.4f} | "
                         f"Task loss: {float(task_losses[-1]):2.4f} | T: {now - wallclock:4.2f}s | "
                         f"{len(values) / max(now - wallclock, 1e-9):,.1f} it/s")
                wallclock = now
                if not np.isfinite(values[-1]):
                    log.info(f"Recovery loss is non-finite in iteration {iteration}. "
                             f"Cancelling reconstruction!")
                    break
            best_trials.append(best)
        return torch.stack(best_trials)

    def _score_all_trials(self, best_trials, labels, rec_models, shared_data):
        """Score every trial with cfg.restarts.scoring (reference
        optimization_based_attack.py:191-218)."""
        scoring = self.cfg.restarts.scoring
        if scoring != "cosine-similarity":
            raise NotImplementedError(f"Scoring {scoring} is not ported yet.")
        objective = CosineSimilarity()
        objective.initialize(self.loss_fn, rec_models[0].module, None, self.cfg.impl)
        scores = []
        for candidate in best_trials:
            total = 0.0
            for model, data in zip(rec_models, shared_data):
                target = tuple(data["gradients"][k] for k in model.params)
                obj, _ = objective(model.params, model.buffers, target, candidate, labels,
                                   bn_train=model.bn_train)
                total = total + obj.detach()
            scores.append(float(total))
        scores = np.asarray(scores)
        return np.where(np.isfinite(scores), scores, np.inf)

    def _select_optimal_reconstruction(self, best_trials, scores, stats):
        optimal_index = int(np.argmin(scores))
        stats["opt_value"] = float(scores[optimal_index])
        if np.isfinite(scores[optimal_index]):
            log.info(f"Optimal candidate solution with rec. loss {scores[optimal_index]:2.4f} "
                     f"selected (trial {optimal_index}).")
            return best_trials[optimal_index]
        log.info("No valid reconstruction could be found.")
        return torch.zeros_like(best_trials[0])
