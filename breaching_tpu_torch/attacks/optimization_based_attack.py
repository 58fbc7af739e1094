"""Optimization-based gradient inversion (counterpart of
``breaching_tpu/attacks/optimization_based_attack.py``).

Each step computes grad_x [distance(grad_theta L(theta, x), g*) + reg(x)] by double
backward; then one call of ``ops.adam_box_step`` (one kernel launch on the card)
takes its sign (hard-signed attacks), takes an Adam step, clamps the candidate to
the data box, rejects a step whose loss is not finite and keeps the best iterate.
A single trial whose loss ends non-finite also leaves the candidate it stopped at in
``stats["Trial_<t>_nonfinite_candidate"]``.
The step runs eagerly; nothing in it waits on the host except the loss readout
every ``optim.callback`` steps.

One trial runs that step alone. Two or more trials (``restarts.num_trials > 1``, and
``reconstruct_fleet``, which stacks independent experiments on the trials axis) run
a batched step: the objective of every trial at once (``objectives.trials``), one
double backward for all, and per trial one TV launch and one ``adam_box_step``
launch on its contiguous views, each trial keeping its own best value and iterate.
The trials are then scored (``restarts.scoring``) and the best is returned.

A fedAVG user's update (a payload whose metadata carries ``local_hyperparams``) is
matched by the objective's unrolled local steps, and scored the same way; it runs
one trial, solo: restarts and fleets of such users are refused.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops import adam_box_step, adam_box_step_trials
from .auxiliaries.objectives import CosineSimilarity, objective_lookup
from .auxiliaries.optimizers import optimizer_lookup
from .auxiliaries.regularizers import regularizer_lookup
from .base_attack import _BaseAttacker

log = logging.getLogger(__name__)


class OptimizationBasedAttacker(_BaseAttacker):
    """The optimization attack for vision payloads."""

    # two or more trials (restarts, the fleet) through one batched step; off, they run
    # one after the other through the single step, the plain version of the batched one
    batched_trials = True

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
        num_trials = int(self.cfg.restarts.num_trials)
        targets = [tuple(d["gradients"][k] for k in model.params)
                   for d, model in zip(shared_data, rec_models)]
        best, _ = self._run_all_trials(rec_models, shared_data, [targets] * num_trials,
                                       [labels] * num_trials, stats, initial_data, dryrun)
        scores = self._score_all_trials(best, labels, rec_models, shared_data)
        optimal = self._select_optimal_reconstruction(best, scores, stats)
        return dict(data=optimal, labels=labels), stats

    def reconstruct_fleet(self, payload_lists, shared_lists, server_secrets=None, dryrun=False):
        """Run N independent single-query reconstructions as one batched attack
        (reference optimization_based_attack.py:107-194): every experiment's target
        gradient and labels are stacked on the trials axis, ``restarts.num_trials``
        trials each, and all trials advance together through the batched step.

        The experiments share one model: their payloads must carry identical
        parameters. Returns (one reconstructed-data dict per experiment, stats), with
        each experiment's selected value in ``stats["fleet_opt_values"]``."""
        if any(data["metadata"].get("local_hyperparams") is not None
               for shared in shared_lists for data in shared):
            raise NotImplementedError("Fleets of fedAVG users are not ported yet; attack each solo.")
        ref_params = payload_lists[0][0]["parameters"]
        for payloads in payload_lists[1:]:
            params = payloads[0]["parameters"]
            if params.keys() != ref_params.keys() or not all(
                    torch.equal(params[k], ref_params[k]) for k in ref_params):
                raise ValueError("Fleet mode requires identical model parameters across all "
                                 "experiments (the batched trials share one set of weights); got "
                                 "diverging payloads. Run these experiments solo.")
        all_labels, all_targets = [], []
        for payloads, shareds in zip(payload_lists, shared_lists):
            rec_models, labels, stats = self.prepare_attack(payloads, shareds)
            if len(self._shared_data_cache) != 1:
                raise ValueError("Fleet mode batches single-query experiments; got a multi-query payload.")
            gradients = self._shared_data_cache[0]["gradients"]
            all_labels.append(labels)
            all_targets.append(tuple(gradients[k] for k in rec_models[0].params))
        trials_per = int(self.cfg.restarts.num_trials)
        trial_targets = [[targets] for targets in all_targets for _ in range(trials_per)]
        trial_labels = [labels for labels in all_labels for _ in range(trials_per)]
        best, best_vals = self._run_all_trials(rec_models, self._shared_data_cache, trial_targets,
                                               trial_labels, stats, None, dryrun)
        if trials_per > 1:  # each trial scored against its own experiment's target
            scores = np.concatenate([
                self._score_all_trials(best[i * trials_per:(i + 1) * trials_per], labels, rec_models, shared)
                for i, (shared, labels) in enumerate(zip(shared_lists, all_labels))])
        else:  # one trial per experiment: its best value
            scores = best_vals
        results = []
        stats["fleet_opt_values"] = []
        for i, labels in enumerate(all_labels):
            j = i * trials_per + int(np.argmin(scores[i * trials_per:(i + 1) * trials_per]))
            stats["fleet_opt_values"].append(float(scores[j]))
            results.append(dict(data=best[j], labels=labels))
        return results, stats

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

    def _trial_losses(self, candidates, params, rec_models, targets, labels):
        """``_loss`` of T trials at once, each against its own targets and labels: (T,)
        values and task losses for candidates (T, N, C, H, W), ``targets`` one tuple of
        (T, ...) target gradients per query and ``labels`` (T, N)."""
        total, task_total = 0.0, 0.0
        for p, model, target in zip(params, rec_models, targets):
            obj, task = self.objective.trials(p, model.buffers, target, candidates, labels)
            total, task_total = total + obj, task_total + task
        for reg in self.regularizers:
            total = total + reg.trials(candidates)
        return total, task_total

    def _run_all_trials(self, rec_models, shared_data, trial_targets, trial_labels, stats,
                        initial_data, dryrun):
        """Run every trial: trial t matches ``trial_targets[t]`` (one tuple of target
        gradients per query) under ``trial_labels[t]``. One trial runs the single step;
        two or more run the batched step, or one after the other through the single step
        if ``batched_trials`` is off (its plain version). Returns the best iterates
        (T, N, C, H, W) and their values (T,)."""
        max_iterations = 1 if dryrun else int(self.cfg.optim.max_iterations)
        num_trials = len(trial_targets)
        metadata = shared_data[0]["metadata"]
        num_points = int(metadata["num_data_points"]) if metadata["num_data_points"] \
            else len(trial_labels[0])

        local_hyperparams = self._local_hyperparams(metadata)
        if local_hyperparams is not None and num_trials > 1:
            raise NotImplementedError("Restarts of a fedAVG user's attack are not ported yet; "
                                      "set attack.restarts.num_trials=1.")
        self.objective.initialize(self.loss_fn, rec_models[0].module, local_hyperparams, self.cfg.impl)
        for reg in self.regularizers:
            reg.initialize(rec_models, shared_data, trial_labels[0])

        candidates = self._initialize_data((num_trials, num_points, *self.data_shape))
        if initial_data is not None:
            candidates = torch.as_tensor(initial_data, dtype=candidates.dtype,
                                         device=candidates.device).expand_as(candidates)
        box = (-self.dm / self.ds).contiguous(), ((1 - self.dm) / self.ds).contiguous()
        if num_trials > 1 and self.batched_trials:
            if any(model.bn_train for model in rec_models):
                raise NotImplementedError("BatchNorm in train mode is not ported under the batched "
                                          "trial step; the server must share its buffers.")
            targets = [tuple(torch.stack(ts) for ts in zip(*query)) for query in zip(*trial_targets)]
            return self._run_trials_batched(candidates.clone(memory_format=torch.contiguous_format),
                                            rec_models, targets,
                                            torch.stack(trial_labels), stats, max_iterations, box)
        runs = [self._run_trial(candidates[t].clone(), t, rec_models, trial_targets[t],
                                trial_labels[t], stats, max_iterations, box)
                for t in range(num_trials)]
        return torch.stack([best for best, _ in runs]), np.asarray([v for _, v in runs])

    def _local_hyperparams(self, metadata):
        """A fedAVG user's local hyperparameters with its per-step label lists stacked
        into one (steps, data per step) tensor on the attack's device, or None for a
        fedSGD user (reference optimization_based_attack.py:327-332)."""
        local_hyperparams = metadata.get("local_hyperparams")
        if local_hyperparams is None:
            return None
        labels = torch.stack([torch.as_tensor(step_labels, dtype=torch.int64, device=self.setup["device"])
                              for step_labels in local_hyperparams["labels"]])
        return dict(local_hyperparams, labels=labels)

    def _optimizer(self, max_iterations):
        cfg_optim = self.cfg.optim
        return optimizer_lookup(cfg_optim.optimizer, float(cfg_optim.step_size),
                                scheduler=cfg_optim.step_size_decay, warmup=int(cfg_optim.warmup or 0),
                                max_iterations=max_iterations)

    def _run_trial(self, candidate, trial, rec_models, targets, labels, stats, max_iterations, box):
        """One trial through the single step. Returns its best iterate and best value."""
        cfg_optim = self.cfg.optim
        optimizer = self._optimizer(max_iterations)
        state = optimizer.init(candidate)
        best = candidate.clone()
        # the step reads one and writes the other; they swap after every step
        best_vals = [torch.tensor(float("inf"), device=candidate.device),
                     torch.empty((), device=candidate.device)]

        def step():
            x = candidate.detach().requires_grad_(True)
            value, task_loss = self._loss(x, rec_models, targets, labels)
            grad, = torch.autograd.grad(value, x)
            value = value.detach()
            adam_box_step(candidate, grad.contiguous(), state["mu"], state["nu"], best,
                          *box, value, *best_vals, optimizer.advance(state),
                          signed=bool(cfg_optim.signed), boxed=bool(cfg_optim.boxed))
            best_vals.reverse()
            return value, task_loss

        history = stats.setdefault(f"Trial_{trial}_Val", [])
        self._optimize(step, [history], max_iterations)
        if history and not np.isfinite(history[-1]):
            # a step whose loss is not finite keeps its candidate: this is where the loss
            # turned non-finite, kept so that the cause can be looked at
            stats[f"Trial_{trial}_nonfinite_candidate"] = candidate.clone()
        return best, float(best_vals[0])

    def _run_trials_batched(self, candidate, rec_models, targets, labels, stats, max_iterations, box):
        """All T trials of candidate (T, N, C, H, W) through one step: the per-trial
        objective (``_trial_losses``), one ``torch.autograd.grad`` of the trials' sum, and
        ``adam_box_step_trials``, each trial with its own best value and iterate. Returns
        the best iterates and their values (T,)."""
        cfg_optim = self.cfg.optim
        num_trials = candidate.shape[0]
        optimizer = self._optimizer(max_iterations)
        state = optimizer.init(candidate)
        best = candidate.clone()
        best_vals = [torch.full((num_trials,), float("inf"), device=candidate.device),
                     torch.empty(num_trials, device=candidate.device)]
        # the user gradient is taken inside the objective: the outer graph needs no parameter
        params = [{k: v.detach() for k, v in model.params.items()} for model in rec_models]

        def step():
            x = candidate.detach().requires_grad_(True)
            value, task_loss = self._trial_losses(x, params, rec_models, targets, labels)
            grad, = torch.autograd.grad(value.sum(), x)
            value = value.detach()
            adam_box_step_trials(candidate, grad.contiguous(), state["mu"], state["nu"], best,
                                 *box, value, *best_vals, optimizer.advance(state),
                                 signed=bool(cfg_optim.signed), boxed=bool(cfg_optim.boxed))
            best_vals.reverse()
            return value, task_loss

        self._optimize(step, [stats.setdefault(f"Trial_{t}_Val", []) for t in range(num_trials)],
                       max_iterations)
        return best, best_vals[0].cpu().numpy()

    def _optimize(self, step, histories, max_iterations):
        """Run ``step`` (which returns the loss and task loss, a value per trial) until
        ``max_iterations`` or until no trial's loss is finite, reading the losses back
        into each trial's history every ``optim.callback`` steps."""
        callback = int(self.cfg.optim.callback or 0) or max_iterations
        iteration, wallclock = 0, time.time()
        while iteration < max_iterations:
            values, task_losses = [], []
            for _ in range(min(callback, max_iterations - iteration)):
                value, task_loss = step()
                values.append(value)
                task_losses.append(task_loss)
                iteration += 1
            values = torch.stack(values).cpu().numpy().reshape(len(values), len(histories))
            for history, trial_values in zip(histories, values.T):
                history.extend(trial_values.tolist())
            now = time.time()
            log.info(f"| It: {iteration} | Rec. loss: {values[-1].mean():2.4f} | "
                     f"Task loss: {float(task_losses[-1].mean()):2.4f} | T: {now - wallclock:4.2f}s | "
                     f"{values.size / max(now - wallclock, 1e-9):,.1f} it/s")
            wallclock = now
            if not np.isfinite(values[-1]).any():
                log.info(f"Recovery loss is non-finite in iteration {iteration}. "
                         f"Cancelling reconstruction!")
                break

    def _score_all_trials(self, best_trials, labels, rec_models, shared_data):
        """Score every trial with cfg.restarts.scoring (reference
        optimization_based_attack.py:191-218)."""
        scoring = self.cfg.restarts.scoring
        if scoring != "cosine-similarity":
            raise NotImplementedError(f"Scoring {scoring} is not ported yet.")
        objective = CosineSimilarity()
        objective.initialize(self.loss_fn, rec_models[0].module,
                             self._local_hyperparams(shared_data[0]["metadata"]), self.cfg.impl)
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
