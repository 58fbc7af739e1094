"""Optimization-based gradient inversion (counterpart of
``breaching_tpu/attacks/optimization_based_attack.py``).

The optimization variable is a dict of tensors, the candidate tree: ``data`` (NCHW
images, or for a text payload embeddings (N, T, D) fed to the model in place of token
ids), and for the joint attack (``optimization_with_label_attack.py``) also ``labels``
(label logits). A text reconstruction's embeddings end as token ids
(``text_utils.postprocess_text_data``); embeddings have no box. Each step computes its
loss, the gradient matching objective plus the regularizers, and the loss's gradient
with respect to every leaf by double backward. Regularizers that read the model's
intermediates (``DeepInversion``, ``FeatureRegularization``) take them from the
objective's own forward pass; the others read the candidate alone. What follows depends
on the optimizer (``optim.optimizer``):

- Adam and ``adam-safe``: the gradient transforms that the kernel does not take
  (Langevin noise, ``grad_clip``) in PyTorch operations, then per leaf one call of
  ``ops.adam_box_step`` (one kernel launch on the card), which takes the hard or
  soft sign, the Adam step, the box clamp (image data only), rejects a step whose loss
  is not finite and keeps the best iterate; a projection of another kind
  (``_project_accepted``, the permutation attack's) follows on the result where the
  step was accepted. The leaves of one step share its loss and
  best value, so they keep the best iterate of the same step.
- ``bert-adam``, ``momgd`` and ``gd``: the transforms and the update in PyTorch
  operations, then when boxed ``_project_tree`` (``ops.box_project`` on images, kernel
  B4), then the finite guard and the best iterate.
- L-BFGS: the untransformed gradient and a closure of the full loss go to
  ``LBFGS.update`` (up to 20 more evaluations of the loss), then ``_project_tree``, the
  guard and the best iterate.

A single trial whose loss ends non-finite also leaves the candidate it stopped at in
``stats["Trial_<t>_nonfinite_candidate"]``. ``stats["objective_evaluations"]``
counts the evaluations of the loss (with L-BFGS, more than one per step). The step
runs eagerly; besides L-BFGS's break conditions, nothing in it waits on the host
except the loss readout every ``optim.callback`` steps.

One trial runs that step alone. Two or more trials of an Adam attack on the data
alone (``restarts.num_trials > 1``, and ``reconstruct_fleet``, which stacks
independent experiments on the trials axis) on images run a batched step: the objective of
every trial at once (``objectives.trials``), one double backward for all, one TV
launch and one ``adam_box_step_trials`` launch for all the trials, each trial keeping
its own best value and iterate. It takes what the single step takes: BatchNorm in
train mode (each trial's own batch statistics), the regularizers that read the
objective's intermediates (returned per trial out of the vmapped objective),
augmentations (each trial's own draws from its own generators, made outside the vmap
and applied trial by trial), a fedAVG user's unrolled local steps, and ``grad_accum``.
The trials of other optimizers and of the joint attack run one after the other
through the single step. The trials are then scored (``restarts.scoring``:
``cosine-similarity``, ``euclidean`` or TV) and the best is returned.

Against the fishing server (``server_secrets["ClassAttack"]``) the attack rebuilds the one
image the server isolated and returns it in the user's batch (``expand_class_attack``).

A fedAVG user's update (a payload whose metadata carries ``local_hyperparams``) is
matched by the objective's unrolled local steps, and scored the same way. Its restarts
and fleets run the batched step (under L-BFGS one after the other); a fleet's trials
unroll the local steps under the per-step labels of the payload the attack prepared
last, as the JAX package's vmapped trials do.

``augmentations`` (``auxiliaries/augmentations.py``) apply to the candidate inside the
loss, before the objective and the regularizers that read its intermediates, with
fresh draws at every step from the trial's own generators (L-BFGS's evaluations
within a step share them); without ``differentiable_augmentations`` the gradient
passes straight through. Ctrl-C ends the run with each trial's best iterate so far and
``stats["interrupted_at"]``.

The candidate takes the setup's dtype (``case.impl.dtype``: float32, bfloat16 or
float64), its best value the type of its loss (float64 for float64, else float32),
and Adam's moments the candidate's type.

Of ``attack.impl`` the port acts on:
- ``grad_accum`` and ``dtype`` (in the objective: bfloat16 or float16 run the simulated
  user pass in that type; float64 and others cast nothing);
- ``mixed_precision``: the step runs under ``precision.bfloat16_operands``, which
  rounds every convolution's and matrix product's operands to bfloat16 and accumulates
  in float32, as the JAX package's ``default_matmul_precision("bfloat16")``; the mode
  ends with the step;
- ``checkpoint_path`` and ``checkpoint_every``: every ``checkpoint_every`` read-back
  chunks the run's state (``_RunState``: the candidate tree, the optimizer's state
  (Adam's moments and step count; L-BFGS's history, ``h_diag``, last direction and
  counters, ``LBFGS.state_arrays``), the best iterates and value, and the generators of
  the Langevin noise and the augmentations) goes to the ``.npz`` file at
  ``checkpoint_path`` (``utils_checkpoint.py``); a run that finds a file that fits its
  state resumes from it (``stats["resumed_at"]``), a file that does not fit is ignored
  with a warning. Trials run one after the other keep one section of the file each
  (``trial<t>/``), so that the file holds every trial, as the JAX package's carry does;
- ``trace_dir``: the second read-back chunk of the run (the first after warm-up) runs
  under ``torch.profiler`` and is written as a Chrome trace into ``trace_dir``
  (``stats["trace_file"]``).
It refuses ``sharding`` by name: the port runs on one device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from .. import utils_checkpoint
from ..ops import adam_box_step, adam_box_step_trials, box_project, sign, soft_sign_scalars
from ..ops.image import soft_sign_plain
from ..ops.matching import acc_dtype
from .auxiliaries.augmentations import augmentation_lookup
from .auxiliaries.objectives import CosineSimilarity, Euclidean, objective_lookup
from .auxiliaries.optimizers import Adam, LBFGS, make_schedule, optimizer_lookup
from .auxiliaries.precision import bfloat16_operands
from .auxiliaries.regularizers import CAPTURING, TotalVariation, regularizer_lookup
from .base_attack import _BaseAttacker

log = logging.getLogger(__name__)


def expand_class_attack(reconstructed, info):
    """The fishing server's single reconstruction put back in the user's batch: zeros of
    the user's ``true_num_data`` images with the reconstruction at ``target_indx``, and
    all the user's labels (reference: optimization_based_attack.py:98-104)."""
    optimal = reconstructed["data"]
    full = optimal.new_zeros((int(info["true_num_data"]), *optimal.shape[1:]))
    full[torch.as_tensor(info["target_indx"], device=optimal.device).reshape(-1).long()] = optimal
    return dict(data=full, labels=torch.as_tensor(info["all_labels"], device=optimal.device))


class OptimizationBasedAttacker(_BaseAttacker):
    """The optimization attack for vision payloads."""

    # two or more trials (restarts, the fleet) of an Adam attack through one batched
    # step; off, they run one after the other through the single step, the plain
    # version of the batched one
    batched_trials = True
    supports_fleet = True

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
        self.augmentations = [augmentation_lookup[key](**(acfg or {}))
                              for key, acfg in (self.cfg.get("augmentations") or {}).items()]
        signed = self.cfg.optim.signed
        if signed not in (None, False, True, "hard", "soft"):
            raise NotImplementedError(f"Gradient transform signed={signed} is not ported yet.")
        impl = self.cfg.get("impl") or {}
        if impl.get("sharding"):  # the JAX package shards the attack over a mesh; the port runs on one device
            raise NotImplementedError(f"attack.impl.sharding={impl.get('sharding')} is not ported yet.")
        self._noise_generators = {}

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
        initial data of every trial."""
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        shared_data = self._shared_data_cache
        num_trials = int(self.cfg.restarts.num_trials)
        targets = [tuple(d["gradients"][k] for k in model.params)
                   for d, model in zip(shared_data, rec_models)]
        best, _ = self._run_all_trials(rec_models, shared_data, [targets] * num_trials,
                                       [labels] * num_trials, stats, initial_data, dryrun)
        scores = self._score_all_trials(best, labels, rec_models, shared_data)
        optimal = self._select_optimal_reconstruction(best, scores, stats)
        reconstructed = self._extract_solution(optimal, labels)
        if self.modality == "text":
            reconstructed = self._postprocess_text_data(reconstructed)
        if server_secrets and "ClassAttack" in server_secrets:
            reconstructed = expand_class_attack(reconstructed, server_secrets["ClassAttack"])
        return reconstructed, stats

    def reconstruct_fleet(self, payload_lists, shared_lists, server_secrets=None, dryrun=False):
        """Run N independent single-query reconstructions as one batched attack
        (reference optimization_based_attack.py:107-194): every experiment's target
        gradient and labels are stacked on the trials axis, ``restarts.num_trials``
        trials each, and all trials advance together through the batched step.

        The experiments share one model: their payloads must carry identical
        parameters. Returns (one reconstructed-data dict per experiment, stats), with
        each experiment's selected value in ``stats["fleet_opt_values"]``."""
        if not self.supports_fleet:
            raise NotImplementedError(f"Fleets are not ported for {self.__class__.__name__}.")
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
                self._score_all_trials({k: v[i * trials_per:(i + 1) * trials_per] for k, v in best.items()},
                                       labels, rec_models, shared)
                for i, (shared, labels) in enumerate(zip(shared_lists, all_labels))])
        else:  # one trial per experiment: its best value
            scores = best_vals
        results = []
        stats["fleet_opt_values"] = []
        for i, labels in enumerate(all_labels):
            j = i * trials_per + int(np.argmin(scores[i * trials_per:(i + 1) * trials_per]))
            stats["fleet_opt_values"].append(float(scores[j]))
            results.append(self._extract_solution({k: v[j] for k, v in best.items()}, labels))
        return results, stats

    # ---------------------------------------------------------------- candidate tree

    def _init_candidate_tree(self, num_trials, num_points):
        """The optimization variable of every trial, leaves with a leading trial axis."""
        return dict(data=self._initialize_data((num_trials, num_points, *self.data_shape)))

    def _effective_labels(self, tree, labels):
        """The labels of the task loss; the joint attack derives them from the tree."""
        return labels

    def _extract_solution(self, tree, labels):
        return dict(data=tree["data"], labels=labels)

    def _postprocess_text_data(self, reconstructed):
        from .auxiliaries.text_utils import postprocess_text_data

        return postprocess_text_data(self, reconstructed)

    def _project_tree(self, tree, box):
        """The box on image data (``ops.box_project``, in place: ``tree`` is the step's own
        result); text embeddings have none."""
        if self.modality != "vision":
            return tree
        data = tree["data"].contiguous()
        return dict(tree, data=box_project(data, *box, out=data))

    def _project_accepted(self, tree, value):
        """After ``adam_box_step``: a projection the kernel does not take, applied where the
        step was accepted (its loss finite). The box of images is the kernel's own."""

    # ---------------------------------------------------------------- loss

    def _split_regularizers(self):
        """(the regularizers that read the objective's captured intermediates, those that
        read the candidate alone), as the JAX package splits them."""
        inner = [reg for reg in self.regularizers if isinstance(reg, CAPTURING)]
        return inner, [reg for reg in self.regularizers if not isinstance(reg, CAPTURING)]

    def _loss(self, candidate, rec_models, targets, labels, draws=None):
        """Matching objective over all queries plus the regularizers: (value, task loss).
        ``candidate`` is the candidate tree, or the data alone. With augmentations, the
        objective and the regularizers that read its intermediates see the augmented
        data (under ``draws``, one entry per augmentation), the others the candidate."""
        tree = candidate if isinstance(candidate, dict) else dict(data=candidate)
        data, labels = tree["data"], self._effective_labels(tree, labels)
        matched = self._augment(data, draws) if self.augmentations else data
        inner, outer = self._split_regularizers()
        total, task_total, intermediates = 0.0, 0.0, []
        for model, target in zip(rec_models, targets):
            captured = {} if inner else None
            obj, task = self.objective(model.params, model.buffers, target, matched, labels,
                                       bn_train=model.bn_train, capture=captured)
            total, task_total = total + obj, task_total + task
            intermediates.append(captured)
        for reg in inner:
            total = total + reg(matched, intermediates)
        if outer:
            total = total + sum(reg(data) for reg in outer)
        return total, task_total

    def _augment(self, data, draws):
        """The augmentations applied in turn; without ``differentiable_augmentations``
        the gradient passes straight through to the candidate."""
        if draws is None:
            raise ValueError("The attack's augmentations need their draws.")
        augmented = data
        for augmentation, draw in zip(self.augmentations, draws):
            augmented = augmentation.apply(augmented, draw)
        return augmented if self.cfg.differentiable_augmentations else data + (augmented - data).detach()

    def _augmentation_generators(self, device):
        """A trial's generators for the augmentations' draws, seeded from the attack's
        generator: one on ``device``, one on the CPU for draws that become integers."""
        seeds = torch.randint(2 ** 62, (2,), generator=self.setup["generator"]).tolist()
        return (torch.Generator(device=device).manual_seed(seeds[0]),
                torch.Generator().manual_seed(seeds[1]))

    def _draw_augmentations(self, shape, generators):
        """One step's draws of every augmentation for images of NCHW ``shape``."""
        return [augmentation.sample(shape, generators[1] if augmentation.host_draws else generators[0])
                for augmentation in self.augmentations]

    def _trial_losses(self, candidates, params, rec_models, targets, labels, draws=None):
        """``_loss`` of T trials at once, each against its own targets and labels: (T,)
        values and task losses for candidates (T, N, C, H, W), ``targets`` one tuple of
        (T, ...) target gradients per query and ``labels`` (T, N). With augmentations,
        ``draws`` holds each trial's draws, applied trial by trial; the regularizers that
        read the objective's intermediates take each trial's, which the objective returns
        stacked on the trials axis."""
        matched = candidates
        if self.augmentations:
            matched = torch.stack([self._augment(c, d) for c, d in zip(candidates.unbind(), draws)])
        inner, outer = self._split_regularizers()
        total, task_total, intermediates = 0.0, 0.0, []
        for p, model, target in zip(params, rec_models, targets):
            captured = {} if inner else None
            obj, task = self.objective.trials(p, model.buffers, target, matched, labels, bn_train=model.bn_train,
                                              capture=captured)
            total, task_total = total + obj, task_total + task
            intermediates.append(captured)
        for reg in inner:
            total = total + torch.stack([reg(m, [_trial_slice(c, t) for c in intermediates])
                                         for t, m in enumerate(matched.unbind())])
        for reg in outer:
            total = total + reg.trials(candidates)
        return total, task_total

    def _value_and_grad(self, tree, rec_models, targets, labels, stats, draws=None):
        """The loss at the candidate tree and its gradient with respect to every leaf:
        (value, task loss, gradient tree), detached; zero for a leaf the loss does not
        read, as under ``jax.grad`` (the label logits of a fedAVG user's attack, whose local
        steps take the shared labels). Counts the evaluation."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in tree.items()}
        value, task_loss = self._loss(leaves, rec_models, targets, labels, draws)
        grads = torch.autograd.grad(value, tuple(leaves.values()), allow_unused=True, materialize_grads=True)
        stats["objective_evaluations"] = stats.get("objective_evaluations", 0) + 1
        return value.detach(), task_loss, {k: g.contiguous() for k, g in zip(leaves, grads)}

    # ---------------------------------------------------------------- core loop

    def _run_all_trials(self, rec_models, shared_data, trial_targets, trial_labels, stats,
                        initial_data, dryrun):
        """Run every trial: trial t matches ``trial_targets[t]`` (one tuple of target
        gradients per query) under ``trial_labels[t]``. Returns the best iterates (a
        tree of leaves with a leading trial axis) and their values (T,)."""
        max_iterations = 1 if dryrun else int(self.cfg.optim.max_iterations)
        num_trials = len(trial_targets)
        metadata = shared_data[0]["metadata"]
        num_points = int(metadata["num_data_points"]) if metadata["num_data_points"] \
            else len(trial_labels[0])

        local_hyperparams = self._local_hyperparams(metadata)
        self.objective.initialize(self.loss_fn, rec_models[0].module, local_hyperparams, self.cfg.impl)
        for reg in self.regularizers:
            reg.initialize(rec_models, shared_data, trial_labels[0])

        tree = self._init_candidate_tree(num_trials, num_points)
        if initial_data is not None:
            tree["data"] = torch.as_tensor(initial_data, dtype=tree["data"].dtype,
                                           device=tree["data"].device).expand_as(tree["data"])
        dtype = tree["data"].dtype
        box = ((-self.dm / self.ds).to(dtype).contiguous(), ((1 - self.dm) / self.ds).to(dtype).contiguous())
        adam = isinstance(self._optimizer(max_iterations), Adam)
        if num_trials > 1 and self.batched_trials and adam and list(tree) == ["data"] and self.modality == "vision":
            targets = [tuple(torch.stack(ts) for ts in zip(*query)) for query in zip(*trial_targets)]
            best, values = self._run_trials_batched(tree["data"].clone(memory_format=torch.contiguous_format),
                                                    rec_models, targets, torch.stack(trial_labels), stats,
                                                    max_iterations, box)
            return dict(data=best), values
        if num_trials > 1:
            log.info(f"The {num_trials} trials run one after the other through the single step "
                     f"({self.cfg.optim.optimizer}{'' if adam else ' has no batched step'}).")
        # trials one after the other keep a section each of one checkpoint file
        runs = [self._run_trial({k: v[t].clone() for k, v in tree.items()}, t, rec_models, trial_targets[t],
                                trial_labels[t], stats, max_iterations, box,
                                section=f"trial{t}" if num_trials > 1 else None)
                for t in range(num_trials)]
        return ({k: torch.stack([best[k] for best, _ in runs]) for k in tree},
                np.asarray([value for _, value in runs]))

    def _local_hyperparams(self, metadata):
        """A fedAVG user's local hyperparameters with its per-step label lists stacked
        into one (steps, data per step) tensor on the attack's device, or None for a
        fedSGD user (reference optimization_based_attack.py:327-332)."""
        local_hyperparams = metadata.get("local_hyperparams")
        if local_hyperparams is None:
            return None
        if len(local_hyperparams["labels"]) != int(local_hyperparams["steps"]):
            # a multi-step silo shares every user's label rows; the JAX package's scan refuses them too
            raise ValueError(f"The shared local hyperparameters hold {len(local_hyperparams['labels'])} per-step "
                             f"label rows for {local_hyperparams['steps']} local steps; the attack unrolls one "
                             f"user's steps.")
        labels = torch.stack([torch.as_tensor(step_labels, dtype=torch.int64, device=self.setup["device"])
                              for step_labels in local_hyperparams["labels"]])
        return dict(local_hyperparams, labels=labels)

    def _optimizer(self, max_iterations):
        cfg_optim = self.cfg.optim
        return optimizer_lookup(cfg_optim.optimizer, float(cfg_optim.step_size),
                                scheduler=cfg_optim.step_size_decay, warmup=int(cfg_optim.warmup or 0),
                                max_iterations=max_iterations)

    def _sign_mode(self):
        """"soft", "hard" or None, as the JAX package reads ``optim.signed``."""
        signed = self.cfg.optim.signed
        return "soft" if signed == "soft" else "hard" if signed in ("hard", True) else None

    def _noise_generator(self, device):
        """The Langevin noise's generator on ``device``, seeded once from the attack's
        generator."""
        generator = self._noise_generators.get(device)
        if generator is None:
            seed = int(torch.randint(2 ** 62, (), generator=self.setup["generator"]))
            generator = self._noise_generators[device] = torch.Generator(device=device).manual_seed(seed)
        return generator

    def _noise(self, like):
        """Standard normal noise of ``like``'s shape from ``_noise_generator``."""
        return torch.randn(like.shape, generator=self._noise_generator(like.device), device=like.device,
                           dtype=like.dtype)

    def _run_state(self, tree, states, best, best_vals, device, generators=None):
        """The ``_RunState`` of a run: the candidate tree, the optimizer's state (each
        leaf's, or with ``states`` an ``_LBFGSState`` the flat L-BFGS state's named
        arrays), the best iterates, the current best value(s), and the generators that
        draw in the loop (the Langevin noise's, made here if the run draws it, and the
        augmentations' ``generators``, a flat list of them)."""
        state = _RunState()
        state.add_tree("tree", tree)
        if isinstance(states, _LBFGSState):
            state.add_accessor("optimizer/lbfgs", states)
        else:
            state.add_tree("optimizer", states)
        state.add_tree("best", best)
        state.add("best_value", best_vals, 0)
        if float(self.cfg.optim.langevin_noise or 0.0) > 0:
            self._noise_generator(device)
            state.add("rng/langevin", self._noise_generators, device)
        for i, generator in enumerate(generators or ()):
            state.add(f"rng/augmentation{i}", generators, i)
        return state

    def transform_grads(self, grad, iteration, max_iterations, with_sign=True, per_trial=False):
        """The JAX package's ``transform_grads`` on one gradient leaf: Langevin noise
        (``optim.langevin_noise`` times the step size at ``iteration``), clipping to
        norm ``optim.grad_clip`` (over each trial's leaf with ``per_trial``), then with
        ``with_sign`` the hard or soft sign (which ``adam_box_step`` takes itself)."""
        cfg_optim = self.cfg.optim
        langevin = float(cfg_optim.langevin_noise or 0.0)
        if langevin > 0:
            lr_now = make_schedule(float(cfg_optim.step_size), cfg_optim.step_size_decay,
                                   int(cfg_optim.warmup or 0), max_iterations)(iteration)
            grad = grad + float(np.float32(langevin) * np.float32(lr_now)) * self._noise(grad)
        if cfg_optim.grad_clip is not None:
            dims = tuple(range(1, grad.dim())) if per_trial else tuple(range(grad.dim()))
            norm = torch.sqrt((grad * grad).sum(dim=dims, keepdim=True))
            clip = torch.full_like(norm, float(cfg_optim.grad_clip))
            grad = grad * torch.where(norm > clip, torch.div(clip, norm + 1e-6), torch.ones_like(norm))
        mode = self._sign_mode() if with_sign else None
        if mode == "soft":
            grad = soft_sign_plain(grad, soft_sign_scalars(iteration, max_iterations))
        elif mode == "hard":
            grad = sign(grad)
        return grad

    def _run_trial(self, tree, trial, rec_models, targets, labels, stats, max_iterations, box, section=None):
        """One trial through the single step; ``section`` names its part of a checkpoint
        file shared with other trials. Returns its best iterate and best value."""
        optimizer = self._optimizer(max_iterations)
        best = {k: v.clone() for k, v in tree.items()}
        # the step reads one and writes the other; they swap after every step
        # the loss and best value in the candidate's accumulation type (a half-precision
        # candidate's loss is float32)
        device, vtype = tree["data"].device, acc_dtype(tree["data"])
        best_vals = [torch.tensor(float("inf"), dtype=vtype, device=device),
                     torch.empty((), dtype=vtype, device=device)]
        boxed = bool(self.cfg.optim.boxed)
        generators = self._augmentation_generators(device) if self.augmentations else None
        # the augmentations' draws of the current step; L-BFGS's evaluations within a
        # step share them
        draws = [None]

        def draw():
            draws[0] = self._draw_augmentations(tree["data"].shape, generators) if generators else None
            return draws[0]

        states = None
        if isinstance(optimizer, Adam):
            states = {k: optimizer.init(v) for k, v in tree.items()}
            no_box = {k: torch.zeros(1, dtype=v.dtype, device=device) for k, v in tree.items()}

            def step(iteration):
                value, task_loss, grads = self._value_and_grad(tree, rec_models, targets, labels, stats, draw())
                mode = self._sign_mode()
                soft = soft_sign_scalars(iteration, max_iterations) if mode == "soft" else None
                for k, leaf in tree.items():
                    grad = self.transform_grads(grads[k], iteration, max_iterations, with_sign=False)
                    image = leaf.dim() == 4  # the data; other leaves as one row, unboxed
                    view = (lambda t: t) if image else (lambda t: t.view(1, 1, 1, -1))
                    adam_box_step(view(leaf), view(grad.contiguous()), view(states[k]["mu"]),
                                  view(states[k]["nu"]), view(best[k]), *(box if image else (no_box[k], no_box[k])),
                                  value.to(vtype), *best_vals, optimizer.advance(states[k], leaf.dtype),
                                  signed=mode, boxed=boxed and image and k == "data", soft_scale=soft)
                if boxed:
                    self._project_accepted(tree, value)
                best_vals.reverse()
                return value, task_loss
        elif isinstance(optimizer, LBFGS):
            keys, shapes = list(tree), [v.shape for v in tree.values()]
            sizes = [v.numel() for v in tree.values()]

            def flatten(leaves):
                return torch.cat([leaves[k].reshape(-1) for k in keys])

            def unflatten(flat):
                return {k: part.view(shape) for k, part, shape in zip(keys, flat.split(sizes), shapes)}

            def closure(flat):
                value, _, grads = self._value_and_grad(unflatten(flat), rec_models, targets, labels, stats,
                                                       draws[0])
                return value, flatten(grads)

            state = optimizer.init(flatten(tree))
            states = _LBFGSState(optimizer, state)

            def step(iteration):
                # L-BFGS takes the untransformed gradient: its curvature pairs compare it
                # with the closure's gradients
                value, task_loss, grads = self._value_and_grad(tree, rec_models, targets, labels, stats, draw())
                flat = flatten(tree)
                final = optimizer.update(flat, flatten(grads), value, closure, state)
                new = unflatten(flat + (final - flat))
                self._finish_step(tree, new, best, best_vals, value, box, boxed)
                return value, task_loss
        else:
            states = {k: optimizer.init(v) for k, v in tree.items()}

            def step(iteration):
                value, task_loss, grads = self._value_and_grad(tree, rec_models, targets, labels, stats, draw())
                new = {k: optimizer.update(self.transform_grads(grads[k], iteration, max_iterations),
                                           states[k], leaf) for k, leaf in tree.items()}
                self._finish_step(tree, new, best, best_vals, value, box, boxed)
                return value, task_loss

        history = stats.setdefault(f"Trial_{trial}_Val", [])
        run_state = self._run_state(tree, states, best, best_vals, device, generators)
        self._optimize(step, [history], max_iterations, stats, run_state, section)
        if history and not np.isfinite(history[-1]):
            # a step whose loss is not finite keeps its candidate: this is where the loss
            # turned non-finite, kept so that the cause can be looked at
            stats[f"Trial_{trial}_nonfinite_candidate"] = tree["data"].clone()
        return best, float(best_vals[0])

    def _finish_step(self, tree, new, best, best_vals, value, box, boxed):
        """The step's tail in PyTorch operations, for optimizers other than Adam: with
        ``boxed`` ``_project_tree`` (in place: ``new`` is the step's own result, which
        neither the optimizer's state nor L-BFGS's history holds), then the candidate
        takes ``new`` if the loss is finite, and the best iterate the candidate from before
        the step if the loss is finite and below the best value."""
        if boxed:
            new = self._project_tree(new, box)
        value = value.to(best_vals[0].dtype)
        finite = torch.isfinite(value)
        improved = finite & (value < best_vals[0])
        for k, leaf in tree.items():
            best[k].copy_(torch.where(improved, leaf, best[k]))
            leaf.copy_(torch.where(finite, new[k], leaf))
        best_vals[1].copy_(torch.where(improved, value, best_vals[0]))
        best_vals.reverse()

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
        vtype = acc_dtype(candidate)
        best_vals = [torch.full((num_trials,), float("inf"), dtype=vtype, device=candidate.device),
                     torch.empty(num_trials, dtype=vtype, device=candidate.device)]
        # the user gradient is taken inside the objective: the outer graph needs no parameter
        params = [{k: v.detach() for k, v in model.params.items()} for model in rec_models]
        # each trial's augmentation generators, in trial order: a trial's draws are the ones
        # it would make through the single step
        generators = [self._augmentation_generators(candidate.device) for _ in range(num_trials)] \
            if self.augmentations else []

        def step(iteration):
            x = candidate.detach().requires_grad_(True)
            draws = [self._draw_augmentations(x.shape[1:], pair) for pair in generators] or None
            value, task_loss = self._trial_losses(x, params, rec_models, targets, labels, draws)
            grad, = torch.autograd.grad(value.sum(), x)
            stats["objective_evaluations"] = stats.get("objective_evaluations", 0) + num_trials
            grad = self.transform_grads(grad, iteration, max_iterations, with_sign=False, per_trial=True)
            value = value.detach().to(vtype)
            mode = self._sign_mode()
            adam_box_step_trials(candidate, grad.contiguous(), state["mu"], state["nu"], best,
                                 *box, value, *best_vals, optimizer.advance(state, candidate.dtype), signed=mode,
                                 boxed=bool(cfg_optim.boxed),
                                 soft_scale=soft_sign_scalars(iteration, max_iterations) if mode == "soft" else None)
            best_vals.reverse()
            return value, task_loss

        run_state = self._run_state(dict(data=candidate), dict(data=state), dict(data=best), best_vals,
                                    candidate.device, [g for pair in generators for g in pair])
        self._optimize(step, [stats.setdefault(f"Trial_{t}_Val", []) for t in range(num_trials)],
                       max_iterations, stats, run_state)
        return best, best_vals[0].cpu().numpy()

    def _optimize(self, step, histories, max_iterations, stats, run_state=None, section=None):
        """Run ``step`` (which takes the iteration and returns the loss and task loss, a
        value per trial) until ``max_iterations`` or until no trial's loss is finite,
        reading the losses back into each trial's history every ``optim.callback`` steps.

        With ``attack.impl.checkpoint_path``, ``run_state`` (a ``_RunState``) is first
        restored from the file (from its ``section``, where trials share the file) where
        it fits, and the run goes on from the iteration saved; it is saved there after
        every ``checkpoint_every`` chunks. With ``trace_dir``, the second chunk runs under
        the profiler. With ``mixed_precision`` every step runs under
        ``bfloat16_operands``.

        A ``KeyboardInterrupt`` ends the run: the losses of the steps done are read back,
        ``stats["interrupted_at"]`` holds the number of steps done, and the trials keep
        their best iterates so far (an interrupt inside a step may leave that step's best
        iterate beside the previous best value)."""
        callback = int(self.cfg.optim.callback or 0) or max_iterations
        impl = self.cfg.get("impl") or {}
        path, every, trace_dir = impl.get("checkpoint_path"), int(impl.get("checkpoint_every", 0) or 0), \
            impl.get("trace_dir")
        iteration, chunks, wallclock = 0, 0, time.time()
        in_section = {} if section is None else dict(section=section)
        if path:
            restored = utils_checkpoint.load_attack_state(path, run_state.arrays(), **in_section)
            if restored is not None:
                arrays, iteration = restored
                run_state.restore(arrays)
                stats["resumed_at"] = iteration
        values = []  # the losses of the steps not yet read back

        def read_back():
            done = torch.stack(values).cpu().numpy().reshape(len(values), len(histories))
            for history, trial_values in zip(histories, done.T):
                history.extend(trial_values.tolist())
            values.clear()
            return done

        precision = bfloat16_operands if impl.get("mixed_precision") else contextlib.nullcontext

        def chunk():
            nonlocal iteration
            task_losses = []
            for _ in range(min(callback, max_iterations - iteration)):
                with precision():
                    value, task_loss = step(iteration)
                values.append(value)
                task_losses.append(task_loss)
                iteration += 1
            return read_back(), task_losses

        try:
            while iteration < max_iterations:
                if trace_dir and chunks == 1:
                    done, task_losses = self._traced(chunk, str(trace_dir), iteration, stats)
                else:
                    done, task_losses = chunk()
                chunks += 1
                now = time.time()
                log.info(f"| It: {iteration} | Rec. loss: {done[-1].mean():2.4f} | "
                         f"Task loss: {float(task_losses[-1].mean()):2.4f} | T: {now - wallclock:4.2f}s | "
                         f"{done.size / max(now - wallclock, 1e-9):,.1f} it/s")
                wallclock = now
                if path and every and chunks % every == 0:
                    utils_checkpoint.save_attack_state(path, run_state.arrays(), iteration, **in_section)
                if not np.isfinite(done[-1]).any():
                    log.info(f"Recovery loss is non-finite in iteration {iteration}. "
                             f"Cancelling reconstruction!")
                    break
        except KeyboardInterrupt:  # as the JAX package: return the best so far
            if values:
                read_back()
            stats["interrupted_at"] = iteration
            log.info(f"Recovery interrupted manually at iteration {iteration}; "
                     f"returning best-so-far candidates.")
        if trace_dir and chunks < 2:
            log.warning(f"No trace written to {trace_dir}: the run had {chunks} chunk(s), and the trace takes "
                        f"the second.")

    def _traced(self, chunk, trace_dir, iteration, stats):
        """``chunk()`` under ``torch.profiler`` (the host, and the card where the attack
        runs there), written as a Chrome trace into ``trace_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.setup["device"].type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as profiler:
            result = chunk()  # ends in the losses' read-back, which waits for the card
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"attack_chunk_{iteration}.json")
        profiler.export_chrome_trace(path)
        stats["trace_file"] = path
        log.info(f"Saved a profiler trace of one attack chunk to {path}.")
        return result

    # ---------------------------------------------------------------- scoring

    def _score_all_trials(self, best_trials, labels, rec_models, shared_data):
        """Score every trial (a tree with a leading trial axis) with cfg.restarts.scoring
        (reference optimization_based_attack.py:846-903)."""
        scoring = self.cfg.restarts.scoring
        num_trials = best_trials["data"].shape[0]
        trees = [{k: v[t] for k, v in best_trials.items()} for t in range(num_trials)]
        if scoring in ("euclidean", "cosine-similarity"):
            objective = Euclidean() if scoring == "euclidean" else CosineSimilarity()
            objective.initialize(self.loss_fn, rec_models[0].module,
                                 self._local_hyperparams(shared_data[0]["metadata"]), self.cfg.impl)
            scores = []
            for tree in trees:
                total = 0.0
                for model, data in zip(rec_models, shared_data):
                    target = tuple(data["gradients"][k] for k in model.params)
                    obj, _ = objective(model.params, model.buffers, target, tree["data"],
                                       self._effective_labels(tree, labels), bn_train=model.bn_train)
                    total = total + obj.detach()
                scores.append(float(total))
        elif scoring in ("TV", "total-variation"):
            tv = TotalVariation(scale=1.0)
            scores = [float(tv(tree["data"].contiguous())) for tree in trees]
        else:
            raise NotImplementedError(f"Scoring {scoring} is not ported yet.")
        scores = np.asarray(scores)
        return np.where(np.isfinite(scores), scores, np.inf)

    def _select_optimal_reconstruction(self, best_trials, scores, stats):
        optimal_index = int(np.argmin(scores))
        stats["opt_value"] = float(scores[optimal_index])
        if np.isfinite(scores[optimal_index]):
            log.info(f"Optimal candidate solution with rec. loss {scores[optimal_index]:2.4f} "
                     f"selected (trial {optimal_index}).")
            return {k: v[optimal_index] for k, v in best_trials.items()}
        log.info("No valid reconstruction could be found.")
        return {k: torch.zeros_like(v[0]) for k, v in best_trials.items()}


def _trial_slice(tree, t):
    """Trial t's entries of a tree (dicts, tuples, lists) of tensors stacked on the
    trials axis; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[t]
    if isinstance(tree, dict):
        return {k: _trial_slice(v, t) for k, v in tree.items()}
    return type(tree)(_trial_slice(v, t) for v in tree)


class _LBFGSState:
    """An L-BFGS run's state as a ``_RunState`` accessor: its named arrays
    (``LBFGS.state_arrays``) and their restore."""

    def __init__(self, optimizer, state):
        self.optimizer, self.state = optimizer, state

    def get(self):
        return self.optimizer.state_arrays(self.state)

    def set(self, arrays):
        self.optimizer.load_state_arrays(self.state, arrays)


class _RunState:
    """What a checkpoint holds of a run: named slots (container, key), each holding a
    tensor (restored in place), an int (an optimizer's step count) or a generator, and
    accessors whose ``get`` gives named arrays under a prefix and whose ``set`` takes
    them back."""

    def __init__(self):
        self.slots = {}
        self.accessors = {}

    def add(self, name, container, key):
        self.slots[name] = (container, key)

    def add_accessor(self, prefix, accessor):
        self.accessors[prefix] = accessor

    def add_tree(self, prefix, tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_tree(f"{prefix}/{key}", value)
            else:
                self.add(f"{prefix}/{key}", tree, key)

    def arrays(self) -> dict:
        """name -> numpy array: a copy of every slot's value (a generator's state bytes)."""
        out = {}
        for name, (container, key) in self.slots.items():
            value = container[key]
            if isinstance(value, torch.Tensor):
                out[name] = value.detach().cpu().numpy()
            elif isinstance(value, torch.Generator):
                out[name] = value.get_state().numpy()
            else:
                out[name] = np.asarray(value)
        for prefix, accessor in self.accessors.items():
            for name, value in accessor.get().items():
                out[f"{prefix}/{name}"] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
                    else np.asarray(value)
        return out

    def restore(self, arrays: dict) -> None:
        for prefix, accessor in self.accessors.items():
            accessor.set({name[len(prefix) + 1:]: value for name, value in arrays.items()
                          if name.startswith(prefix + "/")})
        for name, (container, key) in self.slots.items():
            value, saved = container[key], arrays[name]
            if isinstance(value, torch.Tensor):
                value.copy_(torch.from_numpy(saved))
            elif isinstance(value, torch.Generator):
                value.set_state(torch.from_numpy(saved.copy()))
            else:
                container[key] = type(value)(saved)
