"""Gradient-matching objectives (counterpart of ``breaching_tpu/attacks/auxiliaries/objectives.py``).

The simulated user gradient is ``torch.autograd.grad(..., create_graph=True)`` of
the task loss through ``torch.func.functional_call``, so the attack's gradient
with respect to the candidate is a double backward, which cuDNN runs for the
convolutions. Gradients are tuples of tensors in the order of the parameter dict; a
parameter the candidate does not reach (a text model's embedding table, when the
candidate is embeddings) has a zero gradient, as under ``jax.grad``.

For a fedAVG user (``initialize`` with its local hyperparameters) the simulated
update is the parameter delta after K local SGD steps, unrolled: each step's
gradient is taken with ``create_graph=True`` and the next step's parameters are the
non-leaf tensors p - lr·g, so the attack's gradient runs back through all K steps
(reference ``breaching_tpu/attacks/auxiliaries/objectives.py:166-202``).

Every objective of the JAX package's ``objective_lookup`` is here. Gradients are
summed leaf by leaf in the parameter dict's order; only ``tag-euclidean`` depends on
the order, and it weights each leaf by its place in the JAX package's pytree leaf
order (``model_preparation.jax_leaf_ranks``). ``fused-euclidean`` runs through B1 and
``b2_axpby`` (``ops.fused_euclidean``). The Pearlmutter objectives are the JAX
package's exact linearizations, with ``.detach()`` for ``stop_gradient``. A
``capture`` dict handed to ``__call__`` receives the model's pre-head features and
train-mode BatchNorm statistics from the same forward pass, for the regularizers
that read them.

With ``attack.impl.grad_accum`` = A > 1 a fedSGD user's gradient and task loss are
the means over A micro-batches of the candidate, as the JAX package forms them
(``breaching_tpu/attacks/auxiliaries/objectives.py:98-154``), for memory: each
micro-batch's gradient is one ``_MicroBatchGradient``, which keeps no graph in the
forward and recomputes the micro-batch's double-backward graph in the attack's
backward, so that one micro-batch's activations are alive at a time, as under the
JAX package's ``jax.checkpoint``. (``torch.utils.checkpoint`` with
``use_reentrant=False`` carries the double backward too, but recomputes each
micro-batch's forward once more inside the forward: three forwards where this takes
two.) As in the JAX package, an A that does not divide the batch falls back to the
largest divisor below it, and the knob is ignored, with a warning, under regularizers
that capture the model's intermediates, under BatchNorm in train mode and for a
fedAVG user.

``trials`` computes the objective for T trials at once (restarts, and the fleet of
``reconstruct_fleet``): the user gradient of every trial is
``torch.func.vmap(torch.func.grad(task loss))`` over the candidates' leading trial
axis with the parameters shared, and the distance is reduced per trial, so that one
``torch.autograd.grad`` of the trials' sum gives each trial's attack gradient, as the
JAX package vmaps its objective over the trials. Everything the single evaluation takes
runs there too: BatchNorm in train mode (each trial's own batch statistics, the running
statistics left unwritten: ``train=layers.TRIALS``), a ``capture`` of the
intermediates (returned out of the vmapped function, each leaf with a leading trial
axis), ``grad_accum`` (the same micro-batches, each one ``_MicroBatchGradient`` over all
trials) and a fedAVG user's unrolled local steps (``torch.func.grad`` a step, inside the
vmap).

With ``attack.impl.dtype`` bfloat16 or float16 the simulated user pass runs in that type
(``compute_dtype``, the JAX package's ``_cast_tree``, objectives.py:56-86): the
parameters, buffers and candidate are cast to it, single-step, micro-batched and
unrolled alike, and the user's update comes out in it; the logits go to float32 before
the loss, and every distance accumulates in float32 (``_acc``), so the fused objectives
see half-precision gradients beside float32 targets. The candidate itself stays in its
own type: its cotangent comes back through the cast. float64 and any other value cast
nothing. Without a compute dtype the pass runs in the promotion of the candidate's and
the parameters' types, as JAX's type promotion gives it: a bfloat16 candidate
(``case.impl.dtype=bfloat16``) through float32 parameters computes in float32.
"""

from __future__ import annotations

import logging

import torch
from torch.func import functional_call, grad as func_grad, vmap

from ...cases.models.layers import TRIALS
from ...cases.models.model_preparation import jax_leaf_ranks
from ...ops import fused_cosine_similarity, fused_cosine_similarity_trials, fused_euclidean

log = logging.getLogger(__name__)


class _MicroBatchGradient(torch.autograd.Function):
    """(task loss, *parameter gradient) of one micro-batch (x, y) from ``grads_of(x, y,
    create_graph)``, differentiable with respect to x (and y, where y is soft labels).
    The forward keeps no graph; the backward rebuilds the micro-batch's graph with
    ``create_graph=True`` and runs the incoming cotangents back through it to x and y.
    ``grads_of`` is the single evaluation's ``torch.autograd.grad`` or the trials'
    ``vmap(grad(...))``: the same recomputation serves both."""

    @staticmethod
    def forward(ctx, grads_of, x, y):
        ctx.grads_of = grads_of
        ctx.save_for_backward(x, y)
        with torch.enable_grad():
            return tuple(t.detach() for t in grads_of(x.detach(), y.detach(), False))

    @staticmethod
    def backward(ctx, *bars):
        needs = ctx.needs_input_grad[1:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outputs = ctx.grads_of(*inputs, True)
            wanted = [t for t, need in zip(inputs, needs) if need]
            pairs = [(o, bar) for o, bar in zip(outputs, bars) if o.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [b for _, b in pairs]))
        return (None, *(next(got) if need else None for need in needs))


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x widened to float32 where it is half precision: the distances accumulate in
    float32 (the JAX package's ``_f32``), and the logits go to float32 before the loss
    (``outputs.astype(jnp.float32)``); other types stay as they are."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


class GradientLoss:
    """Base class: owns the task-gradient function and the distance."""

    def __init__(self, scale=1.0, task_regularization=0.0, **kwargs):
        self.scale = float(scale)
        self.task_regularization = float(task_regularization)
        self.local_hyperparams = None

    def initialize(self, loss_fn, model, local_hyperparams=None, cfg_impl=None):
        """``local_hyperparams``: None for a fedSGD user; for a fedAVG user its ``lr``,
        ``steps``, ``data_per_step`` and ``labels``, one row of sorted labels per step
        as a (steps, data_per_step) tensor."""
        self.loss_fn = loss_fn
        self.model = model
        self.local_hyperparams = local_hyperparams
        self.grad_accum = int((cfg_impl or {}).get("grad_accum", 1) or 1)
        name = str((cfg_impl or {}).get("dtype", "float"))
        self.compute_dtype = torch.bfloat16 if name in ("bfloat16", "bf16") else (
            torch.float16 if name in ("float16", "fp16") else None)
        self._warned = set()

    def _warn_once(self, message):
        if message not in self._warned:
            self._warned.add(message)
            log.warning(message)

    def _work_dtype(self, params, candidate):
        """The type of the simulated user pass: the compute dtype, else the promotion of
        the candidate's type and the parameters'."""
        if self.compute_dtype is not None:
            return self.compute_dtype
        first = next(iter(params.values()), None)
        return candidate.dtype if first is None else torch.promote_types(candidate.dtype, first.dtype)

    @staticmethod
    def _cast(tree, dtype):
        """Every floating tensor of the dict ``tree`` in ``dtype`` (``_cast_tree``);
        integers and tensors already of that type stay."""
        return {k: v.to(dtype) if v.is_floating_point() and v.dtype != dtype else v for k, v in tree.items()}

    def _micro_batches(self, n, capture, bn_train):
        """The number of micro-batches of a fedSGD user's gradient over n candidates."""
        accum = self.grad_accum
        if accum > 1 and n % accum != 0:
            # the largest divisor: dropping the knob would bring back the memory it saves
            adjusted = next(d for d in range(min(accum, n), 0, -1) if n % d == 0)
            self._warn_once(f"grad_accum={accum} does not divide the batch of {n}; using grad_accum={adjusted}.")
            accum = adjusted
        if accum > 1 and (capture is not None or bn_train):
            self._warn_once("grad_accum ignored: capture-intermediates regularizers and bn-train mode need "
                            "the full batch in one pass.")
            return 1
        return accum

    def grad_fn(self, params, buffers, candidate, labels, bn_train=False, capture=None):
        """The user's update for the candidate data, differentiable: the parameter
        gradient, or for a fedAVG user the parameter delta; with the task loss (of the
        last local step). A ``capture`` dict receives the forward's intermediates (for a
        fedAVG user, from one extra forward of the whole batch, as the JAX package does)."""
        if bn_train:  # train-mode BatchNorm updates the buffers it is given in place
            buffers = {k: v.clone() for k, v in buffers.items()}
        work = self._work_dtype(params, candidate)
        params, buffers = self._cast(params, work), self._cast(buffers, work)
        candidate = candidate.to(work)
        if self.local_hyperparams is not None:
            if self.grad_accum > 1:
                self._warn_once("grad_accum ignored: the multi-step (fedavg) simulated update unrolls full "
                                "local batches per step.")
            if capture is not None:
                functional_call(self.model, {**params, **buffers}, (candidate,),
                                dict(train=bn_train, capture=capture))
            return self._local_steps(params, buffers, candidate, bn_train)
        accum = self._micro_batches(candidate.shape[0], capture, bn_train)
        if accum > 1:
            return self._micro_batched(params, buffers, candidate, labels, accum)
        outputs = functional_call(self.model, {**params, **buffers}, (candidate,),
                                  dict(train=bn_train, capture=capture))
        task_loss = self.loss_fn(_acc(outputs), labels)
        grads = torch.autograd.grad(task_loss, tuple(params.values()), create_graph=True, allow_unused=True,
                                    materialize_grads=True)
        return grads, task_loss

    def _micro_batched(self, params, buffers, candidate, labels, accum):
        """The user's gradient and task loss as means over ``accum`` equal micro-batches,
        BatchNorm in eval mode (``_MicroBatchGradient``)."""
        names = tuple(params)
        values = tuple(v.detach() for v in params.values())

        def grads_of(x, y, create_graph):
            leaves = tuple(p.detach().requires_grad_(True) for p in values)
            outputs = functional_call(self.model, {**dict(zip(names, leaves)), **buffers}, (x,))
            loss = self.loss_fn(_acc(outputs), y)
            return (loss, *torch.autograd.grad(loss, leaves, create_graph=create_graph, allow_unused=True,
                                               materialize_grads=True))

        return self._accumulate(grads_of, candidate, labels, accum, 0)

    @staticmethod
    def _accumulate(grads_of, candidate, labels, accum, dim):
        """Means over ``accum`` equal micro-batches of ``grads_of``'s (loss, *grads),
        each one ``_MicroBatchGradient``; the batch is ``dim`` of candidate and labels."""
        size = candidate.shape[dim] // accum
        loss_sum = grad_sum = None
        for x, y in zip(candidate.split(size, dim), labels.split(size, dim)):
            loss, *grads = _MicroBatchGradient.apply(grads_of, x, y)
            if grad_sum is None:
                loss_sum, grad_sum = loss, grads
            else:
                loss_sum, grad_sum = loss_sum + loss, [a + b for a, b in zip(grad_sum, grads)]
        return tuple(g / accum for g in grad_sum), loss_sum / accum

    def _local_steps(self, params, buffers, candidate, bn_train):
        """The fedAVG user's K local SGD steps, unrolled: step k trains on the
        candidate's rows (k·m + j) mod N, j < m, under the shared sorted labels of
        that step (not the attack's labels), as the user does. Returns the delta and
        the last step's task loss."""
        hp = self.local_hyperparams
        lr, steps, per_step = float(hp["lr"]), int(hp["steps"]), int(hp["data_per_step"])
        num_points = candidate.shape[0]
        initial = tuple(params.values())
        current = initial
        for k in range(steps):
            batch = self._step_batch(candidate, k, per_step, num_points)
            outputs = functional_call(self.model, {**dict(zip(params, current)), **buffers}, (batch,),
                                      dict(train=bn_train))
            task_loss = self.loss_fn(_acc(outputs), hp["labels"][k])
            grads = torch.autograd.grad(task_loss, current, create_graph=True, allow_unused=True,
                                        materialize_grads=True)
            current = tuple(p - lr * g for p, g in zip(current, grads))
        return tuple(p - p0 for p, p0 in zip(current, initial)), task_loss

    @staticmethod
    def _step_batch(candidate, k, per_step, num_points):
        """Local step k's rows (k·m + j) mod N of the candidate: a view where they are
        contiguous (no gather, and no scatter in the backward)."""
        start = k * per_step % num_points
        if start + per_step <= num_points:
            return candidate[start:start + per_step]
        return candidate[[(start + j) % num_points for j in range(per_step)]]

    def __call__(self, params, buffers, target_grads, candidate, labels, bn_train=False, capture=None):
        grads, task_loss = self.grad_fn(params, buffers, candidate, labels, bn_train=bn_train,
                                        capture=capture)
        objective = self.gradient_based_loss(grads, target_grads)
        if self.task_regularization != 0:
            objective = objective + self.task_regularization * task_loss
        return objective, task_loss.detach()

    def trials(self, params, buffers, target_grads, candidates, labels, bn_train=False, capture=None):
        """The objective of T trials at once, for candidates (T, N, C, H, W), labels
        (T, N) and ``target_grads`` with a leading trial axis (T, ...) in the order of
        ``params``: (T,) values, differentiable with respect to the candidates, and
        (T,) task losses. ``params`` and ``buffers`` are shared by the trials; with
        ``bn_train`` each trial's BatchNorm takes its own batch statistics, and a
        ``capture`` dict receives each trial's intermediates, stacked on a leading axis."""
        work = self._work_dtype(params, candidates)
        params = self._cast({k: v.detach() for k, v in params.items()}, work)
        buffers = self._cast(buffers, work)
        candidates = candidates.to(work)
        want_capture = capture is not None
        bn_train = TRIALS if bn_train else False  # each trial's batch statistics, the buffers unwritten
        if self.local_hyperparams is not None:
            grads, task_losses, captured = self._local_steps_trials(params, buffers, candidates, bn_train,
                                                                    want_capture)
        else:
            grads, task_losses, captured = self._grads_trials(params, buffers, candidates, labels, bn_train,
                                                              want_capture)
        if want_capture:
            capture.update(captured)
        objective = self.trial_distances(grads, target_grads)
        if self.task_regularization != 0:
            objective = objective + self.task_regularization * task_losses
        return objective, task_losses.detach()

    def _grads_trials(self, params, buffers, candidates, labels, bn_train, want_capture):
        """Each trial's parameter gradient and task loss: ``vmap(grad(task loss))``, over
        ``grad_accum`` micro-batches where it applies."""
        names = tuple(params)

        def task_loss(p, x, y):
            captured = {} if want_capture else None
            outputs = functional_call(self.model, {**p, **buffers}, (x,), dict(train=bn_train, capture=captured))
            loss = self.loss_fn(_acc(outputs), y)
            return loss, (loss, captured or {})

        accum = self._micro_batches(candidates.shape[1], {} if want_capture else None, bn_train)
        if accum > 1:
            def grads_of(x, y, create_graph):
                grads, (losses, _) = vmap(func_grad(task_loss, has_aux=True), in_dims=(None, 0, 0))(params, x, y)
                return (losses, *(grads[k] for k in names))

            grads, losses = self._accumulate(grads_of, candidates, labels, accum, 1)
            return grads, losses, {}
        grads, (losses, captured) = vmap(func_grad(task_loss, has_aux=True), in_dims=(None, 0, 0))(
            params, candidates, labels)
        return tuple(grads[k] for k in names), losses, captured

    def _local_steps_trials(self, params, buffers, candidates, bn_train, want_capture):
        """Each trial's fedAVG delta through the unrolled local steps (``_local_steps``
        with ``torch.func.grad`` a step, inside the vmap over the trials) and its last
        step's task loss; with ``want_capture`` the intermediates of one extra forward of
        each trial's whole batch."""
        if self.grad_accum > 1:
            self._warn_once("grad_accum ignored: the multi-step (fedavg) simulated update unrolls full "
                            "local batches per step.")
        hp = self.local_hyperparams
        lr, steps, per_step = float(hp["lr"]), int(hp["steps"]), int(hp["data_per_step"])
        names = tuple(params)

        def delta(x):
            captured = {} if want_capture else None
            if want_capture:
                functional_call(self.model, {**params, **buffers}, (x,), dict(train=bn_train, capture=captured))
            current = params
            for k in range(steps):
                batch = self._step_batch(x, k, per_step, x.shape[0])

                def step_loss(p):
                    outputs = functional_call(self.model, {**p, **buffers}, (batch,), dict(train=bn_train))
                    loss = self.loss_fn(_acc(outputs), hp["labels"][k])
                    return loss, loss

                grads, loss = func_grad(step_loss, has_aux=True)(current)
                current = {n: current[n] - lr * grads[n] for n in names}
            return tuple(current[n] - params[n] for n in names), loss, captured or {}

        return vmap(delta)(candidates)

    def gradient_based_loss(self, grads, target_grads):
        raise NotImplementedError

    def trial_distances(self, grads, target_grads):
        """(T,) distances of T trials' gradients (each with a leading trial axis) from
        their targets: ``gradient_based_loss`` of each trial in turn."""
        return torch.stack([self.gradient_based_loss(tuple(g[t] for g in grads),
                                                     tuple(d[t] for d in target_grads))
                            for t in range(grads[0].shape[0])])


def _per_trial_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.dim())))


def _dot(a, b):
    return sum((_acc(x) * _acc(y)).sum() for x, y in zip(a, b))


def _sqnorm(a):
    return sum((_acc(x) * _acc(x)).sum() for x in a)


class Euclidean(GradientLoss):
    def gradient_based_loss(self, grads, target_grads):
        return 0.5 * _sqnorm([g - t for g, t in zip(grads, target_grads)]) * self.scale

    def __repr__(self):
        return f"Euclidean loss with scale={self.scale} and task reg={self.task_regularization}"


class L1Loss(GradientLoss):
    def gradient_based_loss(self, grads, target_grads):
        return 0.5 * sum(_acc(g - t).abs().sum() for g, t in zip(grads, target_grads)) * self.scale

    def __repr__(self):
        return f"L1 loss with scale={self.scale} and task reg={self.task_regularization}"


class CosineSimilarity(GradientLoss):
    def gradient_based_loss(self, grads, target_grads):
        product = _dot(grads, target_grads)
        rec_norm = _sqnorm(grads)
        data_norm = _sqnorm(target_grads)
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def trial_distances(self, grads, target_grads):
        grads, target_grads = [_acc(g) for g in grads], [_acc(t) for t in target_grads]
        product = sum(_per_trial_sum(g * t) for g, t in zip(grads, target_grads))
        rec_norm = sum(_per_trial_sum(g * g) for g in grads)
        data_norm = sum(_per_trial_sum(t * t) for t in target_grads)
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def __repr__(self):
        return f"Cosine Similarity with scale={self.scale} and task reg={self.task_regularization}"


class AngularSimilarity(CosineSimilarity):
    def __init__(self, scale=1.0, task_regularization=0.0, fudge_factor=1e-7, **kwargs):
        super().__init__(scale, task_regularization)
        self.fudge_factor = fudge_factor

    def gradient_based_loss(self, grads, target_grads):
        cosine = _dot(grads, target_grads) / (torch.sqrt(_sqnorm(grads)) * torch.sqrt(_sqnorm(target_grads))
                                              + 1e-12)
        angle = torch.arccos(torch.clamp(cosine, -1 + self.fudge_factor, 1 - self.fudge_factor))
        return angle / torch.pi * self.scale

    def __repr__(self):
        return f"Angular Similarity with scale={self.scale} and task reg={self.task_regularization}"


class MaskedCosineSimilarity(GradientLoss):
    def __init__(self, scale=1.0, mask_value=1e-6, task_regularization=0.0, **kwargs):
        super().__init__(scale, task_regularization)
        self.mask_value = float(mask_value)

    def gradient_based_loss(self, grads, target_grads):
        product = rec_norm = data_norm = 0.0
        for rec, data in zip(grads, target_grads):
            rec, data = _acc(rec), _acc(data)
            mask = (data.abs() > self.mask_value).to(rec.dtype)
            product = product + (rec * mask * data).sum()
            rec_norm = rec_norm + ((rec * mask) * (rec * mask)).sum()
            data_norm = data_norm + ((data * mask) * (data * mask)).sum()
        return (1.0 - product / (torch.sqrt(rec_norm) * torch.sqrt(data_norm) + 1e-12)) * self.scale

    def __repr__(self):
        return f"Masked Cosine Similarity with scale={self.scale}, mask={self.mask_value}"


class FastCosineSimilarity(GradientLoss):
    """Cosine similarity with no gradient through the candidate gradient's norm."""

    def gradient_based_loss(self, grads, target_grads):
        rec_norm = _sqnorm(grads).detach()
        return (1.0 - _dot(grads, target_grads) / (torch.sqrt(rec_norm) * torch.sqrt(_sqnorm(target_grads))
                                                   + 1e-12)) * self.scale

    def __repr__(self):
        return f"Fast Cosine Similarity with scale={self.scale}"


class EuclideanTag(GradientLoss):
    """Euclidean + layer-weighted L1 (TAG, Deng et al.): leaf i of the JAX package's
    pytree leaf order of L leaves weighs (L - i) / L ("linear"), its softmax share
    over the same ramp relative to the first ("exp"), or 1."""

    def __init__(self, scale=1.0, task_regularization=0.0, tag_scale=0.1, scale_scheme="linear", **kwargs):
        super().__init__(scale, task_regularization)
        self.tag_scale = float(tag_scale)
        self.scale_scheme = scale_scheme
        self.leaf_ranks = None

    def initialize(self, loss_fn, model, local_hyperparams=None, cfg_impl=None):
        super().initialize(loss_fn, model, local_hyperparams, cfg_impl)
        self.leaf_ranks = jax_leaf_ranks(model)

    def _weights(self, num):
        ramp = torch.arange(num, 0, -1, dtype=torch.float32)
        if self.scale_scheme == "linear":
            return ramp / num
        if self.scale_scheme == "exp":
            w = torch.softmax(ramp, dim=0)
            return w / w[0]
        return torch.ones(num)

    def gradient_based_loss(self, grads, target_grads):
        weights = self._weights(len(grads)).tolist()
        total = 0.0
        for rank, g, t in sorted(zip(self.leaf_ranks, grads, target_grads), key=lambda e: e[0]):
            diff = _acc(g - t)
            total = total + (diff * diff).sum() + self.tag_scale * weights[rank] * diff.abs().sum()
        return 0.5 * total * self.scale

    def __repr__(self):
        return f"TAG loss with scale={self.scale}, scheme={self.scale_scheme}, tag_scale={self.tag_scale}"


class PearlmutterEuclidean(GradientLoss):
    """The JAX package's exact linearized euclidean matching: value 0.5 |r|^2 with
    r = g - g* detached; its gradient J^T r through the linear term."""

    def gradient_based_loss(self, grads, target_grads):
        residual = [(g - t).detach() for g, t in zip(grads, target_grads)]
        linear = _dot(residual, grads)
        value = 0.5 * _sqnorm(residual)
        return (linear - linear.detach() + value) * self.scale

    def __repr__(self):
        return f"Pearlmutter-style exact-HVP Euclidean loss with scale={self.scale}"


class PearlmutterCosine(GradientLoss):
    """The JAX package's exact linearized cosine matching."""

    def gradient_based_loss(self, grads, target_grads):
        product = _dot(grads, target_grads)
        rec_norm = torch.sqrt(_sqnorm(grads).detach())
        data_norm = torch.sqrt(_sqnorm(target_grads))
        value = 1.0 - product / (rec_norm * data_norm + 1e-12)
        direction = [(-d / (rec_norm * data_norm + 1e-12) + g * product / (rec_norm ** 3 * data_norm + 1e-12)).detach()
                     for g, d in zip(grads, target_grads)]
        linear = _dot(direction, grads)
        return (linear - linear.detach() + value.detach()) * self.scale

    def __repr__(self):
        return f"Pearlmutter-style exact-HVP cosine loss with scale={self.scale}"


class _FlatTarget:
    """The target gradient flattened once for as long as it is the same object (it is
    fixed for a whole attack): one row per trial for ``trials``."""

    def _flat_target(self, target_grads, num_trials=None):
        if getattr(self, "_target", None) is not target_grads:
            self._target = target_grads
            self._flat = (torch.cat([t.reshape(-1) for t in target_grads]) if num_trials is None
                          else torch.cat([t.reshape(num_trials, -1) for t in target_grads], dim=1))
        return self._flat


def _flat_trials(grads):
    """T trials' gradients (each leaf with a leading trial axis) as one (T, n) stack."""
    num_trials = grads[0].shape[0]
    return torch.cat([g.reshape(num_trials, -1) for g in grads], dim=1)


class FusedCosineSimilarity(_FlatTarget, CosineSimilarity):
    """Cosine matching over the flattened gradient through kernels B1 (one-pass
    sums) and B2 (its backward), ``breaching_tpu_torch/ops/matching.py``. For T
    trials, one B1 launch per trial on that trial's row of the flattened gradient and
    one B2 launch for all of them (``fused_cosine_similarity_trials``)."""

    def gradient_based_loss(self, grads, target_grads):
        rec = torch.cat([g.reshape(-1) for g in grads])
        return fused_cosine_similarity(rec, self._flat_target(target_grads)) * self.scale

    def trial_distances(self, grads, target_grads):
        rec = _flat_trials(grads)
        return fused_cosine_similarity_trials(rec, self._flat_target(target_grads, rec.shape[0])) * self.scale

    def __repr__(self):
        return f"Fused (CUDA) Cosine Similarity with scale={self.scale}"


class FusedEuclidean(_FlatTarget, Euclidean):
    """Euclidean matching over the flattened gradient through B1 (the forward) and
    ``b2_axpby`` (the backward): one launch of each per evaluation, and per trial."""

    def gradient_based_loss(self, grads, target_grads):
        rec = torch.cat([g.reshape(-1) for g in grads])
        return fused_euclidean(rec, self._flat_target(target_grads)) * self.scale

    def trial_distances(self, grads, target_grads):
        """Each trial's row of the flattened gradient against its row of the target,
        flattened once for the attack (the per-trial route would pass a new tuple of
        target rows each time, and flatten the target again)."""
        rec = _flat_trials(grads)
        data = self._flat_target(target_grads, rec.shape[0])
        return torch.stack([fused_euclidean(r, d) for r, d in zip(rec.unbind(), data.unbind())]) * self.scale

    def __repr__(self):
        return f"Fused (CUDA) Euclidean with scale={self.scale}"


objective_lookup = {
    "euclidean": Euclidean,
    "fused-euclidean": FusedEuclidean,
    "fused-cosine-similarity": FusedCosineSimilarity,
    "cosine-similarity": CosineSimilarity,
    "masked-cosine-similarity": MaskedCosineSimilarity,
    "fast-cosine-similarity": FastCosineSimilarity,
    "angular": AngularSimilarity,
    "l1": L1Loss,
    "pearlmutter-loss": PearlmutterEuclidean,
    "pearlmutter-cosine": PearlmutterCosine,
    "tag-euclidean": EuclideanTag,
}
