"""The fedSGD and fedAVG users and the secure-aggregation silo (counterparts of
``breaching_tpu/cases/users.py`` ``UserSingleStep``, ``UserMultiStep`` and
``MultiUserAggregate``).

The fedSGD update is ``torch.autograd.grad`` of the task loss over the payload's
parameters, evaluated with ``torch.func.functional_call`` on the user's copy of
the architecture; the fedAVG update is the parameter delta after several local SGD
steps of that kind. BatchNorm follows the JAX package: with server-provided buffers
the model runs in eval mode on them; without, it runs in train mode and the
user's running statistics (cumulative, so exactly its batch statistics after one
step, and carried from one local step to the next) are shared.

On text (token ids, ``input_ids``) every user takes the same gradients of the task loss
on the ids, which stay int64, and shares ``data_key="input_ids"``. A fedAVG user's per-step
labels, each (data per step, seq), are shared sorted along their last axis, each sequence's
tokens in order, as the JAX package shares them; a single-step silo shares the sorted
labels of all its users' tokens flattened into one row, a multi-step silo each sequence's
sorted, as the JAX package's two forms do.
``print``, ``print_with_confidence`` and ``print_and_mark_correct`` print a user's
token ids, decoded where a tokenizer is given.

``MultiUserAggregate`` shares only the mean of its users' updates, as secure aggregation
would. A single-step silo sums the users' fedSGD gradients one user at a time and divides
by their number once (the JAX package's scan: one gradient tree in memory for any silo
size); a multi-step silo keeps the running mean acc + (delta - acc) * (1 / (i + 1)) of
its fedAVG users' deltas, as the JAX package's loop does. Each user is its own
``UserSingleStep`` or ``UserMultiStep`` with its own dataloader and its own noise
generator. Under ``torchrun`` a single-step silo whose users divide over the ranks
splits them (``_aggregate_single_step``).

Local differential privacy (``user.local_diff_privacy``), as the JAX package's users
apply it:
- the fedSGD user adds ``input_noise`` times a standard draw to its inputs, then with
  ``per_example_clipping`` C > 0 takes each example's gradient alone, scales it by
  min(1, C / (|g| + 1e-6)) (|g| over all parameters) and averages them (the shared
  BatchNorm statistics come from a second, full-batch forward pass), and last adds
  ``gradient_noise`` times a standard draw to every parameter's gradient;
- the fedAVG user clips the batch gradient of each local step to C the same way and
  adds gradient noise at each step; like the JAX package's, it adds no input noise.
The draws are ``sample_noise``'s, standard normal (``gaussian``) or Laplace of unit
scale (``laplacian``, variance 2, as ``jax.random.laplace``), from a generator on the
user's device seeded once from the setup's generator. The user's arithmetic is
float32 throughout (``system_startup`` turns TF32 off), as the JAX user runs at
"highest" precision.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import functional_call

from ..parallel import _dist
from ..utils import model_dtype
from .data import construct_dataloader

log = logging.getLogger(__name__)
NOISE_DISTRIBUTIONS = ("gaussian", "laplacian")


def sample_noise(shapes, generator, distribution):
    """One standard draw of ``distribution`` for each shape, float32 on the generator's
    device: N(0, 1) (``gaussian``), or Laplace(0, 1) (``laplacian``) as
    ``jax.random.laplace`` forms it from u ~ U(-1 + eps/2, 1): sign(u) log1p(-|u|)."""
    device, draws = generator.device, []
    for shape in shapes:
        if distribution == "gaussian":
            draws.append(torch.randn(shape, generator=generator, device=device))
        else:
            u = torch.empty(shape, device=device).uniform_(-1.0 + torch.finfo(torch.float32).eps / 2, 1.0,
                                                          generator=generator)
            draws.append(torch.sign(u) * torch.log1p(-u.abs()))
    return draws


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every entry of an iterable of tensors."""
    return torch.sqrt(sum((g * g).sum() for g in grads))


def construct_user(model, loss_fn, cfg_case, setup):
    """User factory (reference: breaching/cases/users.py:13-28); a silo of
    ``multiuser_aggregate`` holds the users of ``range(*user_range)``."""
    cfg_user = cfg_case.user
    if cfg_user.user_type == "multiuser_aggregate":
        indices = list(range(*cfg_user.user_range))
        dataloaders = [construct_dataloader(cfg_case.data, cfg_case.impl, user_idx=idx) for idx in indices]
        return MultiUserAggregate(model, loss_fn, dataloaders, setup, indices, cfg_user)
    user_types = {"local_gradient": UserSingleStep, "local_update": UserMultiStep}
    if cfg_user.user_type not in user_types:
        raise NotImplementedError(f"User type {cfg_user.user_type} is not ported yet.")
    dataloader = construct_dataloader(cfg_case.data, cfg_case.impl, user_idx=cfg_user.user_idx)
    return user_types[cfg_user.user_type](model, loss_fn, dataloader, setup, cfg_user.user_idx, cfg_user)


def _sum_over_ranks(tensors: dict) -> dict:
    """The dict's tensors summed over the ranks of the process group (one all-reduce)."""
    flat = _dist.all_reduce_(torch.cat([t.reshape(-1) for t in tensors.values()]))
    return {k: part.view(t.shape) for (k, t), part in zip(tensors.items(), flat.split([t.numel() for t in
                                                                                     tensors.values()]))}


def _data_key(inputs: torch.Tensor) -> str:
    """The key the shared metadata names the data by: ``inputs`` for images, ``input_ids``
    for token ids."""
    return "inputs" if torch.is_floating_point(inputs) else "input_ids"


class UserSingleStep:
    """A fedSGD user sharing a single batch gradient."""

    def __init__(self, model, loss_fn, dataloader, setup, idx, cfg_user):
        self.model = model
        self.loss = loss_fn
        self.dataloader = dataloader
        self.setup = setup
        self.user_idx = idx
        self.cfg = cfg_user
        self.num_data_points = int(cfg_user.num_data_points)
        self.provide_labels = bool(cfg_user.provide_labels)
        self.provide_buffers = bool(cfg_user.provide_buffers)
        self.provide_num_data_points = bool(cfg_user.provide_num_data_points)
        ldp = cfg_user.local_diff_privacy
        self.gradient_noise = float(ldp.gradient_noise)
        self.input_noise = float(ldp.input_noise)
        self.noise_distribution = str(ldp.distribution)
        self.clip_value = float(ldp.get("per_example_clipping", 0.0))
        if (self.gradient_noise > 0 or self.input_noise > 0) and self.noise_distribution not in NOISE_DISTRIBUTIONS:
            raise ValueError(f"local_diff_privacy.distribution={self.noise_distribution} is not one of "
                             f"{NOISE_DISTRIBUTIONS}.")
        self.counted_queries = 0
        self.defense_repr = []
        if self.gradient_noise > 0:
            self.defense_repr.append(
                f"Defense: local {self.noise_distribution} gradient noise, scale {self.gradient_noise}.")
        if self.input_noise > 0:
            self.defense_repr.append(
                f"Defense: local {self.noise_distribution} input noise, scale {self.input_noise}.")
        if self.clip_value > 0:
            self.defense_repr.append(f"Defense: per-example gradient clipping at {self.clip_value}.")
        self._generator = None

    def __repr__(self):
        n = "\n"
        return f"""User (of type {self.__class__.__name__}):
    Number of data points: {self.num_data_points}
    Threat model: labels {self.provide_labels}, buffers {self.provide_buffers}, n {self.provide_num_data_points}
    Dataset: {self.dataloader.name}, user idx {self.user_idx}
    {n.join(self.defense_repr)}"""

    def _noise(self, shapes):
        """``sample_noise`` of the user's distribution, from its generator on its device,
        seeded from the setup's generator at the first draw."""
        if self._generator is None:
            seed = int(torch.randint(2 ** 62, (), generator=self.setup["generator"]))
            self._generator = torch.Generator(device=self.setup["device"]).manual_seed(seed)
        return sample_noise(shapes, self._generator, self.noise_distribution)

    def _clip_factor(self, norm):
        """min(1, C / (norm + 1e-6)), one float32 division as the JAX package's."""
        return torch.clamp(torch.full_like(norm, self.clip_value) / (norm + 1e-6), max=1.0)

    def _add_gradient_noise(self, grads: dict) -> dict:
        draws = self._noise([g.shape for g in grads.values()])
        return {k: g + self.gradient_noise * d for (k, g), d in zip(grads.items(), draws)}

    def clipped_gradient(self, params, buffers, inputs, labels, bn_train):
        """The per-example clipped gradient: each example's gradient alone (in train mode
        on its own batch statistics, with the running statistics updated on a copy that
        is dropped), scaled by min(1, C / (|g| + 1e-6)), then the mean over the examples.
        Returns (the gradients by name, the clipped per-example norms (N,))."""
        total, norms = None, []
        for i in range(inputs.shape[0]):
            current = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            example_buffers = {k: v.clone() for k, v in buffers.items()} if bn_train else buffers
            outputs = functional_call(self.model, {**current, **example_buffers}, (inputs[i:i + 1],),
                                      dict(train=bn_train))
            grads = torch.autograd.grad(self.loss(outputs, labels[i:i + 1]), tuple(current.values()))
            norm = global_norm(grads)
            factor = self._clip_factor(norm)
            norms.append(norm * factor)
            clipped = [g * factor for g in grads]
            total = clipped if total is None else [t + g for t, g in zip(total, clipped)]
        count = inputs.shape[0]
        return {k: t / count for k, t in zip(params, total)}, torch.stack(norms)

    def gradient(self, parameters, local_buffers, inputs, labels, bn_train) -> dict:
        """The shared gradient by parameter name: input noise, the batch gradient (or
        with clipping the clipped per-example mean) and gradient noise. In train mode the
        running statistics of ``local_buffers`` are updated in place."""
        if self.input_noise > 0 and not torch.is_floating_point(inputs):
            raise ValueError("local_diff_privacy.input_noise cannot perturb token ids.")
        seen = inputs + self.input_noise * self._noise([inputs.shape])[0] if self.input_noise > 0 else inputs
        if self.clip_value > 0:
            grads, _ = self.clipped_gradient(parameters, local_buffers, seen, labels, bn_train)
            if bn_train:  # the shared statistics are the full batch's
                with torch.no_grad():
                    functional_call(self.model, {**parameters, **local_buffers}, (seen,), dict(train=True))
        else:
            params = {k: v.detach().requires_grad_(True) for k, v in parameters.items()}
            outputs = functional_call(self.model, {**params, **local_buffers}, (seen,), dict(train=bn_train))
            grads = torch.autograd.grad(self.loss(outputs, labels), tuple(params.values()))
            grads = {k: g.detach() for k, g in zip(params, grads)}
        if self.gradient_noise > 0:
            grads = self._add_gradient_noise(grads)
        return grads

    def compute_local_updates(self, server_payload, custom_data=None):
        self.counted_queries += 1
        inputs, labels = self._user_tensors(custom_data)
        bn_train, local_buffers = self._local_buffers(server_payload["buffers"])
        grads = self.gradient(server_payload["parameters"], local_buffers, inputs, labels, bn_train)

        shared_buffers = local_buffers if bn_train else None
        metadata = dict(
            num_data_points=self.num_data_points if self.provide_num_data_points else None,
            labels=torch.sort(labels).values if self.provide_labels else None,
            local_hyperparams=None,
            data_key=_data_key(inputs),
        )
        shared_data = dict(
            gradients=grads,
            buffers=shared_buffers if self.provide_buffers else None,
            metadata=metadata,
        )
        true_user_data = dict(data=inputs, labels=labels, buffers=shared_buffers)
        return shared_data, true_user_data

    def _user_tensors(self, custom_data):
        """The user's inputs (images in ``utils.model_dtype``, token ids as int64) and labels on
        its device."""
        data = self._load_data() if custom_data is None else custom_data
        device = self.setup["device"]
        if "input_ids" in data:
            inputs = torch.as_tensor(data["input_ids"], dtype=torch.int64, device=device)
        else:
            inputs = torch.as_tensor(data["inputs"], dtype=model_dtype(self.setup), device=device)
        return inputs, torch.as_tensor(data["labels"], dtype=torch.int64, device=device)

    def _local_buffers(self, buffers):
        """(BatchNorm in train mode, the user's copy of the buffers): eval mode on the
        server's buffers where it sends them, else train mode on the model's own."""
        bn_train = buffers is None and any(True for _ in self.model.buffers())
        # train mode updates the running statistics in place: work on copies
        local_buffers = {k: v.clone() for k, v in (
            buffers.items() if buffers is not None else self.model.named_buffers())}
        log.info(f"Computing user update on user {self.user_idx} in model mode: "
                 f"{'training' if bn_train else 'eval'}.")
        return bn_train, local_buffers

    def _load_data(self):
        """Draw `num_data_points` examples from this user's partition
        (reference: users.py:200-227)."""
        blocks, num_samples = [], 0
        for block in self.dataloader:
            blocks.append(block)
            num_samples += block["labels"].shape[0]
            if num_samples >= self.num_data_points:
                break
        if num_samples < self.num_data_points:
            raise ValueError(
                f"User {self.user_idx} does not have the requested {self.num_data_points} samples "
                f"(only {num_samples} available).")
        return {
            key: np.concatenate([b[key] for b in blocks])[: self.num_data_points]
            for key in blocks[0]
        }


    @staticmethod
    def _token_rows(user_data, key="data"):
        data = user_data[key]
        data = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
        return data.reshape(data.shape[0], -1)

    @staticmethod
    def _token_text(token, tokenizer):
        return tokenizer.decode([int(token)]) if tokenizer is not None else str(int(token))

    def print(self, user_data, tokenizer=None, **kwargs):
        """Print each sequence of ``user_data["data"]``: decoded with ``tokenizer``, else its
        token ids (reference: users.py:229-234)."""
        for row in self._token_rows(user_data):
            print(tokenizer.decode(row.tolist()) if tokenizer is not None else " ".join(str(int(t)) for t in row))

    def print_with_confidence(self, user_data, tokenizer=None, **kwargs):
        """Print each token with its ``confidence`` (1 where none is given) (reference:
        users.py:236-250)."""
        rows = self._token_rows(user_data)
        confidence = user_data.get("confidence")
        confidence = np.ones(rows.shape, np.float32) if confidence is None else \
            np.asarray(torch.as_tensor(confidence).cpu()).reshape(rows.shape)
        for row, conf in zip(rows, confidence):
            print(" ".join(f"{self._token_text(t, tokenizer)}[{float(c):.2f}]" for t, c in zip(row, conf)))

    def print_and_mark_correct(self, user_data, true_user_data, tokenizer=None, **kwargs):
        """Print each token marked by whether it equals the true token at its place
        (reference: users.py:252-266)."""
        for row, truth in zip(self._token_rows(user_data), self._token_rows(true_user_data)):
            print(" ".join(f"{self._token_text(t, tokenizer)}{'✓' if int(t) == int(g) else '✗'}"
                           for t, g in zip(row, truth)))


class UserMultiStep(UserSingleStep):
    """A fedAVG user: several local SGD steps, shares the parameter delta (reference
    ``breaching_tpu/cases/users.py:270-370``). With local DP, each step's batch gradient
    is clipped to ``per_example_clipping`` and gets its own gradient noise.

    Step k trains on the user's examples (k·m + j) mod N, j < m, with m examples per
    step and N in all. The shared labels are the user's in data order; the local
    hyperparameters carry each step's labels sorted along their last axis (on text each
    sequence's tokens), as the JAX package shares them.
    """

    def __init__(self, model, loss_fn, dataloader, setup, idx, cfg_user):
        super().__init__(model, loss_fn, dataloader, setup, idx, cfg_user)
        self.num_local_updates = int(cfg_user.num_local_updates)
        self.num_data_per_local_update_step = int(cfg_user.num_data_per_local_update_step)
        self.local_learning_rate = float(cfg_user.local_learning_rate)
        self.provide_local_hyperparams = bool(cfg_user.provide_local_hyperparams)
        if self.input_noise > 0:
            log.warning("The fedAVG user adds no input noise, as the JAX package's UserMultiStep; "
                        "local_diff_privacy.input_noise is not applied.")

    def __repr__(self):
        return (super().__repr__() +
                f"\n    Local steps: {self.num_local_updates}, data per step: "
                f"{self.num_data_per_local_update_step}, lr: {self.local_learning_rate} "
                f"(hyperparams shared: {self.provide_local_hyperparams})")

    def compute_local_updates(self, server_payload, custom_data=None):
        self.counted_queries += 1
        inputs, labels = self._user_tensors(custom_data)
        parameters = server_payload["parameters"]
        bn_train, local_buffers = self._local_buffers(server_payload["buffers"])

        per_step = self.num_data_per_local_update_step
        idx = (torch.arange(self.num_local_updates * per_step, device=labels.device)
               % self.num_data_points).reshape(self.num_local_updates, per_step)
        params = {k: v.detach() for k, v in parameters.items()}
        for step_idx in idx:
            current = {k: v.requires_grad_(True) for k, v in params.items()}
            # the running statistics of train mode carry from step to step in local_buffers
            outputs = functional_call(self.model, {**current, **local_buffers}, (inputs[step_idx],),
                                      dict(train=bn_train))
            grads = torch.autograd.grad(self.loss(outputs, labels[step_idx]), tuple(current.values()))
            if self.clip_value > 0:  # the step's batch gradient, clipped as a whole
                factor = self._clip_factor(global_norm(grads))
                grads = [g * factor for g in grads]
            grads = dict(zip(current, grads))
            if self.gradient_noise > 0:
                grads = self._add_gradient_noise(grads)
            params = {k: (v - self.local_learning_rate * grads[k]).detach() for k, v in current.items()}
        delta = {k: params[k] - parameters[k].detach() for k in params}

        shared_buffers = local_buffers if any(True for _ in self.model.buffers()) else None
        metadata = dict(
            num_data_points=self.num_data_points if self.provide_num_data_points else None,
            labels=labels if self.provide_labels else None,
            local_hyperparams=dict(
                lr=self.local_learning_rate,
                steps=self.num_local_updates,
                data_per_step=per_step,
                labels=[torch.sort(labels[step_idx]).values for step_idx in idx],
            ) if self.provide_local_hyperparams else None,
            data_key=_data_key(inputs),
        )
        shared_data = dict(
            gradients=delta,
            buffers=shared_buffers if self.provide_buffers else None,
            metadata=metadata,
        )
        true_user_data = dict(data=inputs, labels=labels, buffers=shared_buffers)
        return shared_data, true_user_data


class MultiUserAggregate(UserMultiStep):
    """A secure-aggregation silo over the users ``user_indices`` (reference:
    users.py:431-533; JAX ``MultiUserAggregate``). ``num_data_points`` is per user: the
    shared metadata says ``num_data_points * num_users``, the sorted labels of all users
    under ``provide_labels``, always ``num_users``, and under
    ``provide_local_hyperparams`` every user's per-step label lists, one after the other
    (none for a single-step silo). The true data are all users' images, user by user."""

    def __init__(self, model, loss_fn, dataloaders, setup, user_indices, cfg_user):
        super().__init__(model, loss_fn, dataloaders[0], setup, user_indices[0], cfg_user)
        self.dataloaders = dataloaders
        self.user_indices = list(user_indices)
        self.num_users = len(self.user_indices)
        self.user_idx = f"{self.user_indices[0]}-{self.user_indices[-1]}"
        user_cls = UserSingleStep if self.num_local_updates == 1 else UserMultiStep
        self.users = [user_cls(model, loss_fn, loader, setup, idx, cfg_user)
                      for idx, loader in zip(self.user_indices, dataloaders)]

    def __repr__(self):
        return super().__repr__() + f"\n    Aggregating over {self.num_users} users."

    def compute_local_updates(self, server_payload, custom_data=None):
        self.counted_queries += 1
        aggregate = self._aggregate_single_step if self.num_local_updates == 1 else self._aggregate_multi_step
        gradients, buffers, true_buffers, data, labels, label_lists = aggregate(server_payload)
        metadata = dict(
            num_data_points=self.num_data_points * self.num_users if self.provide_num_data_points else None,
            labels=torch.sort(labels).values if self.provide_labels else None,
            num_users=self.num_users,
            local_hyperparams=dict(
                lr=self.local_learning_rate,
                steps=self.num_local_updates,
                data_per_step=self.num_data_per_local_update_step,
                labels=label_lists,
            ) if self.provide_local_hyperparams else None,
            data_key=_data_key(data),
        )
        shared_data = dict(gradients=gradients, buffers=buffers, metadata=metadata)
        return shared_data, dict(data=data, labels=labels, buffers=true_buffers)

    def _aggregate_single_step(self, server_payload):
        """The fedSGD gradients summed user by user, then divided by the number of users;
        in train mode the users' running statistics likewise, each user starting from the
        same buffers. Returns (the aggregate, the shared and the true buffers, the data,
        the labels, the per-step label lists).

        With a process group whose size divides the number of users, each rank takes its
        equal run of the users and one all-reduce sums the ranks' sums (the counterpart of
        the JAX package's ``shard_map`` with one ``pmean``, users.py:489-540); the users'
        noise generators are seeded first, in the users' order, as the loop seeds them."""
        parameters = server_payload["parameters"]
        bn_train, local_buffers = self._local_buffers(server_payload["buffers"])
        rank, world_size = _dist.world()
        mine = range(self.num_users)
        if world_size > 1 and self.num_users % world_size == 0:
            count = self.num_users // world_size
            mine = range(rank * count, (rank + 1) * count)
            for user in self.users:
                if user.input_noise > 0 or user.gradient_noise > 0:
                    user._noise([])
        grad_sum = buffer_sum = None
        all_data, all_labels = [], []
        for position, user in enumerate(self.users):
            inputs, labels = user._user_tensors(None)
            all_data.append(inputs)
            all_labels.append(labels)
            if position not in mine:
                continue
            buffers = {k: v.clone() for k, v in local_buffers.items()}
            grads = user.gradient(parameters, buffers, inputs, labels, bn_train)
            grad_sum = grads if grad_sum is None else {k: grad_sum[k] + g for k, g in grads.items()}
            if bn_train:
                buffer_sum = buffers if buffer_sum is None else {k: buffer_sum[k] + b for k, b in buffers.items()}
        if len(mine) < self.num_users:
            grad_sum = _sum_over_ranks(grad_sum)
            buffer_sum = _sum_over_ranks(buffer_sum) if bn_train else None
        aggregate = {k: g / self.num_users for k, g in grad_sum.items()}
        buffers = {k: b / self.num_users for k, b in buffer_sum.items()} if bn_train else None
        shared_buffers = buffers if self.provide_buffers else None
        # all the users' labels in one row, as the JAX package's single-step silo flattens them
        return aggregate, shared_buffers, buffers, torch.cat(all_data), torch.cat(all_labels).reshape(-1), []

    def _aggregate_multi_step(self, server_payload):
        """The running mean of the fedAVG users' deltas (and of their buffers, where they
        share them)."""
        aggregate = buffers = None
        all_data, all_labels, label_lists = [], [], []
        for position, user in enumerate(self.users):
            shared, true = user.compute_local_updates(server_payload)
            weight = 1.0 / (position + 1)
            if aggregate is None:
                aggregate, buffers = shared["gradients"], shared["buffers"]
            else:
                aggregate = {k: acc + (shared["gradients"][k] - acc) * weight for k, acc in aggregate.items()}
                if buffers is not None and shared["buffers"] is not None:
                    buffers = {k: acc + (shared["buffers"][k] - acc) * weight for k, acc in buffers.items()}
            hyper = shared["metadata"]["local_hyperparams"]
            if hyper is not None:
                label_lists.extend(hyper["labels"])
            all_data.append(true["data"])
            all_labels.append(true["labels"])
        return aggregate, buffers, buffers, torch.cat(all_data), torch.cat(all_labels), label_lists
