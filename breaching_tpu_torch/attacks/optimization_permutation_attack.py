"""The permutation attack on a text payload's leaked tokens (counterpart of
``breaching_tpu/attacks/optimization_permutation_attack.py``).

Every token is recovered before the optimization (``attack.token_strategy``, from the
embedding and decoder gradients); the attack then optimizes only their order. The
candidate is a (P, P) matrix over the P = num_data_points x seq_len positions and
tokens, drawn uniform in [0, 1). The loss takes its clamp to [0, 1] through
Sinkhorn-Knopp (``sinkhorn_knopp``, 20 row-then-column normalizations), embeds the
sequence as ``perm @ embeddings[leaked]`` and its soft labels as ``perm @
one_hot(leaked)``, and matches the user's gradient. With ``optim.boxed`` each accepted
step projects the candidate the same way, after the update (with Adam, after
``ops.adam_box_step``: a step whose loss is not finite keeps the candidate unprojected).
The solution is the assignment of positions to tokens of largest total weight
(``scipy.optimize.linear_sum_assignment`` on the host).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .optimization_based_attack import OptimizationBasedAttacker


def sinkhorn_knopp(matrix: torch.Tensor, sub_iterations: int = 20, eps: float = 1e-9) -> torch.Tensor:
    """A nonnegative matrix brought close to doubly stochastic: max(matrix, eps), then
    ``sub_iterations`` times rows, then columns, divided by their sums + eps."""
    m = torch.clamp(matrix, min=eps)
    for _ in range(sub_iterations):
        m = m / (m.sum(dim=-1, keepdim=True) + eps)
        m = m / (m.sum(dim=-2, keepdim=True) + eps)
    return m


def project_permutation(matrix: torch.Tensor) -> torch.Tensor:
    return sinkhorn_knopp(torch.clamp(matrix, 0.0, 1.0))


class OptimizationPermutationAttacker(OptimizationBasedAttacker):
    """Optimizes the order of a leaked bag of tokens."""

    supports_fleet = False  # each experiment leaks its own bag

    def reconstruct(self, server_payload, shared_data, server_secrets=None, initial_data=None, dryrun=False):
        metadata = server_payload[0]["metadata"]
        if metadata.modality != "text":
            raise NotImplementedError("The permutation-optimization attack orders a text payload's leaked "
                                      "tokens; it is not ported for other payloads.")
        self._vocab_size = int(metadata.vocab_size)
        return super().reconstruct(server_payload, shared_data, server_secrets, initial_data, dryrun)

    def prepare_attack(self, server_payload, shared_data):
        rec_models, labels, stats = super().prepare_attack(server_payload, shared_data)
        if labels is None:
            raise ValueError("The permutation attack needs leaked tokens; set attack.token_strategy.")
        self._leaked = labels.reshape(-1).long()
        self._num_points = int(self._shared_data_cache[0]["metadata"]["num_data_points"] or 1)
        weight = self.embeddings[0]["weight"]
        self._leaked_embeddings = weight[self._leaked]
        self._leaked_one_hot = F.one_hot(self._leaked, self._vocab_size).to(weight.dtype)
        return rec_models, labels, stats

    def _init_candidate_tree(self, num_trials, num_points):
        size = self._leaked.shape[0]
        return dict(data=torch.rand((num_trials, size, size), generator=self.setup["generator"],
                                    dtype=self.setup["dtype"]).to(self.setup["device"]))

    def _project_tree(self, tree, box):
        return dict(tree, data=project_permutation(tree["data"]))

    def _project_accepted(self, tree, value):
        data = tree["data"]
        data.copy_(torch.where(torch.isfinite(value), project_permutation(data), data))

    def _loss(self, candidate, rec_models, targets, labels, draws=None):
        tree = candidate if isinstance(candidate, dict) else dict(data=candidate)
        perm = project_permutation(tree["data"])
        seq_len = self._leaked.shape[0] // self._num_points
        embedded = (perm @ self._leaked_embeddings).reshape(self._num_points, seq_len, -1)
        soft_labels = (perm @ self._leaked_one_hot).reshape(self._num_points, seq_len, -1)
        total, task_total = 0.0, 0.0
        for model, target in zip(rec_models, targets):
            obj, task = self.objective(model.params, model.buffers, target, embedded, soft_labels,
                                       bn_train=model.bn_train)
            total, task_total = total + obj, task_total + task
        for reg in self.regularizers:
            total = total + reg(embedded)
        return total, task_total

    def _score_all_trials(self, best_trials, labels, rec_models, shared_data):
        """Each trial's loss at its best iterate."""
        scores = []
        for t in range(best_trials["data"].shape[0]):
            targets = [tuple(d["gradients"][k] for k in model.params) for d, model in zip(shared_data, rec_models)]
            value, _ = self._loss(dict(data=best_trials["data"][t]), rec_models, targets, labels)
            scores.append(float(value.detach()))
        scores = np.asarray(scores)
        return np.where(np.isfinite(scores), scores, np.inf)

    def _extract_solution(self, tree, labels):
        from scipy.optimize import linear_sum_assignment

        _, assignment = linear_sum_assignment(tree["data"].detach().cpu().numpy(), maximize=True)
        recovered = self._leaked[torch.as_tensor(assignment, device=self._leaked.device)]
        recovered = recovered.reshape(self._num_points, -1)
        return dict(data=recovered, labels=recovered.clone())

    def _postprocess_text_data(self, reconstructed):
        return reconstructed  # the assignment gives tokens
