"""Task losses over (logits, labels) (counterpart of ``breaching_tpu/cases/models/losses.py``).
Each takes hard integer labels or soft label rows (the joint attack's softmax labels)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logprobs = F.log_softmax(logits, dim=-1)
    if labels.dim() == logits.dim():  # soft labels
        return -(labels * logprobs).sum(dim=-1).mean()
    return -logprobs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1).mean()


class CrossEntropyLoss:
    """Mean cross entropy over the batch; hard integer labels or soft label rows."""

    name = "CrossEntropy"

    def __call__(self, outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return _cross_entropy(outputs, labels)

    def __repr__(self):
        return "CrossEntropyLoss()"


class CausalLoss:
    """Shift-by-one causal LM loss over logits (B, T, V): the prediction at position t is
    scored against the token at t + 1; labels (B, T) ids or (B, T, V) soft rows."""

    name = "CausalLoss"

    def __call__(self, outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = outputs[:, :-1, :].reshape(-1, outputs.shape[-1])
        if labels.dim() == outputs.dim():
            return _cross_entropy(logits, labels[:, 1:, :].reshape(-1, labels.shape[-1]))
        return _cross_entropy(logits, labels[:, 1:].reshape(-1))

    def __repr__(self):
        return "CausalLoss()"


class MLMLoss:
    """Masked-LM loss: cross entropy at the positions whose label is not -100 (HF's
    ignore index), over their count; soft labels (B, T, V) score every position."""

    name = "MLMLoss"

    def __call__(self, outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = outputs.reshape(-1, outputs.shape[-1])
        if labels.dim() == outputs.dim():
            return _cross_entropy(logits, labels.reshape(-1, labels.shape[-1]))
        flat = labels.reshape(-1)
        mask = flat != -100
        logprobs = F.log_softmax(logits, dim=-1)
        nll = -logprobs.gather(-1, torch.where(mask, flat, 0).long().unsqueeze(-1)).squeeze(-1)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)

    def __repr__(self):
        return "MLMLoss()"


class MostlyCausalLoss(CausalLoss):
    """The causal loss plus half the cross entropy of position 0 against its own label."""

    name = "MostlyCausalLoss"

    def __call__(self, outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return super().__call__(outputs, labels) + 0.5 * _cross_entropy(outputs[:, 0, :], labels[:, 0])

    def __repr__(self):
        return "MostlyCausalLoss()"


LOSSES = {
    "CrossEntropy": CrossEntropyLoss,
    "classification": CrossEntropyLoss,
    "causal-lm": CausalLoss,
    "masked-lm": MLMLoss,
    "mostly-causal-lm": MostlyCausalLoss,
}
