"""Task losses over (logits, labels) (counterpart of ``breaching_tpu/cases/models/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class CrossEntropyLoss:
    """Mean cross entropy over the batch; hard integer labels or soft label rows."""

    name = "CrossEntropy"

    def __call__(self, outputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logprobs = F.log_softmax(outputs, dim=-1)
        if labels.dim() == outputs.dim():  # soft labels
            return -(labels * logprobs).sum(dim=-1).mean()
        return -logprobs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1).mean()

    def __repr__(self):
        return "CrossEntropyLoss()"


LOSSES = {
    "CrossEntropy": CrossEntropyLoss,
    "classification": CrossEntropyLoss,
}
