"""Step-size schedule and Adam (counterpart of ``breaching_tpu/attacks/auxiliaries/optimizers.py``).

Adam is written out so that each operation is optax's ``adam`` (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction 1 - b**t with t counted from 1),
and the schedule returns optax's float32 values, so the port's trajectory follows
the JAX package's operation for operation.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import AdamStep


def make_schedule(step_size: float, decay: str | None, warmup: int, max_iterations: int):
    """The step size at each iteration (float32 values, as optax computes them)."""
    decay = (decay or "none").lower()
    if warmup:
        raise NotImplementedError("Step-size warmup is not ported yet.")
    if decay == "step-lr":
        # MultiStepLR at ~3/8, ~5/8, ~7/8 of the run with gamma 0.1; boundaries that
        # coincide (max_iterations <= 3) count once, as the JAX package's dict keys do
        boundaries = sorted({int(max_iterations / 2.667), int(max_iterations / 1.6),
                             int(max_iterations / 1.142)})

        def schedule(step):
            value = np.float32(step_size)
            for boundary in boundaries:
                if step >= boundary:
                    value = np.float32(0.1) * value
            return float(value)

        return schedule
    if decay == "none":
        return lambda step: float(np.float32(step_size))
    raise NotImplementedError(f"Step-size decay {decay} is not ported yet.")


class Adam:
    """optax.adam over one tensor, with the state held explicitly. The update itself
    is ``ops.adam_box_step``; this object owns the schedule and the step count."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, x: torch.Tensor) -> dict:
        return dict(count=0, mu=torch.zeros_like(x), nu=torch.zeros_like(x))

    def advance(self, state: dict) -> AdamStep:
        """Count one step in ``state`` and return its host scalars."""
        lr = self.schedule(state["count"])
        state["count"] += 1
        t = np.float32(state["count"])
        return AdamStep(lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
                        bias1=float(np.float32(1) - np.float32(self.b1) ** t),
                        bias2=float(np.float32(1) - np.float32(self.b2) ** t))


def optimizer_lookup(optim_name: str, step_size: float, scheduler=None, warmup=0,
                     max_iterations: int = 10_000):
    schedule = make_schedule(step_size, scheduler, warmup, max_iterations)
    if optim_name.lower() == "adam":
        return Adam(schedule)
    raise NotImplementedError(f"Optimizer {optim_name} is not ported yet.")
