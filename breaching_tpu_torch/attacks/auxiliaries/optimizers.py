"""Step-size schedule and Adam (counterpart of ``breaching_tpu/attacks/auxiliaries/optimizers.py``).

Adam is written out so that each operation is optax's ``adam`` (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction 1 - b**t with t counted from 1),
and the schedule returns optax's float32 values, so the port's trajectory follows
the JAX package's operation for operation.
"""

from __future__ import annotations

import numpy as np
import torch


def make_schedule(step_size: float, decay: str | None, warmup: int, max_iterations: int):
    """The step size at each iteration (float32 values, as optax computes them)."""
    decay = (decay or "none").lower()
    if warmup:
        raise NotImplementedError("Step-size warmup is not ported yet.")
    if decay == "step-lr":
        # MultiStepLR at ~3/8, ~5/8, ~7/8 of the run with gamma 0.1
        boundaries = [int(max_iterations / 2.667), int(max_iterations / 1.6),
                      int(max_iterations / 1.142)]

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
    """optax.adam over one tensor, with the state held explicitly."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, x: torch.Tensor) -> dict:
        return dict(count=0, mu=torch.zeros_like(x), nu=torch.zeros_like(x))

    def step(self, x: torch.Tensor, grad: torch.Tensor, state: dict) -> torch.Tensor:
        """Advance ``state`` in place and return the updated x."""
        lr = self.schedule(state["count"])
        state["mu"] = (1 - self.b1) * grad + self.b1 * state["mu"]
        state["nu"] = (1 - self.b2) * (grad * grad) + self.b2 * state["nu"]
        state["count"] += 1
        t = np.float32(state["count"])
        mu_hat = state["mu"] / float(np.float32(1) - np.float32(self.b1) ** t)
        nu_hat = state["nu"] / float(np.float32(1) - np.float32(self.b2) ** t)
        return x + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))


def optimizer_lookup(optim_name: str, step_size: float, scheduler=None, warmup=0,
                     max_iterations: int = 10_000):
    schedule = make_schedule(step_size, scheduler, warmup, max_iterations)
    if optim_name.lower() == "adam":
        return Adam(schedule)
    raise NotImplementedError(f"Optimizer {optim_name} is not ported yet.")
