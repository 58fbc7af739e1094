"""Step-size schedules and optimizers (counterpart of ``breaching_tpu/attacks/auxiliaries/optimizers.py``).

Each optimizer is written out so that its operations are optax's, in optax's order,
and each schedule returns optax's float32 values, so the port's trajectory follows
the JAX package's operation for operation:

- ``Adam`` (``adam``, ``adam-safe``): optax's ``adam`` (bias correction 1 - b**t with t
  counted from 1, eps outside the square root). Its update is the kernel
  ``ops.adam_box_step``; this object owns the schedule and the step count.
- ``FirstOrder`` (``bert-adam`` = optax ``adamw`` with weight decay 0.01, ``momgd`` =
  optax ``sgd`` with Nesterov momentum 0.9, ``gd`` = plain ``sgd``): the update in
  PyTorch operations.
- ``LBFGS`` (``l-bfgs``): the JAX package's ``_torch_like_lbfgs``, which is not
  ``torch.optim.LBFGS``: every trial step is evaluated (up to 20 closure calls per
  outer step), a trial whose loss is not finite is rejected and quarters the step
  scale (an accepted one doubles it, up to 1), the first step of the run is scaled
  by min(1, 1/|g|_1) times the step size, pairs enter the history of 100 only where
  y.s > 1e-10, and torch's four break conditions end the inner loop. The JAX
  package masks the iterations after a break; this loop stops there, which leaves
  the same state.

A warmup of w steps ramps the step size linearly from 0 over the first w steps and
then evaluates the main schedule at step - w: optax's ``join_schedules`` hands the
second schedule the step since the boundary, although the JAX package's comment says
it wraps the main schedule. The port follows what the code computes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import AdamStep

_F32 = np.float32


def make_schedule(step_size: float, decay: str | None, warmup: int, max_iterations: int):
    """The step size at each iteration (float32 values, as optax computes them)."""
    decay = (decay or "none").lower()
    max_iterations = int(max_iterations)
    if decay == "step-lr":
        # MultiStepLR at ~3/8, ~5/8, ~7/8 of the run with gamma 0.1; boundaries that
        # coincide (max_iterations <= 3) count once, as the JAX package's dict keys do
        boundaries = sorted({int(max_iterations / 2.667), int(max_iterations / 1.6),
                             int(max_iterations / 1.142)})

        def main(step):
            value = _F32(step_size)
            for boundary in boundaries:
                if step >= boundary:
                    value = _F32(0.1) * value
            return value
    elif decay == "cosine-decay":
        # optax.cosine_decay_schedule(step_size, max(max_iterations, 1), alpha=0)
        decay_steps = _F32(max(max_iterations, 1))

        def main(step):
            count = min(_F32(step), decay_steps)
            cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * count / decay_steps))
            return _F32(step_size) * (_F32(1) * cosine + _F32(0))
    elif decay == "linear":
        def main(step):
            return _F32(step_size) * _F32(max_iterations - step) / _F32(max(max_iterations, 1))
    elif decay == "none":
        def main(step):
            return _F32(step_size)
    else:
        raise NotImplementedError(f"Step-size decay {decay} is not ported yet.")

    if warmup and warmup > 0:
        # optax.linear_schedule(0, step_size, warmup), then main(step - warmup)
        def schedule(step):
            if step >= warmup:
                return float(main(step - warmup))
            frac = _F32(1) - _F32(min(max(step, 0), warmup)) / _F32(warmup)
            return float(_F32(-step_size) * frac + _F32(step_size))

        return schedule
    return lambda step: float(main(step))


class Adam:
    """optax.adam over one tensor, with the state held explicitly. The update itself
    is ``ops.adam_box_step``; this object owns the schedule and the step count."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, x: torch.Tensor) -> dict:
        return dict(count=0, mu=torch.zeros_like(x), nu=torch.zeros_like(x))

    def advance(self, state: dict, dtype: torch.dtype = torch.float32) -> AdamStep:
        """Count one step in ``state`` and return its host scalars: the bias corrections
        in float64 for a float64 candidate (optax under x64), else in float32."""
        lr = self.schedule(state["count"])
        state["count"] += 1
        real = np.float64 if dtype == torch.float64 else _F32
        t = real(state["count"])
        return AdamStep(lr=lr, b1=self.b1, b2=self.b2, eps=self.eps,
                        bias1=float(real(1) - real(self.b1) ** t),
                        bias2=float(real(1) - real(self.b2) ** t))


class FirstOrder:
    """optax's ``adamw`` (``weight_decay`` > 0), ``sgd`` with (Nesterov) momentum, or
    plain ``sgd``, over one tensor, in PyTorch operations: ``update`` returns
    p + (-lr) u for optax's update u."""

    def __init__(self, schedule, kind: str, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
                 momentum=0.9, nesterov=True):
        self.schedule, self.kind = schedule, kind
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, x: torch.Tensor) -> dict:
        if self.kind == "adamw":
            return dict(count=0, mu=torch.zeros_like(x), nu=torch.zeros_like(x))
        if self.kind == "momentum":
            return dict(count=0, trace=torch.zeros_like(x))
        return dict(count=0)

    def update(self, grad: torch.Tensor, state: dict, param: torch.Tensor) -> torch.Tensor:
        lr = self.schedule(state["count"])
        state["count"] += 1
        if self.kind == "adamw":
            state["mu"] = (1 - self.b1) * grad + self.b1 * state["mu"]
            state["nu"] = (1 - self.b2) * (grad * grad) + self.b2 * state["nu"]
            t = _F32(state["count"])
            # divide by tensors: CUDA divides by a host scalar as a product with its reciprocal
            bias1 = torch.full((), float(_F32(1) - _F32(self.b1) ** t), dtype=grad.dtype, device=grad.device)
            bias2 = torch.full((), float(_F32(1) - _F32(self.b2) ** t), dtype=grad.dtype, device=grad.device)
            u = (state["mu"] / bias1) / (torch.sqrt(state["nu"] / bias2) + self.eps)
            u = u + self.weight_decay * param
        elif self.kind == "momentum":
            state["trace"] = grad + self.momentum * state["trace"]
            u = grad + self.momentum * state["trace"] if self.nesterov else state["trace"]
        else:
            u = grad
        return param + (-lr) * u


class LBFGS:
    """The JAX package's ``_torch_like_lbfgs`` over a flat vector (module docstring).
    ``update`` takes the parameters, their gradient and loss, and a closure that
    returns (loss, gradient) at other parameters, and returns the parameters after
    one outer step. The state's scalars stay on the device; the break conditions are
    read on the host once per inner iteration."""

    needs_closure = True

    def __init__(self, schedule, max_inner: int = 20, history: int = 100, tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9):
        self.schedule, self.max_inner, self.history = schedule, max_inner, history
        self.tolerance_grad, self.tolerance_change = tolerance_grad, tolerance_change

    def init(self, flat: torch.Tensor) -> dict:
        zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
        return dict(pairs=[], h_diag=zero + 1, prev_grad=torch.zeros_like(flat), d=torch.zeros_like(flat),
                    t=zero, n_iter=0, outer=0, t_scale=zero + 1)

    def state_arrays(self, state: dict) -> dict:
        """The state as named arrays of fixed shapes, as the JAX package's carry holds it:
        the history of (s, y, rho) in ``history`` rows, oldest first, of which
        ``pairs`` are valid (the rest zero), ``h_diag``, the last step's gradient,
        direction and length, the counters and the step scale."""
        flat = state["prev_grad"]
        s = torch.zeros(self.history, flat.numel(), dtype=flat.dtype, device=flat.device)
        y, rho = torch.zeros_like(s), torch.zeros(self.history, dtype=flat.dtype, device=flat.device)
        for i, (s_i, y_i, rho_i) in enumerate(state["pairs"]):
            s[i], y[i], rho[i] = s_i, y_i, rho_i
        return {"history/s": s, "history/y": y, "history/rho": rho, "history/pairs": len(state["pairs"]),
                "h_diag": state["h_diag"], "prev_grad": flat, "d": state["d"], "t": state["t"],
                "n_iter": state["n_iter"], "outer": state["outer"], "t_scale": state["t_scale"]}

    @staticmethod
    def load_state_arrays(state: dict, arrays: dict) -> None:
        """Restore ``state`` in place from ``state_arrays``' arrays (tensors or numpy)."""
        device = state["prev_grad"].device

        def tensor(name):
            return torch.as_tensor(arrays[name], device=device)

        count = int(arrays["history/pairs"])
        s, y, rho = tensor("history/s"), tensor("history/y"), tensor("history/rho")
        state["pairs"] = [(s[i].clone(), y[i].clone(), rho[i].clone()) for i in range(count)]
        for name in ("h_diag", "prev_grad", "d", "t", "t_scale"):
            state[name] = tensor(name).to(state[name].dtype).clone()
        for name in ("n_iter", "outer"):
            state[name] = int(arrays[name])

    @staticmethod
    def _two_loop(g, pairs, h_diag):
        """The direction -H g from the history of (s, y, rho), oldest first."""
        q, alphas = -g, []
        for s, y, rho in reversed(pairs):
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append(a)
        r = q * h_diag
        for (s, y, rho), a in zip(pairs, reversed(alphas)):
            b = rho * torch.dot(y, r)
            r = r + (a - b) * s
        return r

    def update(self, params, grad, value, closure, state):
        tol_change = self.tolerance_change
        lr = torch.full((), self.schedule(state["outer"]), dtype=params.dtype, device=params.device)
        p, g, loss = params, grad, value
        for _ in range(self.max_inner):
            first_global = state["n_iter"] == 0
            pairs, h_diag = state["pairs"], state["h_diag"]
            if not first_global:  # the pair of the previous step enters the history if y.s > 1e-10
                y_new = g - state["prev_grad"]
                s_new = state["d"] * state["t"]
                ys = torch.dot(y_new, s_new)
                if ys.item() > 1e-10:
                    pairs = (pairs + [(s_new, y_new, 1.0 / ys)])[-self.history:]
                    h_diag = ys / torch.dot(y_new, y_new)
            d = self._two_loop(g, pairs, h_diag)
            if first_global:
                t = torch.minimum(torch.ones_like(lr), 1.0 / g.abs().sum()) * lr
            else:
                t = lr
            t = t * state["t_scale"]
            gtd = torch.dot(g, d)
            grad_max, gtd = torch.stack([g.abs().max(), gtd]).tolist()
            if grad_max <= self.tolerance_grad or gtd > -tol_change:  # optimal, or no descent
                break
            step = t * d
            p_try = p + step
            loss_try, g_try = closure(p_try)
            step_max, loss_now, loss_before = torch.stack([step.abs().max(), loss_try, loss]).tolist()
            accepted = np.isfinite(loss_now)
            state.update(pairs=pairs, h_diag=h_diag, prev_grad=g, d=d, t=t, n_iter=state["n_iter"] + 1)
            if accepted:
                p, g, loss = p_try, g_try, loss_try
                state["t_scale"] = torch.clamp(state["t_scale"] * 2.0, max=1.0)
            else:  # a rejected overshoot backtracks: the same direction at a quarter of the scale
                state["t_scale"] = state["t_scale"] * 0.25
            if step_max <= tol_change or abs(loss_now - loss_before) < tol_change:
                break
        state["outer"] += 1
        return p


def optimizer_lookup(optim_name: str, step_size: float, scheduler=None, warmup=0,
                     max_iterations: int = 10_000):
    schedule = make_schedule(step_size, scheduler, warmup, max_iterations)
    name = optim_name.lower()
    if name == "adam":
        return Adam(schedule)
    if name == "adam-safe":
        return Adam(schedule, b1=0.5, b2=0.99, eps=1e-4)
    if name == "bert-adam":
        return FirstOrder(schedule, "adamw", b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    if name == "momgd":
        return FirstOrder(schedule, "momentum", momentum=0.9, nesterov=True)
    if name == "gd":
        return FirstOrder(schedule, "sgd")
    if name == "l-bfgs":
        return LBFGS(schedule, max_inner=20)
    raise NotImplementedError(f"Optimizer {optim_name} is not ported yet.")
