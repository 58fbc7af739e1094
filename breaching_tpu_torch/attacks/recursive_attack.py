"""R-GAP: recursive layer-by-layer gradient inversion (Zhu & Blaschko; counterpart of
``breaching_tpu/attacks/recursive_attack.py``).

The head's input comes from the FC inversion (``invert_fc_layer``). Then, walking the
model's ``rgap_layers`` back to front, each layer solves for its input x by least
squares:
    da  = the activation's derivative at the recovered layer output x_
    out = the inverse activation of x_                    (the pre-activation output)
    k   = (W_above^T k) * da                               (dl/dy, propagated)
    solve [K; W] x = [vec(g_W); out]                       (gradient and consistency)
where W is the convolution as a matrix and K = d vec(g_W) / dx for fixed k. Both are
materialized with ``torch.func.jacfwd`` of the port's own convolution in float32 on the
payload's exact weights (the Jacobian of a linear map is its matrix; the convolution
pads itself). Rows and columns follow the JAX package's orders, so that the float64
systems are the same ones: x and y flattened as NHWC, g_W as HWIO, the head's inputs
in height-width-channel order. The recursion runs in float64 on the host with
``numpy.linalg.lstsq``, as the JAX package's does: the layers' errors compound, and
float32 costs about 35 dB of PSNR.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, jacfwd

from ..cases.models.model_preparation import head_grads, head_keys
from .analytic_attack import invert_fc_layer
from .base_attack import _BaseAttacker

log = logging.getLogger(__name__)


def inverse_udldu(udldu, step_size=0.01, steps=30_000):
    """u with u * dl/du = -u / (1 + e^u) equal to ``udldu``, by Adam on the squared error
    from u = 0 in float32 (reference: auxiliaries/recursive_attack.py:11-24; the JAX
    package's optax Adam: b1 0.9, b2 0.999, eps 1e-8)."""
    target = torch.tensor(float(udldu), dtype=torch.float32)
    loss = lambda u: torch.square(-u / (1 + torch.exp(u)) - target)
    loss_grad = grad(loss)
    u, mu, nu = (torch.zeros((), dtype=torch.float32) for _ in range(3))
    b1, b2 = torch.tensor(0.9), torch.tensor(0.999)
    for t in range(1, steps + 1):
        g = loss_grad(u)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        mu_hat, nu_hat = mu / (1 - b1 ** t), nu / (1 - b2 ** t)
        u = u - step_size * mu_hat / (torch.sqrt(nu_hat) + 1e-8)
    log.info(f"The error term of inversing udldu: {float(-u / (1 + torch.exp(u)) - target):.1e}")
    return u


def derive_leakyrelu(x, slope=0.2):
    return np.where(np.asarray(x) < 0, slope, 1.0)


def inverse_leakyrelu(x, slope=0.2):
    x = np.asarray(x)
    return np.where(x < 0, x / slope, x)


class RecursiveAttacker(_BaseAttacker):
    """R-GAP for alternating convolution and LeakyReLU stacks (``cnn6``)."""

    def __repr__(self):
        return (f"Attacker (of type {self.__class__.__name__}) with settings:\n"
                f"    inversion: step size {self.cfg.inversion.step_size}, steps {self.cfg.inversion.steps}")

    def reconstruct(self, server_payload, shared_data, server_secrets=None, dryrun=False):
        rec_models, labels, stats = self.prepare_attack(server_payload, shared_data)
        inputs = [self._rgap(user_data["gradients"], model)
                  for model, user_data in zip(rec_models, self._shared_data_cache)]
        return dict(data=torch.stack(inputs).mean(dim=0), labels=labels), stats

    def _rgap(self, gradients, model) -> torch.Tensor:
        """The (1, C, H, W) input recovered from one query's gradients."""
        module = model.module
        layers = getattr(module, "rgap_layers", None)
        if layers is None:
            raise ValueError(f"Model {getattr(module, 'name', type(module).__name__)} has no rgap_layers recursion "
                             f"plan; R-GAP attacks the cnn6 architecture.")
        c, h, w = self.data_shape
        shapes = self._layer_input_shapes(layers, (1, h, w, c))
        to64 = lambda t: t.detach().cpu().double().numpy()
        w_grad, b_grad = head_grads(gradients, module)
        x_ = to64(invert_fc_layer(w_grad, b_grad, [0]))
        k = to64(b_grad).reshape(-1)                                # dl/dlogits
        last_w = to64(model.params[head_keys(module)[0]])           # (classes, features)
        for idx in range(len(layers) - 1, -1, -1):
            spec = layers[idx]
            slope = spec.get("slope", 0.2)
            da = derive_leakyrelu(x_, slope)
            out = inverse_leakyrelu(x_, slope)
            k = (last_w.T @ k) * da.reshape(-1)
            name = f"{spec['name']}.weight"
            g_w = to64(gradients[name].permute(2, 3, 1, 0)).reshape(-1)  # HWIO
            x_, last_w = self._solve_layer(k, g_w, out.reshape(-1), model.params[name].detach(), shapes[idx],
                                           stride=spec["stride"], padding=spec["padding"])
        x = torch.as_tensor(x_.reshape(1, h, w, c), dtype=torch.float32).permute(0, 3, 1, 2)
        return x.to(self.dm.device)

    @staticmethod
    def _solve_layer(k, g_w, out, kernel, in_shape, stride, padding):
        """The least-squares solve of [K; W] x = [g_w; out] (reference: cnn_reconstruction,
        auxiliaries/recursive_attack.py:54-75). Returns (x, W) in float64."""
        x_len = int(np.prod(in_shape))
        zeros = torch.zeros(x_len, dtype=torch.float32, device=kernel.device)

        def conv_apply(x_flat):
            x = x_flat.reshape(in_shape).permute(0, 3, 1, 2)
            return F.conv2d(x, kernel, stride=stride, padding=padding).permute(0, 2, 3, 1).reshape(-1)

        y_len = conv_apply(zeros).shape[0]
        k_y = torch.as_tensor(k.reshape(-1)[:y_len], dtype=torch.float32, device=kernel.device)

        def weight_grad_of_x(x_flat):
            x = x_flat.reshape(in_shape).permute(0, 3, 1, 2)

            def contraction(kern):
                y = F.conv2d(x, kern, stride=stride, padding=padding)
                return torch.dot(y.permute(0, 2, 3, 1).reshape(-1), k_y)

            return grad(contraction)(kernel).permute(2, 3, 1, 0).reshape(-1)

        to64 = lambda t: t.detach().cpu().double().numpy()
        W = to64(jacfwd(conv_apply)(zeros))          # (y_len, x_len)
        K = to64(jacfwd(weight_grad_of_x)(zeros))    # (w_len, x_len)
        x, _, rank, sv = np.linalg.lstsq(np.concatenate([K, W]), np.concatenate([g_w, out[:y_len]]), rcond=None)
        log.info(f"lstsq rank: {int(rank)} -> {W.shape[-1]}, max/min singular value: {sv.max():.2e}/{sv.min():.2e}")
        return x, W

    @staticmethod
    def _layer_input_shapes(layers, input_shape):
        """The NHWC input shape of each layer, and the last layer's output shape."""
        shapes, shape = [input_shape], input_shape
        for spec in layers:
            _, h, w, _ = shape
            k, s, p = spec.get("kernel", 3), spec["stride"], spec["padding"]
            shape = (1, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, spec["features"])
            shapes.append(shape)
        return shapes
