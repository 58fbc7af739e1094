"""Malicious imprint blocks ("Robbing the Fed", Fowl et al.; "Curious Abandon Honesty",
Boenisch et al.), counterparts of ``breaching_tpu/cases/malicious/imprint.py``.

Each block's weights are a deterministic function of its hyperparameters, built as the
JAX package builds them: in numpy float64 (bin edges from ``scipy.stats`` inverse CDFs,
the measurement row of ``_linear_query``, CAH's trap rows from one
``np.random.default_rng(seed)``), then cast to float32. A block holds them in two
``nn.Linear`` layers, ``linear0`` (inputs -> bins) and ``linear2`` (bins -> inputs, for
``connection="linear"``), so that its weights equal the JAX package's ``linear0_kernel``
and ``linear2_kernel`` transposed; the weight bridge (``load_flat_state``) maps them by
those names (``flat_param_suffixes``).

The blocks take NCHW tensors and flatten them in height-width-channel order, the JAX
package's NHWC order, so that the measurement row, CAH's permutation and the readout's
reshape index the same pixels in both packages; the output is reshaped back the same way.
``data_shape`` is (H, W, C), as in the JAX package. On text a block sits after the
embedding, on (B, T, D) sequences of ``data_shape`` (T, D), flattened as they lie.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import laplace, norm
from torch import nn


def _linear_query(linfunc: str, mode: int, num_bins: int, data_size: int, rng) -> np.ndarray:
    """One shared measurement row, repeated per bin (reference: imprint.py:42-61)."""
    K, N = num_bins, data_size
    if linfunc == "avg":
        weights = np.ones((K, N)) / N
    elif linfunc == "fourier":
        row = np.cos(math.pi / N * (np.arange(N) + 0.5) * mode) / N * max(mode, 0.33) * 4
        weights = np.tile(row, (K, 1))
    elif linfunc in ("randn", "rand"):
        row = rng.standard_normal(N) if linfunc == "randn" else rng.uniform(size=N)
        row = (row - row.mean()) / row.std() / math.sqrt(N)
        weights = np.tile(row, (K, 1))
    else:
        raise ValueError(f"Invalid linear function choice {linfunc}.")
    return weights.astype(np.float32)


def _linear(weight: np.ndarray, bias: np.ndarray) -> nn.Linear:
    """An ``nn.Linear`` holding ``weight`` (out, in) and ``bias`` (out,) in float32."""
    layer = nn.Linear(weight.shape[1], weight.shape[0])
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(weight, np.float32)))
        layer.bias.copy_(torch.from_numpy(np.ascontiguousarray(bias, np.float32)))
    return layer


class _Block(nn.Module):
    """What the blocks share: HWC flattening and the connection back to the input shape."""

    # the weight bridge names this block's linear layers "<name>_kernel" / "<name>_bias"
    flat_param_suffixes = True

    def __init__(self, data_shape, num_bins: int, connection: str):
        super().__init__()
        self.data_shape = tuple(int(s) for s in data_shape)
        self.num_bins = int(num_bins)
        self.connection = connection
        self.data_size = int(np.prod(self.data_shape))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        images = len(self.data_shape) == 3
        flat = (x.permute(0, 2, 3, 1) if images else x).reshape(x.shape[0], -1)
        acts = self._nonlin(self.linear0(flat))
        if self.connection == "linear":
            out = self.linear2(acts)
        elif self.connection == "cat":
            out = torch.cat([acts, flat[:, self.num_bins:]], dim=1)
        elif self.connection == "softmax":
            out = (flat[:, None, :] * torch.softmax(acts, dim=1)[:, :, None]).sum(dim=1)
        else:  # addition
            out = flat + acts.mean(dim=1, keepdim=True)
        out = out.reshape(x.shape[0], *self.data_shape)
        return out.permute(0, 3, 1, 2) if images else out

    def _nonlin(self, x):
        return F.relu(x)


class ImprintBlock(_Block):
    """Cumulative-bin imprint block (reference: imprint.py:9-93): ``linear0`` projects the
    input onto one measurement direction with biases at the inverse-CDF bin edges, ReLU
    makes bin hits cumulative, the connection maps the activations back."""

    structure = "cumulative"
    default_gain = 1e-3
    # the server's model_modification keys this block takes (the JAX block's fields)
    FIELDS = ("gain", "linfunc", "mode")
    EXTRA_FIELDS = ()

    def __init__(self, data_shape, num_bins: int, connection: str = "linear", gain: float | None = None,
                 linfunc: str = "fourier", mode: int = 0, seed: int = 0, **extra):
        super().__init__(data_shape, num_bins, connection)
        self.gain = float(self.default_gain if gain is None else gain)
        self.linfunc, self.mode, self.seed = linfunc, int(mode), int(seed)
        for key, value in extra.items():  # a subclass's own fields (OneShotBlock's)
            if key not in self.EXTRA_FIELDS:
                raise TypeError(f"{type(self).__name__} takes no field {key}.")
            setattr(self, key, value)
        weights, biases = self._weights_and_biases()
        if weights.shape[0] != biases.shape[0]:  # where the JAX block cannot be built either
            raise ValueError(f"{type(self).__name__}: {weights.shape[0]} measurement rows for "
                             f"{biases.shape[0]} bin edges (num_bins={num_bins}).")
        self.linear0 = _linear(weights, biases)
        if connection == "linear":
            self.linear2 = _linear(np.ones((self.data_size, self.num_bins), np.float32) / self.gain,
                                   np.full((self.data_size,), -float(np.mean(self._bins())), np.float32))

    def _bins(self):
        bins = [-10.0]
        mass_per_bin = 1 / self.num_bins
        for i in range(1, self.num_bins):
            if "fourier" in self.linfunc:
                bins.append(float(laplace(loc=0.0, scale=1 / math.sqrt(2)).ppf(i * mass_per_bin)))
            else:
                bins.append(float(norm().ppf(i * mass_per_bin)))
        return bins

    def _weights_and_biases(self):
        rng = np.random.default_rng(self.seed)
        weights = _linear_query(self.linfunc, self.mode, self.num_bins, self.data_size, rng) * self.gain
        biases = -np.asarray(self._bins(), np.float32) * self.gain
        return weights, biases


class SparseImprintBlock(ImprintBlock):
    """Sparse bins through a hard-tanh window (reference: imprint.py:96-130)."""

    structure = "sparse"
    default_gain = 1.0

    def _bins(self):
        bins, mass = [], 0.0
        for _ in range(self.num_bins + 1):
            mass += 1 / (self.num_bins + 2)
            if "fourier" in self.linfunc:
                bins.append(float(laplace(loc=0, scale=1 / math.sqrt(2)).ppf(mass)))
            else:
                bins.append(float(norm().ppf(mass)))
        self._bin_sizes = [bins[i + 1] - bins[i] for i in range(len(bins) - 1)]
        return bins[1:]

    def _weights_and_biases(self):
        rng = np.random.default_rng(self.seed)
        bins = self._bins()
        weights = _linear_query(self.linfunc, self.mode, self.num_bins, self.data_size, rng)
        weights = weights / np.asarray(self._bin_sizes, np.float32)[:, None]
        biases = -np.asarray(bins, np.float32) / np.asarray(self._bin_sizes, np.float32)
        return (weights * self.gain).astype(np.float32), (biases * self.gain).astype(np.float32)

    def _nonlin(self, x):
        return torch.clamp(x, 0.0, self.gain)


class OneShotBlock(ImprintBlock):
    """Two bins around a known value (reference: imprint.py:133-155); ``virtual_bins``
    (default ``num_bins``) sets the bin grid the two are taken from."""

    structure = "cumulative"
    FIELDS = ImprintBlock.FIELDS + ("target_val",)
    EXTRA_FIELDS = ("target_val", "virtual_bins")
    target_val = 0.0
    virtual_bins = 0

    def _bins(self):
        v_bins = self.virtual_bins or self.num_bins
        bins = [-10.0]
        mass_per_bin = 1 / v_bins
        for i in range(1, v_bins):
            if "fourier" in self.linfunc:
                bins.append(float(laplace(loc=0.0, scale=1 / math.sqrt(2)).ppf(i * mass_per_bin)))
            else:
                bins.append(float(norm().ppf(i * mass_per_bin)))
            if self.target_val < bins[-1]:
                break
        return bins[-2:]


class OneShotBlockSparse(SparseImprintBlock):
    """A single sparse bin of uniform mass (reference: imprint.py:158-178)."""

    structure = "sparse"

    def _bins(self):
        mass_per_bin = 1 / self.num_bins
        bins = [-float(norm().ppf(0.5)), -float(norm().ppf(0.5 + mass_per_bin))]
        self._bin_sizes = [bins[1] - bins[0]]
        return bins[:-1]

    def _weights_and_biases(self):
        rng = np.random.default_rng(self.seed)
        bins = self._bins()
        weights = _linear_query(self.linfunc, self.mode, 1, self.data_size, rng)
        weights = weights / np.asarray(self._bin_sizes, np.float32)[:, None]
        biases = -np.asarray(bins, np.float32) / np.asarray(self._bin_sizes, np.float32)
        return weights.astype(np.float32), biases.astype(np.float32)


class CuriousAbandonHonesty(_Block):
    """Trap-weight sparse ReLU block (Boenisch et al.; reference: imprint.py:181-238): each
    row has half negative and half positive-scaled random entries, so that one example
    activates each trap neuron with a known probability."""

    structure = "sparse"
    FIELDS = ("mu", "sigma", "scale_factor")

    def __init__(self, data_shape, num_bins: int, mu: float = 0.0, sigma: float = 0.5, scale_factor: float = 0.95,
                 connection: str = "linear", seed: int = 0):
        # the JAX block adds for every connection but "linear"
        super().__init__(data_shape, num_bins, connection if connection == "linear" else "addition")
        self.mu, self.sigma, self.scale_factor, self.seed = float(mu), float(sigma), float(scale_factor), int(seed)
        self.linear0 = _linear(self._trap_weights(), np.full((self.num_bins,), self.mu, np.float32))
        if connection == "linear":
            self.linear2 = _linear(np.ones((self.data_size, self.num_bins), np.float32),
                                   np.zeros((self.data_size,), np.float32))

    def _trap_weights(self):
        N, K = self.data_size, self.num_bins
        rng = np.random.default_rng(self.seed)
        final = np.empty((K, N), np.float32)
        for row in range(K):
            perm = rng.permutation(N)
            sampled = -np.abs(rng.standard_normal(N // 2) * self.sigma)
            final[row, perm[: N // 2]] = sampled
            final[row, perm[N // 2:]] = np.resize(-self.scale_factor * sampled, N - N // 2)
        return final
