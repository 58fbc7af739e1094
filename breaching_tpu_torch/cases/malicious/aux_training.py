"""The malicious server's auxiliary encoders and decoders (counterpart of
``breaching_tpu/cases/malicious/aux_training.py``), behind
``model_modification.handle_preceding_layers: VAE``.

- ``ConvEncoder``, ``ConvDecoder`` and ``VAE``: three 3x3 stride-2 convolutions to a
  (mu, logvar) pair of dense heads, and a dense layer back to a feature map of 1/8 the
  size, three 3x3 stride-2 transposed convolutions, a 3x3 convolution and a bilinear
  resize to the image. ``train_encoder_decoder`` trains one of four archs on the server's
  data (``AE``, ``VAE``, and the vector-quantized ``VQ_VAE`` and ``VQ_CVAE`` through
  ``nearest_embed``); the top placement decodes the readout's images with it.
- ``FeatureDecoder`` and ``train_feature_decoder``: a decoder from a feature map inside the
  model back to the image (a bilinear resize and three 3x3 convolutions), trained on the
  model's own prefix; the deep placement decodes the readout's feature rows with it.
- ``nearest_embed`` (a straight-through estimator whose backward pass scatters the
  gradient onto the chosen codes, averaged by their assignment counts) and
  ``nearest_embed_ema`` (the codebook as exponential moving averages, functional on a dict).

The layers are flax's: ``SameConv`` pads as flax's ``padding="SAME"`` does, (0, 1) on an
even side at stride 2 where ``nn.Conv2d(padding=1)`` would pad (1, 1); ``SameConvTranspose``
is ``lax.conv_transpose`` with ``padding="SAME"`` and the kernel not flipped, pads (2, 1) of
the dilated input, which is ``F.conv_transpose2d`` without padding and its last row and
column cut, on the flax kernel flipped and its two channel axes swapped (the weight
bridge's transform). The dense layers see feature maps flattened in height-width-channel
order, flax's. Parameters are named by their flax paths (``Conv_0``, ``mu``,
``ConvTranspose_2``, ...; the codebook ``codebook``, (latent, codes)), so that
``model_preparation.load_flat_state`` takes the JAX package's parameters, and start from
flax's initializers (``lecun_normal`` kernels, zero biases) drawn from an explicit
generator. ``decode`` takes and returns NHWC arrays, as the JAX package's; inside, the
modules run on NCHW tensors.

Each training run is a loop of ``train_step`` calls on Adam as ``optax.adam`` (b1 0.9, b2
0.999, eps 1e-8, bias-corrected). Its random draws (the batch indices, the VAE's noise, the
synthetic data) are made on the device from a generator seeded with ``seed`` and handed to
the step and the losses as arguments, so that a test can hand them the JAX package's draws.
The step's losses stay on the device until the run ends; they are kept in the trained
module's ``losses``. No Pallas kernel backs any of this in the JAX package (XLA compiles the
layers), and the port runs them as ``torch.nn`` layers.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ...attacks.auxiliaries.augmentations import resize
from ...attacks.auxiliaries.optimizers import FirstOrder
from ..models.layers import direct, lecun_normal_

log = logging.getLogger(__name__)

ARCHS = ("AE", "VAE", "VQ_VAE", "VQ_CVAE")
# (vq_coef, commit_coef) per quantized arch (reference VAE.py VQ_VAE:69, VQ_CVAE:98)
_VQ_COEFS = {"VQ_VAE": (0.2, 0.4), "VQ_CVAE": (1.0, 0.5)}


def _same_pads(size: int, stride: int, kernel: int = 3) -> tuple[int, int]:
    """(before, after) padding of one side of ``size`` under flax's ``padding="SAME"``."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv(nn.Conv2d):
    """flax's ``nn.Conv`` with a 3x3 kernel and ``padding="SAME"``."""

    flax_direct = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride = self.stride[0]
        return super().forward(F.pad(x, (*_same_pads(x.shape[-1], stride), *_same_pads(x.shape[-2], stride))))


class SameConvTranspose(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose`` with a 3x3 kernel, stride 2 and ``padding="SAME"``:
    twice the input's height and width."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)[..., :2 * h, :2 * w]

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/kernel", self.weight, flax_transposed_kernel
        yield f"params/{prefix}/bias", self.bias, None


def flax_transposed_kernel(kernel: np.ndarray) -> np.ndarray:
    """A flax ``ConvTranspose`` kernel (H, W, I, O), applied unflipped, as the weight
    (I, O, H, W) of PyTorch's transposed convolution, which flips it."""
    return np.ascontiguousarray(np.transpose(np.flip(kernel, (0, 1)), (2, 3, 0, 1)))


flax_transposed_kernel.inverse = lambda weight: np.flip(np.transpose(weight, (2, 3, 0, 1)), (0, 1))


def _flax_init(layer: nn.Module, fan_in: int, generator) -> nn.Module:
    lecun_normal_(layer.weight, fan_in, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


def _conv(in_channels, out_channels, generator, stride=1):
    return _flax_init(skip_init(SameConv, in_channels, out_channels, 3, stride), in_channels * 9, generator)


def _dense(in_features, out_features, generator):
    return _flax_init(direct(skip_init(nn.Linear, in_features, out_features)), in_features, generator)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class ConvEncoder(nn.Module):
    """NCHW images of ``in_shape`` (H, W, C) to (mu, logvar), each (N, latent_dim)."""

    def __init__(self, in_shape, latent_dim: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        h, w, c = in_shape
        for i, (cin, cout) in enumerate(((c, 32), (32, 64), (64, 128))):
            self.add_module(f"Conv_{i}", _conv(cin, cout, generator, stride=2))
            h, w = -(-h // 2), -(-w // 2)
        self.mu = _dense(h * w * 128, latent_dim, generator)
        self.logvar = _dense(h * w * 128, latent_dim, generator)

    def forward(self, x: torch.Tensor):
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.mu(x), self.logvar(x)


class ConvDecoder(nn.Module):
    """Latent rows (N, latent_dim) to NCHW images of ``out_shape`` (H, W, C)."""

    def __init__(self, out_shape, latent_dim: int = 128, generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape = tuple(int(v) for v in out_shape)
        h, w, c = self.out_shape
        self.start = (max(h // 8, 1), max(w // 8, 1))
        self.Dense_0 = _dense(latent_dim, self.start[0] * self.start[1] * 128, generator)
        for i, (cin, cout) in enumerate(((128, 128), (128, 64), (64, 32))):
            self.add_module(f"ConvTranspose_{i}", _flax_init(skip_init(SameConvTranspose, cin, cout, 3, 2), cin * 9,
                                                             generator))
        self.Conv_0 = _conv(32, c, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(z).reshape(z.shape[0], *self.start, 128).permute(0, 3, 1, 2)
        for conv in (self.ConvTranspose_0, self.ConvTranspose_1, self.ConvTranspose_2):
            x = F.relu(conv(x))
        return resize(self.Conv_0(x), self.out_shape[:2])


class VAE(nn.Module):
    """``ConvEncoder`` and ``ConvDecoder`` of one image shape, and for the quantized archs
    the ``codebook`` (latent_dim, codes) of their latents."""

    def __init__(self, out_shape, latent_dim: int = 128, arch: str = "VAE", generator: torch.Generator | None = None):
        super().__init__()
        self.latent_dim, self.arch = latent_dim, arch
        self.encoder = ConvEncoder(out_shape, latent_dim, generator)
        self.decoder = ConvDecoder(out_shape, latent_dim, generator)
        self.codebook = None

    def forward(self, x: torch.Tensor, eps: torch.Tensor):
        """(the reconstruction, mu, logvar) of NCHW ``x``, its latent mu + exp(logvar / 2) eps."""
        mu, logvar = self.encoder(x)
        return self.decoder(mu + torch.exp(0.5 * logvar) * eps), mu, logvar

    def flax_entries(self, prefix: str):
        if self.codebook is not None:
            yield "params/codebook", self.codebook, None

    @torch.no_grad()
    def decode(self, z_or_x) -> torch.Tensor:
        """NHWC images from latent rows (N, latent_dim), or from NHWC images re-encoded to
        their mu first; the quantized archs snap the latents to their codebook."""
        z = torch.as_tensor(z_or_x, dtype=torch.float32, device=_device(self))
        if not (z.dim() == 2 and z.shape[-1] == self.latent_dim):
            if z.dim() != 4:
                raise ValueError(f"decode takes latent rows (N, {self.latent_dim}) or NHWC images, "
                                 f"not an array of shape {tuple(z.shape)}.")
            z = self.encoder(z.permute(0, 3, 1, 2))[0]
        if self.codebook is not None:
            z = nearest_embed(z, self.codebook)
        return self.decoder(z).permute(0, 2, 3, 1)


def _nearest_indices(z: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The nearest code of each row of z (N, d) among the columns of emb (d, K), by
    ||e||^2 - 2 z.e in float32 (the JAX package's product at HIGHEST); ties to the first."""
    scores = torch.sum(emb * emb, dim=0)[None, :] - 2.0 * (z @ emb)
    return torch.argmin(scores, dim=-1)


class _NearestEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, emb):
        idx = _nearest_indices(z, emb)
        ctx.save_for_backward(idx)
        ctx.num_codes = emb.shape[1]
        return emb.t()[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.num_codes).to(grad.dtype)
        counts = torch.clamp(onehot.sum(dim=0), min=1.0)
        return grad, (grad.t() @ onehot) / counts[None, :]


def nearest_embed(z: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Each row of z (N, d) snapped to its nearest column of emb (d, K). Backward: the
    gradient passes straight through to z, and onto each chosen code as the mean of its
    rows' gradients (a code's count floored at 1)."""
    return _NearestEmbed.apply(z, emb)


def nearest_embed_ema(z: torch.Tensor, state: dict, decay: float = 0.99, eps: float = 1e-5,
                      train: bool = True):
    """Vector quantization on a codebook of exponential moving averages (the JAX package's
    ``nearest_embed_ema``): returns (the quantized rows, the new state) for a state
    dict(weight (d, K), cluster_size (K,), embed_avg (d, K)); ``train=False`` returns the
    state it was given."""
    weight = state["weight"]
    idx = _nearest_indices(z, weight)
    quantized = weight.t()[idx]
    if not train:
        return quantized, state
    onehot = F.one_hot(idx, weight.shape[1]).to(z.dtype)
    cluster_size = state["cluster_size"] * decay + (1 - decay) * onehot.sum(dim=0)
    embed_avg = state["embed_avg"] * decay + (1 - decay) * (z.t() @ onehot)
    n = cluster_size.sum()
    denom = (cluster_size + eps) / (n + weight.shape[1] * eps) * n
    return quantized, dict(weight=embed_avg / denom[None, :], cluster_size=cluster_size, embed_avg=embed_avg)


def init_ema_codebook(generator: torch.Generator, emb_dim: int, num_embeddings: int) -> dict:
    """A fresh ``nearest_embed_ema`` state: weights uniform in [0, 1), on the generator's device."""
    weight = torch.rand((emb_dim, num_embeddings), generator=generator, device=generator.device)
    return dict(weight=weight, cluster_size=torch.zeros(num_embeddings, device=weight.device), embed_avg=weight)


def encoder_decoder_loss(model: VAE, batch: torch.Tensor, eps: torch.Tensor | None) -> torch.Tensor:
    """The training loss of ``model.arch`` on the NCHW ``batch``: the reconstruction's MSE,
    plus 1e-3 KL on the VAE (its noise ``eps``, (N, latent_dim)), plus the vq and
    commitment terms on the quantized archs, with the JAX package's stop-gradients."""
    if model.arch == "VAE":
        rec, mu, logvar = model(batch, eps)
        kl = -0.5 * torch.mean(1 + logvar - mu.square() - logvar.exp())
        return torch.mean((rec - batch).square()) + 1e-3 * kl
    z_e, _ = model.encoder(batch)
    if model.arch == "AE":
        return torch.mean((model.decoder(z_e) - batch).square())
    z_q = nearest_embed(z_e, model.codebook.detach())
    emb_q = nearest_embed(z_e.detach(), model.codebook)
    vq_coef, commit_coef = _VQ_COEFS[model.arch]
    return (torch.mean((model.decoder(z_q) - batch).square())
            + vq_coef * torch.mean((emb_q - z_e.detach()).square())
            + commit_coef * torch.mean((emb_q.detach() - z_e).square()))


class Trainer:
    """``optax.adam(lr)`` over every parameter of a module; ``train_step`` takes one step."""

    def __init__(self, module: nn.Module, lr: float):
        self.params = list(module.parameters())
        self.adam = FirstOrder(lambda count: lr, "adamw", eps=1e-8, weight_decay=0.0)
        self.states = [self.adam.init(p) for p in self.params]

    def train_step(self, loss_fn) -> torch.Tensor:
        """One Adam step on the gradient of ``loss_fn()`` (zero for a parameter it does not
        reach, as in the JAX package); returns the loss, on the device."""
        loss = loss_fn()
        grads = torch.autograd.grad(loss, self.params, allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            for param, grad, state in zip(self.params, grads, self.states):
                param.copy_(self.adam.update(grad, state, param))
        return loss.detach()


def _gather(dataloader, count: int, device) -> torch.Tensor:
    """The NCHW images of ``dataloader``'s batches, in order, until they hold ``count``."""
    batches, held = [], 0
    for batch in dataloader:
        batches.append(torch.as_tensor(batch["inputs"], dtype=torch.float32))
        held += batches[-1].shape[0]
        if held >= count:
            break
    return torch.cat(batches).to(device)


def train_encoder_decoder(data_shape, dataloader=None, steps: int = 500, batch_size: int = 32, lr: float = 1e-3,
                          seed: int = 0, arch: str = "VAE", num_embeddings: int = 512, device="cpu"):
    """Train an encoder and decoder of images of ``data_shape`` (H, W, C); returns
    (``model.decode``, the trained ``VAE``).

    The data are ``dataloader``'s images until they hold ``steps``, or without one 256
    normal images of standard deviation 0.5. Each step draws ``batch_size`` of them with
    replacement (and the VAE's noise) and takes one Adam step of ``encoder_decoder_loss``;
    the quantized archs' codebook starts as fmod(0.02 N(0, 1), 0.04)."""
    if arch not in ARCHS:
        raise ValueError(f"Invalid aux-training arch {arch}.")
    h, w, c = data_shape
    init = torch.Generator().manual_seed(seed)
    model = VAE((h, w, c), arch=arch, generator=init)
    if arch in _VQ_COEFS:
        model.codebook = nn.Parameter(torch.fmod(0.02 * torch.randn((model.latent_dim, num_embeddings),
                                                                   generator=init), 0.04))
    model.to(device)
    draws = torch.Generator(device=device).manual_seed(seed)
    data = _gather(dataloader, steps, device) if dataloader is not None else \
        0.5 * torch.randn((256, c, h, w), generator=draws, device=device)
    trainer, losses = Trainer(model, lr), []
    for _ in range(steps):
        sel = torch.randint(data.shape[0], (batch_size,), generator=draws, device=device)
        eps = torch.randn((batch_size, model.latent_dim), generator=draws, device=device) if arch == "VAE" else None
        losses.append(trainer.train_step(lambda: encoder_decoder_loss(model, data[sel], eps)))
    model.losses = torch.stack(losses)
    log.info(f"{arch} training finished: loss {float(model.losses[-1]):.4f} after {steps} steps.")
    return model.decode, model


class FeatureDecoder(nn.Module):
    """Feature rows (N, fh * fw * fc), flattened in height-width-channel order, to NCHW
    images of ``out_shape`` (H, W, C): a bilinear resize of the feature map to the image's
    size, two 3x3 convolutions of ``width`` with ReLUs and a 3x3 convolution to C."""

    def __init__(self, out_shape, feature_shape, width: int = 64, generator: torch.Generator | None = None):
        super().__init__()
        self.out_shape, self.feature_shape = tuple(int(v) for v in out_shape), tuple(int(v) for v in feature_shape)
        self.Conv_0 = _conv(self.feature_shape[2], width, generator)
        self.Conv_1 = _conv(width, width, generator)
        self.Conv_2 = _conv(width, self.out_shape[2], generator)

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        x = resize(f.reshape(f.shape[0], *self.feature_shape).permute(0, 3, 1, 2), self.out_shape[:2])
        return self.Conv_2(F.relu(self.Conv_1(F.relu(self.Conv_0(x)))))

    @torch.no_grad()
    def decode(self, features) -> torch.Tensor:
        """NHWC images from feature rows (or maps: each row is flattened first)."""
        f = torch.as_tensor(features, dtype=torch.float32, device=_device(self))
        return self(f.reshape(f.shape[0], -1)).permute(0, 2, 3, 1)


def smooth_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """256 smooth random NCHW images of ``shape`` (H, W, C): normal noise resized to a
    quarter of its size and back, plus a tenth of the noise."""
    h, w, c = shape
    noise = torch.randn((256, c, h, w), generator=generator, device=generator.device)
    return resize(resize(noise, (max(h // 4, 1), max(w // 4, 1))), (h, w)) + 0.1 * noise


def train_feature_decoder(prefix_fn, data_shape, feature_shape, dataloader=None, steps: int = 800,
                          batch_size: int = 16, lr: float = 2e-3, seed: int = 0, device="cpu"):
    """Train a ``FeatureDecoder`` to invert ``prefix_fn`` (NCHW images to features, each
    image's flattened in the readout's row order): min |D(prefix(x)) - x|^2 over 256
    images of ``dataloader`` (or ``smooth_noise`` without one), ``steps`` Adam steps on
    ``batch_size`` of them drawn with replacement. Returns (``decoder.decode``, the
    trained ``FeatureDecoder``)."""
    init = torch.Generator().manual_seed(seed)
    draws = torch.Generator(device=device).manual_seed(seed)
    data = _gather(dataloader, 256, device)[:256] if dataloader is not None else smooth_noise(draws, data_shape)
    with torch.no_grad():
        feats = prefix_fn(data).reshape(data.shape[0], -1)
    decoder = FeatureDecoder(data_shape, feature_shape, generator=init).to(device)
    trainer, losses = Trainer(decoder, lr), []
    for _ in range(steps):
        sel = torch.randint(data.shape[0], (batch_size,), generator=draws, device=device)
        losses.append(trainer.train_step(lambda: torch.mean((decoder(feats[sel]) - data[sel]).square())))
    decoder.losses = torch.stack(losses)
    log.info(f"Feature decoder trained: loss {float(decoder.losses[0]):.4f} -> {float(decoder.losses[-1]):.4f} "
             f"after {steps} steps.")
    return decoder.decode, decoder


def generate_decoder(feature_dim: int, data_shape, prefix_fn=None, dataloader=None, feature_shape=None,
                     seed: int = 0, device="cpu"):
    """A decoder of feature rows for a deeper imprint placement: trained to invert
    ``prefix_fn`` where one is given (``train_feature_decoder``, features of
    ``feature_shape``, (1, 1, feature_dim) without one); otherwise an untrained
    ``ConvDecoder`` on rows of ``feature_dim``, with a warning."""
    if prefix_fn is not None:
        return train_feature_decoder(prefix_fn, data_shape, feature_shape or (1, 1, feature_dim),
                                     dataloader=dataloader, seed=seed, device=device)
    log.warning("generate_decoder called without a prefix_fn: the decoder is untrained and its readout will be "
                "garbage. Pass the model prefix to train it (see train_feature_decoder).")
    decoder = ConvDecoder(data_shape, feature_dim, generator=torch.Generator().manual_seed(seed)).to(device)

    @torch.no_grad()
    def decode(features):
        return decoder(torch.as_tensor(features, dtype=torch.float32, device=device)).permute(0, 2, 3, 1)

    return decode, decoder
