"""Augmentations of the candidate inside the attack's objective (counterpart of
``breaching_tpu/attacks/auxiliaries/augmentations.py``), on NCHW images.

Each augmentation is split into a draw and a deterministic apply: ``sample(shape,
generator)`` draws the random numbers the JAX package draws from its key, in the
same shapes and ranges, and ``apply(x, draws)`` does the rest of its arithmetic in
the same order, so that a test can hand the JAX package's own draws to ``apply``.
The augmentations without randomness draw ``None``. ``host_draws`` marks the two
whose draws become Python integers (a roll, a crop offset): they draw from a CPU
generator, so that the step does not wait on the card; the others draw on the
candidate's device. ``batch_axis`` is the axis of a draw that runs over the batch's images
(None where one draw serves the whole batch): a rank of a batch-sharded attack draws for
the whole batch and keeps its images' part. All of them are PyTorch operations: no Pallas kernel backs them
in the JAX package either.

``resize`` is ``jax.image.resize(..., "bilinear")``: half-pixel bilinear
interpolation that antialiases when it downsamples (a triangle filter widened by the
scale), which is ``F.interpolate(mode="bilinear", align_corners=False)`` with
``antialias=True`` for a smaller size and ``False`` for a larger one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of NCHW images to ``size`` (H, W), as ``jax.image.resize``."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    downsampling = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=downsampling)


class Augmentation:
    host_draws = False
    batch_axis = None

    def sample(self, shape, generator: torch.Generator):
        """The random numbers of one application to images of NCHW ``shape``, or None."""
        return None

    def apply(self, x: torch.Tensor, draws) -> torch.Tensor:
        raise NotImplementedError


class Jitter(Augmentation):
    """Random integer roll along H and W (JAX ``Jitter``): two offsets in [-lim, lim)."""

    host_draws = True

    def __init__(self, lim=32, **kwargs):
        self.lim = int(lim)

    def sample(self, shape, generator):
        return torch.randint(-self.lim, self.lim, (2,), generator=generator, device=generator.device)

    def apply(self, x, draws):
        return torch.roll(x, (int(draws[0]), int(draws[1])), dims=(2, 3))

    def __repr__(self):
        return f"Jitter(lim={self.lim})"


class Focus(Augmentation):
    """A size x size crop near the centre (JAX ``Focus``): the offset is the centre's
    plus (2u - 1) std for u uniform, truncated to an integer and clipped."""

    host_draws = True

    def __init__(self, size=224, std=1.0, **kwargs):
        self.size = int(size)
        self.std = float(std)

    def sample(self, shape, generator):
        return torch.rand(2, generator=generator, device=generator.device)

    def apply(self, x, draws):
        h, w = x.shape[2:4]
        pert = (draws * 2 - 1) * self.std
        x0 = min(max(int((pert[0] + h // 2 - self.size // 2).to(torch.int32)), 0), h - self.size)
        y0 = min(max(int((pert[1] + w // 2 - self.size // 2).to(torch.int32)), 0), w - self.size)
        return x[:, :, x0:x0 + self.size, y0:y0 + self.size]

    def __repr__(self):
        return f"Focus(size={self.size}, std={self.std})"


class Zoom(Augmentation):
    """Bilinear resize to out_size x out_size (JAX ``Zoom``)."""

    def __init__(self, out_size=224, **kwargs):
        self.out_size = int(out_size)

    def apply(self, x, draws=None):
        return resize(x, (self.out_size, self.out_size))

    def __repr__(self):
        return f"Zoom(out_size={self.out_size})"


class CenterZoom(Augmentation):
    """The centre fov x fov crop, resized to out_size (JAX ``CenterZoom``)."""

    def __init__(self, initial_fov=32, out_size=224, **kwargs):
        self.fov = int(initial_fov)
        self.out_size = int(out_size)

    def apply(self, x, draws=None):
        h, w = x.shape[2:4]
        h0, w0 = (h - self.fov) // 2, (w - self.fov) // 2
        return resize(x[:, :, h0:h0 + self.fov, w0:w0 + self.fov], (self.out_size, self.out_size))

    def __repr__(self):
        return f"CenterZoom(fov={self.fov}, out_size={self.out_size})"


class Flip(Augmentation):
    """Horizontal flip of the whole batch where a uniform draw is below p (JAX ``Flip``)."""

    def __init__(self, p=0.5, **kwargs):
        self.p = float(p)

    def sample(self, shape, generator):
        return torch.rand((), generator=generator, device=generator.device)

    def apply(self, x, draws):
        return torch.where(draws < self.p, torch.flip(x, dims=(3,)), x)

    def __repr__(self):
        return f"Flip(p={self.p})"


class ColorJitter(Augmentation):
    """Per image and channel, x exp(0.1 std n1) + 0.1 std n2 + mean for standard normal
    n1, n2 (JAX ``ColorJitter``); the draws are (2, B, C, 1, 1)."""

    batch_axis = 1

    def __init__(self, batch_size=1, shuffle_every=False, mean=0.0, std=1.0, **kwargs):
        self.mean = float(mean or 0.0)
        self.std = float(std or 1.0)

    def sample(self, shape, generator):
        return torch.randn((2, shape[0], shape[1], 1, 1), generator=generator, device=generator.device)

    def apply(self, x, draws):
        scale = torch.exp(draws[0] * 0.1 * self.std)
        shift = draws[1] * 0.1 * self.std + self.mean
        return x * scale + shift

    def __repr__(self):
        return "ColorJitter()"


class MedianPool(Augmentation):
    """k x k median filter over reflect-padded images (JAX ``MedianPool``)."""

    def __init__(self, kernel_size=3, stride=1, padding=0, same=True, **kwargs):
        self.k = int(kernel_size)

    def apply(self, x, draws=None):
        p = self.k // 2
        padded = F.pad(x, (p, p, p, p), mode="reflect")
        h, w = x.shape[2:4]
        patches = [padded[:, :, i:i + h, j:j + w] for i in range(self.k) for j in range(self.k)]
        return torch.stack(patches).median(dim=0).values

    def __repr__(self):
        return f"MedianPool(k={self.k})"


class RandomTransform(Augmentation):
    """A random sub-pixel shift of each image by up to ``shift`` pixels, with optional
    random flips, resampled bilinearly (JAX ``RandomTransform``). The draws are (B, 4)
    uniforms: the shifts along W and H, and the two flips. The sample coordinates wrap
    circularly or reflect; the four neighbours are gathered by index (``grid_sample``
    has no circular padding), clamped into the image as the JAX gather clamps them."""

    batch_axis = 0

    def __init__(self, shift=8, fliplr=False, flipud=False, mode="bilinear",
                 padding="reflection", align=False, **kwargs):
        self.shift = float(shift)
        self.fliplr = bool(fliplr)
        self.flipud = bool(flipud)
        self.padding = padding

    def sample(self, shape, generator):
        return torch.rand((shape[0], 4), generator=generator, device=generator.device)

    def _wrap(self, coord, size):
        if self.padding == "circular":  # x mod size with the divisor's sign, as jnp.remainder
            mod = torch.fmod(coord, size)
            return torch.where((mod != 0) & (mod < 0), mod + size, mod)
        reflected = coord.abs()
        reflected = torch.where(reflected > size - 1, 2 * (size - 1) - reflected, reflected)
        return reflected.clamp(0, size - 1)

    def apply(self, x, draws):
        B, C, H, W = x.shape
        dx = (draws[:, 0] - 0.5) * 2 * self.shift
        dy = (draws[:, 1] - 0.5) * 2 * self.shift
        rows = torch.arange(H, dtype=x.dtype, device=x.device)[None, :] + dy[:, None]  # (B, H)
        cols = torch.arange(W, dtype=x.dtype, device=x.device)[None, :] + dx[:, None]  # (B, W)
        if self.fliplr:
            cols = torch.where(draws[:, 2, None] > 0.5, (W - 1) - cols, cols)
        if self.flipud:
            rows = torch.where(draws[:, 3, None] > 0.5, (H - 1) - rows, rows)
        rows, cols = self._wrap(rows, H), self._wrap(cols, W)
        r0, c0 = torch.floor(rows), torch.floor(cols)
        wr, wc = (rows - r0)[:, None, :, None], (cols - c0)[:, None, None, :]
        r0i, c0i = r0.long(), c0.long()
        if self.padding == "circular":
            r1i, c1i = (r0i + 1) % H, (c0i + 1) % W
        else:
            r1i, c1i = torch.clamp(r0i + 1, max=H - 1), torch.clamp(c0i + 1, max=W - 1)
        r0i, c0i = r0i.clamp(0, H - 1), c0i.clamp(0, W - 1)
        b = torch.arange(B, device=x.device)[:, None, None, None]
        c = torch.arange(C, device=x.device)[None, :, None, None]

        def at(ri, ci):
            return x[b, c, ri[:, None, :, None], ci[:, None, None, :]]

        top = at(r0i, c0i) * (1 - wc) + at(r0i, c1i) * wc
        bot = at(r1i, c0i) * (1 - wc) + at(r1i, c1i) * wc
        return top * (1 - wr) + bot * wr

    def __repr__(self):
        return f"RandomTransform(shift={self.shift}, padding={self.padding})"


class AntiAlias(Augmentation):
    """Binomial blur of each channel, zero-padded by width // 2 (JAX ``AntiAlias``)."""

    def __init__(self, channels=3, width=5, stride=1, **kwargs):
        base = np.asarray({
            1: [1.0], 2: [1.0, 1.0], 3: [1.0, 2.0, 1.0], 4: [1.0, 3.0, 3.0, 1.0],
            5: [1.0, 4.0, 6.0, 4.0, 1.0], 6: [1.0, 5.0, 10.0, 10.0, 5.0, 1.0],
            7: [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0]}[int(width)])
        kernel = base[:, None] * base[None, :]
        self.kernel = torch.tensor(kernel / kernel.sum(), dtype=torch.float32)
        self.width = int(width)
        self.stride = int(stride)

    def apply(self, x, draws=None):
        C = x.shape[1]
        weight = self.kernel.to(device=x.device, dtype=x.dtype).expand(C, 1, -1, -1)
        return F.conv2d(x, weight, stride=self.stride, padding=self.width // 2, groups=C)

    def __repr__(self):
        return f"AntiAlias(width={self.width})"


augmentation_lookup = dict(
    antialias=AntiAlias,
    continuous_shift=RandomTransform,
    colorjitter=ColorJitter,
    flip=Flip,
    zoom=Zoom,
    focus=Focus,
    discrete_shift=Jitter,
    median=MedianPool,
    centerzoom=CenterZoom,
)
