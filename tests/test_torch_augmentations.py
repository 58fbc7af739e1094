"""The port's attack augmentations against the JAX package's, on the JAX package's own
draws: each of the nine entries of ``augmentation_lookup`` applied to the same images
(NHWC on the JAX side, NCHW in the port), value and input gradient (the JAX
function's VJP against autograd, under the same random cotangent), to 1e-6 absolute,
or 1e-6 of the largest reference entry where that exceeds 1 (the images are standard
normal, up to about 4). Only an upsampling (``zoom`` to a larger size,
``centerzoom``) needs the second: its weights are rounded in float32 on each side in
another way, and its gradient sums up to (out / in)^2 cotangents per pixel in another
order [measured: 1.8e-6 in value and 2.0e-6 in gradient at largest entries of 3-6;
each package is 3.6e-6 from the float64 evaluation]; every other augmentation agrees
to 1e-6 absolute.
The draws are what the JAX augmentation draws from its key, recomputed from that key
and handed to the port's ``apply``; the port's own ``sample`` is held to their
shapes and ranges. ``resize``, which ``Zoom``, ``CenterZoom`` and the multiscale
attack use, is held to ``jax.image.resize`` in tests/test_torch_multiscale.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.attacks.auxiliaries import augmentations as jax_augs
from breaching_tpu_torch.attacks.auxiliaries import augmentations as augs

torch.set_num_threads(1)
SHAPE = (2, 16, 16, 3)  # NHWC


def _jax_draws(name, aug, key):
    """The random numbers the JAX augmentation draws from ``key``, in the port's layout."""
    if name == "discrete_shift":
        k1, k2 = jax.random.split(key)
        return np.array([int(jax.random.randint(k, (), -aug.lim, aug.lim)) for k in (k1, k2)])
    if name == "focus":
        return np.asarray(jax.random.uniform(key, (2,)))
    if name == "flip":
        return np.asarray(jax.random.uniform(key, ()))
    if name == "colorjitter":
        k1, k2 = jax.random.split(key)
        n = [np.asarray(jax.random.normal(k, (SHAPE[0], 1, 1, SHAPE[3]))) for k in (k1, k2)]
        return np.stack([np.transpose(v, (0, 3, 1, 2)) for v in n])
    if name == "continuous_shift":
        return np.asarray(jax.random.uniform(key, (SHAPE[0], 4)))
    return None


CASES = {  # id -> (lookup name, keyword arguments)
    "antialias": ("antialias", dict(width=5)),
    "antialias-width4-stride2": ("antialias", dict(width=4, stride=2)),
    "continuous_shift-circular-224": ("continuous_shift", dict(shift=224, padding="circular")),
    "continuous_shift-reflection-flips": ("continuous_shift", dict(shift=5, fliplr=True, flipud=True)),
    "colorjitter": ("colorjitter", dict(mean=0.1, std=2.0)),
    "flip-always": ("flip", dict(p=1.0)),
    "flip-never": ("flip", dict(p=0.0)),
    "zoom-up": ("zoom", dict(out_size=24)),
    "zoom-down": ("zoom", dict(out_size=12)),
    "focus": ("focus", dict(size=12, std=3.0)),
    "discrete_shift": ("discrete_shift", dict(lim=5)),
    "median": ("median", dict(kernel_size=3)),
    "centerzoom": ("centerzoom", dict(initial_fov=8, out_size=20)),
}


def test_every_augmentation_of_the_lookup_is_ported():
    assert set(augs.augmentation_lookup) == set(jax_augs.augmentation_lookup)
    assert {name for name, _ in CASES.values()} == set(jax_augs.augmentation_lookup)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_augmentation_matches_jax_on_its_draws(case, seed):
    name, kwargs = CASES[case]
    j_aug, aug = jax_augs.augmentation_lookup[name](**kwargs), augs.augmentation_lookup[name](**kwargs)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(seed + 11)
    want, vjp = jax.vjp(lambda v: j_aug(v, key), jnp.asarray(x))
    cotangent = rng.normal(size=want.shape).astype(np.float32)
    want_grad, = vjp(jnp.asarray(cotangent))

    draws = _jax_draws(name, j_aug, key)
    draws = None if draws is None else torch.from_numpy(np.array(draws))
    xt = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()).requires_grad_(True)
    got = aug.apply(xt, draws)
    grad, = torch.autograd.grad(got, xt, torch.from_numpy(np.transpose(cotangent, (0, 3, 1, 2)).copy()))
    for value, reference in ((got.detach(), want), (grad, want_grad)):
        reference = np.transpose(np.asarray(reference), (0, 3, 1, 2))
        atol = 1e-6 * (max(1.0, np.abs(reference).max()) if name in ("zoom", "centerzoom") else 1.0)
        np.testing.assert_allclose(value.numpy(), reference, rtol=0, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_draws_have_the_jax_shapes_and_ranges(case):
    name, kwargs = CASES[case]
    aug = augs.augmentation_lookup[name](**kwargs)
    nchw = (SHAPE[0], SHAPE[3], SHAPE[1], SHAPE[2])
    generator = torch.Generator().manual_seed(3)
    draws = aug.sample(nchw, generator)
    want = _jax_draws(name, jax_augs.augmentation_lookup[name](**kwargs), jax.random.PRNGKey(0))
    if want is None:
        assert draws is None
        return
    assert tuple(draws.shape) == np.shape(want)
    if name == "discrete_shift":
        assert draws.dtype == torch.int64 and bool(((draws >= -aug.lim) & (draws < aug.lim)).all())
    elif name != "colorjitter":
        assert bool(((draws >= 0) & (draws < 1)).all())
    assert not torch.equal(draws, aug.sample(nchw, generator))  # fresh at every call
    out = aug.apply(torch.randn(nchw), draws)
    assert bool(torch.isfinite(out).all())
