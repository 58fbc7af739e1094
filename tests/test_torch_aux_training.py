"""The port's auxiliary encoders and decoders (``cases/malicious/aux_training.py``) against
the JAX package's, at small sizes on the CPU:

- the behaviours of ``tests/test_aux_training.py`` (the snap to the nearest code, the
  straight-through and codebook gradients, each arch trained and decoding both ways, the
  bad-arch refusal, the EMA codebook moving toward the data), each package on the same
  inputs;
- ``ConvEncoder``, ``ConvDecoder`` (8x8x1, 16x16x3 and 12x12x3, where the decoder resizes)
  and ``FeatureDecoder`` on the JAX package's parameters through the weight bridge:
  outputs to 1e-5, parameter and input gradients to 1e-4 of each leaf's largest entry;
- each arch's loss and gradient at the JAX package's initial parameters on its own draws
  (batch indices and noise), to 1e-5; its first 3 Adam steps, and those of the feature
  decoder, to 1e-5 of each leaf's largest entry; then ``decode`` on the trained parameters;
- ``nearest_embed_ema`` over 50 steps to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from breaching_tpu.cases.malicious import aux_training as jax_aux
from breaching_tpu_torch.cases.malicious import aux_training as aux
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state
from test_torch_imprint import _flat

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _keys(module):
    """The port's parameters of ``module`` by their JAX flat key."""
    return {key: (tensor, transform) for key, tensor, transform in _flat_entries(module)}


def _close_tree(module, jax_params, rel, grads=False, of_tree=False):
    """Every parameter of ``module`` (or its ``.grad``) against the JAX tree, in the port's
    layout, to ``rel`` of each leaf's largest entry (``of_tree``: of the whole tree's)."""
    flat = _flat(jax_params)
    entries = _keys(module)
    assert sorted(entries) == sorted(flat)
    scale = max(np.abs(v).max() for v in flat.values()) if of_tree else None
    for key, (tensor, transform) in entries.items():
        want = transform(flat[key]) if transform is not None else flat[key]
        if of_tree:
            np.testing.assert_allclose(tensor.detach().numpy(), want, rtol=0, atol=rel * scale)
            continue
        if grads:  # a parameter the loss does not reach has no gradient: zero, as the JAX package's
            tensor = tensor.grad if tensor.grad is not None else torch.zeros_like(tensor)
        _close(tensor, want, rel)


def _nchw(x):
    return torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


def _vae(shape, arch, params):
    model = aux.VAE(shape, arch=arch)
    if "codebook" in params:
        model.codebook = torch.nn.Parameter(torch.zeros(np.shape(params["codebook"])))
    assert load_flat_state(model, _flat(params), strict=True) == len(_keys(model))
    return model


# ---------------------------------------------------------------- tests/test_aux_training.py's behaviours

def test_nearest_embed_forward_snaps_to_nearest():
    emb = np.array([[0.0, 1.0, -2.0], [0.0, 1.0, -2.0]], np.float32)  # codes (0,0), (1,1), (-2,-2)
    z = np.array([[0.2, -0.1], [0.8, 1.3], [-1.0, -1.6]], np.float32)
    out = aux.nearest_embed(torch.as_tensor(z), torch.as_tensor(emb))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_aux.nearest_embed(jnp.asarray(z), jnp.asarray(emb))))
    np.testing.assert_array_equal(out.numpy(), [[0, 0], [1, 1], [-2, -2]])


def test_nearest_embed_straight_through_and_codebook_grad():
    emb = np.array([[0.0, 1.0], [0.0, 1.0]], np.float32)  # codes (0,0) and (1,1)
    z = np.array([[0.1, 0.0], [0.9, 1.0], [1.1, 1.0]], np.float32)  # codes 0, 1, 1
    g = np.arange(6.0, dtype=np.float32).reshape(3, 2)
    tz, temb = torch.tensor(z, requires_grad=True), torch.tensor(emb, requires_grad=True)
    gz, gemb = torch.autograd.grad(aux.nearest_embed(tz, temb), (tz, temb), torch.as_tensor(g))
    jz = jax.vjp(lambda z_: jax_aux.nearest_embed(z_, jnp.asarray(emb)), jnp.asarray(z))[1](jnp.asarray(g))[0]
    jemb = jax.vjp(lambda e: jax_aux.nearest_embed(jnp.asarray(z), e), jnp.asarray(emb))[1](jnp.asarray(g))[0]
    np.testing.assert_array_equal(gz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(gemb.numpy(), np.asarray(jemb))
    np.testing.assert_array_equal(gemb.numpy(), np.stack([g[0], (g[1] + g[2]) / 2.0], axis=1))


@pytest.mark.parametrize("arch", ["AE", "VQ_VAE", "VQ_CVAE"])
def test_train_encoder_decoder_archs(arch):
    """The JAX test's checks on the port's own run: the codebook's shape, the re-encode and
    the latent-rows paths of ``decode`` giving finite images of the data's shape."""
    decode, model = aux.train_encoder_decoder((8, 8, 1), steps=20, batch_size=8, arch=arch, num_embeddings=16)
    if arch != "AE":
        assert tuple(model.codebook.shape) == (128, 16)
    x = torch.randn((2, 8, 8, 1), generator=torch.Generator().manual_seed(3)) * 0.3
    rec = decode(x)
    assert rec.shape == (2, 8, 8, 1) and torch.isfinite(rec).all()
    z = torch.randn((2, 128), generator=torch.Generator().manual_seed(4)) * 0.02
    assert decode(z).shape == (2, 8, 8, 1)
    assert model.losses.shape == (20,) and torch.isfinite(model.losses).all()


def test_train_encoder_decoder_rejects_bad_arch():
    with pytest.raises(ValueError, match="Invalid aux-training arch GAN"):
        aux.train_encoder_decoder((8, 8, 1), steps=1, arch="GAN")
    with pytest.raises(ValueError, match="Invalid aux-training arch GAN"):
        jax_aux.train_encoder_decoder((8, 8, 1), steps=1, arch="GAN")


def test_nearest_embed_ema_matches_jax_over_50_steps():
    """From the JAX package's initial state, 50 training steps on one tight cluster agree to
    1e-6 of each leaf's largest entry, the winning code lands on the cluster, and eval mode
    returns the state it was given."""
    j_state = jax_aux.init_ema_codebook(jax.random.PRNGKey(0), 2, 4)
    state = {k: torch.tensor(np.asarray(v)) for k, v in j_state.items()}
    data = np.full((8, 2), 5.0, np.float32)
    for _ in range(50):
        q, state = aux.nearest_embed_ema(torch.as_tensor(data), state, decay=0.8)
        j_q, j_state = jax_aux.nearest_embed_ema(jnp.asarray(data), j_state, decay=0.8)
        _close(q, j_q, 1e-6)
    for key in state:
        _close(state[key], j_state[key], 1e-6)
    assert float(torch.min(torch.linalg.norm(state["weight"].t() - 5.0, dim=1))) < 0.5
    q2, state2 = aux.nearest_embed_ema(torch.as_tensor(data), state, train=False)
    assert state2 is state
    np.testing.assert_allclose(q2.numpy(), q.numpy())  # the JAX test's check


def test_fresh_ema_codebook_is_uniform_on_the_generator():
    state = aux.init_ema_codebook(torch.Generator().manual_seed(0), 3, 5)
    assert state["weight"].shape == (3, 5) and float(state["weight"].min()) >= 0 and float(state["weight"].max()) < 1
    assert state["embed_avg"] is state["weight"] and not state["cluster_size"].any()


# ---------------------------------------------------------------- the modules through the bridge

def _module_gradients(module, j_module, j_params, x, port_x, cotangent):
    """The port's output and its parameter and input gradients under sum(out * cotangent),
    against the JAX module's on the same parameters."""
    port_x = port_x.clone().requires_grad_(True)
    out = module(port_x)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, cotangent))
    loss.backward()

    def j_loss(p, x_):
        j_out = j_module.apply({"params": p}, x_)
        j_out = j_out if isinstance(j_out, tuple) else (j_out,)
        return sum(jnp.sum(o * c) for o, c in zip(j_out, cotangent)), j_out

    (_, j_outs), (j_grads, j_xgrad) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(j_params, x)
    return outs, j_outs, port_x.grad, j_xgrad, j_grads


@pytest.mark.parametrize("shape", [(8, 8, 1), (16, 16, 3), (12, 12, 3)])
def test_conv_encoder_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    j_module = jax_aux.ConvEncoder(128)
    j_params = j_module.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    module = aux.ConvEncoder(shape)
    load_flat_state(module, _flat(j_params), strict=True)
    cot = [rng.standard_normal((2, 128)).astype(np.float32) for _ in range(2)]
    outs, j_outs, xgrad, j_xgrad, j_grads = _module_gradients(module, j_module, j_params, jnp.asarray(x),
                                                              _nchw(x), cot)
    for out, j_out in zip(outs, j_outs):
        _close(out, j_out, 1e-5)
    _close(xgrad.permute(0, 2, 3, 1), j_xgrad, 1e-4)
    _close_tree(module, j_grads, 1e-4, grads=True)


@pytest.mark.parametrize("shape", [(8, 8, 1), (16, 16, 3), (12, 12, 3)])
def test_conv_decoder_matches_jax(shape):
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 128)).astype(np.float32)
    j_module = jax_aux.ConvDecoder(shape)
    j_params = j_module.init(jax.random.PRNGKey(2), jnp.asarray(z))["params"]
    module = aux.ConvDecoder(shape)
    load_flat_state(module, _flat(j_params), strict=True)
    cot = [rng.standard_normal((2, *shape)).astype(np.float32)]
    outs, j_outs, zgrad, j_zgrad, j_grads = _module_gradients(
        lambda z_: module(z_).permute(0, 2, 3, 1), j_module, j_params, jnp.asarray(z), torch.as_tensor(z), cot)
    _close(outs[0], j_outs[0], 1e-5)
    _close(zgrad, j_zgrad, 1e-4)
    _close_tree(module, j_grads, 1e-4, grads=True)


@pytest.mark.parametrize("feature_shape", [(4, 4, 8), (8, 8, 16)])
def test_feature_decoder_matches_jax(feature_shape):
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, int(np.prod(feature_shape)))).astype(np.float32)
    j_module = jax_aux.FeatureDecoder(out_shape=(8, 8, 3), feature_shape=feature_shape)
    j_params = j_module.init(jax.random.PRNGKey(3), jnp.asarray(f))["params"]
    module = aux.FeatureDecoder((8, 8, 3), feature_shape)
    load_flat_state(module, _flat(j_params), strict=True)
    cot = [rng.standard_normal((3, 8, 8, 3)).astype(np.float32)]
    outs, j_outs, fgrad, j_fgrad, j_grads = _module_gradients(
        lambda f_: module(f_).permute(0, 2, 3, 1), j_module, j_params, jnp.asarray(f), torch.as_tensor(f), cot)
    _close(outs[0], j_outs[0], 1e-5)
    _close(fgrad, j_fgrad, 1e-4)
    _close_tree(module, j_grads, 1e-4, grads=True)
    _close(module.decode(f.reshape(3, *feature_shape)), j_module.apply({"params": j_params}, jnp.asarray(f)), 1e-5)


# ---------------------------------------------------------------- training on the JAX package's draws

SHAPE, BATCH, CODES, STEPS = (8, 8, 1), 4, 16, 3
# Adam's first steps divide each gradient entry by its own magnitude (g / (|g| + 1e-8)), so
# an entry whose gradient cancels to near 0 moves by its rounding: after 3 steps each
# package's float32 parameters lie up to 1.4e-4 (the port) and 7.9e-5 (the JAX package) of a
# leaf's largest entry, and 1.3e-5 and 7.3e-6 of the model's largest entry, from the port's
# float64 run on the same draws (the VAE; 1e-6 to 3e-6 on the other archs). So the steps are
# held to 2e-5 of the model's largest parameter entry (ROADMAP Queue C).
ADAM_STEPS = 2e-5


def _jax_start(arch, seed=0):
    """The JAX package's initial parameters, data and per-step draws (sel, eps) of
    ``train_encoder_decoder(SHAPE, steps=STEPS, batch_size=BATCH, seed=seed, arch=arch)``
    without a dataloader, drawn as it draws them."""
    key, init_key, emb_key, data_key = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = jax_aux.VAE(out_shape=SHAPE).init(init_key, jnp.zeros((1, *SHAPE)), init_key)["params"]
    if arch in ("VQ_VAE", "VQ_CVAE"):
        params = dict(params, codebook=jnp.fmod(0.02 * jax.random.normal(emb_key, (128, CODES)), 0.04))
    data = jax.random.normal(data_key, (256, *SHAPE)) * 0.5
    draws = []
    for _ in range(STEPS):
        key, sub, batch_key = jax.random.split(key, 3)
        draws.append((np.asarray(jax.random.randint(batch_key, (BATCH,), 0, 256)),
                      np.asarray(jax.random.normal(sub, (BATCH, 128)))))
    return params, data, draws


def _jax_loss(arch, params, batch, eps):
    """The JAX package's training loss (``aux_training.py`` ``train_encoder_decoder``'s
    ``loss_fn``), written out with its own modules and its own noise ``eps``."""
    model = jax_aux.VAE(out_shape=SHAPE)
    net = {"params": {k: v for k, v in params.items() if k != "codebook"}}
    if arch == "VAE":
        mu, logvar = model.apply(net, batch, method=lambda m, x: m.encoder(x))
        rec = model.apply(net, mu + jnp.exp(0.5 * logvar) * eps, method=lambda m, z: m.decoder(z))
        kl = -0.5 * jnp.mean(1 + logvar - jnp.square(mu) - jnp.exp(logvar))
        return jnp.mean(jnp.square(rec - batch)) + 1e-3 * kl
    z_e, _ = model.apply(net, batch, method=lambda m, x: m.encoder(x))
    if arch == "AE":
        return jnp.mean(jnp.square(model.apply(net, z_e, method=lambda m, z: m.decoder(z)) - batch))
    emb = params["codebook"]
    z_q = jax_aux.nearest_embed(z_e, jax.lax.stop_gradient(emb))
    emb_q = jax_aux.nearest_embed(jax.lax.stop_gradient(z_e), emb)
    rec = model.apply(net, z_q, method=lambda m, z: m.decoder(z))
    vq_coef, commit_coef = jax_aux._VQ_COEFS[arch]
    return (jnp.mean(jnp.square(rec - batch)) + vq_coef * jnp.mean(jnp.square(emb_q - jax.lax.stop_gradient(z_e)))
            + commit_coef * jnp.mean(jnp.square(jax.lax.stop_gradient(emb_q) - z_e)))


@pytest.mark.parametrize("arch", aux.ARCHS)
def test_loss_and_gradient_match_jax_on_its_draws(arch):
    params, data, draws = _jax_start(arch)
    sel, eps = draws[0]
    model = _vae(SHAPE, arch, params)
    loss = aux.encoder_decoder_loss(model, _nchw(data)[sel], torch.as_tensor(eps))
    loss.backward()
    j_loss, j_grads = jax.value_and_grad(lambda p: _jax_loss(arch, p, data[sel], jnp.asarray(eps)))(params)
    _close(loss, j_loss, 1e-5)
    _close_tree(model, j_grads, 1e-5, grads=True)


@pytest.mark.parametrize("arch", aux.ARCHS)
def test_first_adam_steps_match_jax_on_its_draws(arch):
    """Three Adam steps of the port's trainer on the JAX package's initial parameters, data
    and draws against ``train_encoder_decoder(..., steps=3)`` of the JAX package; then
    ``decode`` on those parameters, from NHWC images and from latent rows."""
    params, data, draws = _jax_start(arch)
    j_decode, j_params = jax_aux.train_encoder_decoder(SHAPE, steps=STEPS, batch_size=BATCH, arch=arch,
                                                       num_embeddings=CODES)
    model = _vae(SHAPE, arch, params)
    trainer, images = aux.Trainer(model, 1e-3), _nchw(data)
    for sel, eps in draws:
        trainer.train_step(lambda: aux.encoder_decoder_loss(model, images[sel], torch.as_tensor(eps)))
    _close_tree(model, j_params, ADAM_STEPS, of_tree=True)
    x = np.asarray(data[:2])
    z = np.random.default_rng(4).standard_normal((2, 128)).astype(np.float32) * 0.02
    trained = _vae(SHAPE, arch, j_params)
    for arr in (x, z):
        _close(trained.decode(arr), j_decode(jnp.asarray(arr)), 1e-5)


def test_first_adam_steps_of_the_feature_decoder_match_jax_on_its_draws():
    """``train_feature_decoder`` of both packages on the same prefix (a fixed 2x2 average
    pool to (4, 4, 3)) and data: the JAX package's first 3 steps against the port's
    trainer on the JAX package's initial parameters and batch draws."""
    data = np.random.default_rng(5).standard_normal((256, 8, 8, 3)).astype(np.float32)
    batches = [dict(inputs=data[i:i + 64]) for i in range(0, 256, 64)]

    def j_prefix(x):
        return x.reshape(x.shape[0], 4, 2, 4, 2, 3).mean(axis=(2, 4))

    key = jax.random.PRNGKey(0)
    feats = np.asarray(j_prefix(jnp.asarray(data))).reshape(256, -1)
    j_module = jax_aux.FeatureDecoder(out_shape=(8, 8, 3), feature_shape=(4, 4, 3))
    params = j_module.init(key, jnp.asarray(feats[:1]))["params"]
    j_decode, j_params = jax_aux.train_feature_decoder(j_prefix, (8, 8, 3), (4, 4, 3), dataloader=batches, steps=3)
    decoder = aux.FeatureDecoder((8, 8, 3), (4, 4, 3))
    load_flat_state(decoder, _flat(params), strict=True)
    trainer, images, rows = aux.Trainer(decoder, 2e-3), _nchw(data), torch.as_tensor(feats)
    for _ in range(3):
        key, batch_key = jax.random.split(key)
        sel = np.asarray(jax.random.randint(batch_key, (16,), 0, 256))
        trainer.train_step(lambda: torch.mean((decoder(rows[sel]) - images[sel]).square()))
    _close_tree(decoder, j_params, ADAM_STEPS, of_tree=True)
    _close(decoder.decode(feats[:4]), j_decode(feats[:4]), 1e-5)

    # the port's own run of the same training: its prefix sees NCHW images, its features
    # are flattened in the NHWC order of the JAX package's
    def prefix(x):
        return torch.nn.functional.avg_pool2d(x, 2).permute(0, 2, 3, 1)

    port_batches = [dict(inputs=np.ascontiguousarray(b["inputs"].transpose(0, 3, 1, 2))) for b in batches]
    decode, trained = aux.train_feature_decoder(prefix, (8, 8, 3), (4, 4, 3), dataloader=port_batches, steps=20)
    assert decode(feats[:2]).shape == (2, 8, 8, 3) and trained.losses.shape == (20,)
    assert float(trained.losses[-5:].mean()) < float(trained.losses[:5].mean())


def test_generate_decoder_without_a_prefix_warns_and_decodes_rows(caplog):
    decode, decoder = aux.generate_decoder(32, (8, 8, 3))
    assert "untrained" in caplog.text
    j_decode, j_params = jax_aux.generate_decoder(32, (8, 8, 3))
    load_flat_state(decoder, _flat(j_params), strict=True)
    rows = np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)
    _close(decode(rows), j_decode(jnp.asarray(rows)), 1e-5)
