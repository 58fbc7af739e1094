"""The port's multiscale attack (``attack=multiscale_ghiasi``) against the JAX
package's, on the CPU: the pyramid of each scheme; the resize between stages and the
``focus`` embedding against ``jax.image.resize``; and a 3-stage linear pyramid at
24x24 (stages 8, 16 and 24) of 3 steps each through both packages' ``reconstruct``,
with the augmentation off and on.

The attack runs on a ResNet: its global pooling takes every stage's size (the
ConvNet's head is sized for one). Both packages build the CIFAR-stem ResNet-20 of
case 1 on the same weights (the JAX model's, through ``load_flat_state``). Every
initial candidate, the first stage's and the fresh one each ``focus`` stage embeds
the previous best into, is the JAX package's own draw at that size, given to both by
overriding each attacker's ``_initialize_data``. With the augmentation on
(``continuous_shift``, shift 224, circular, as the preset), both packages take the
same draws, one (1, 4) uniform draw per stage from a numpy seed: the JAX
``jax.random.uniform`` of ``RandomTransform`` and the port's ``sample`` return it.

Tolerances: the resize, and the focus embedding, 2e-6 absolute on images in [0, 1]
and 2e-6 of the largest entry on standard normal ones. Both packages round the
antialiasing filter's weights in float32, each 7.1e-6 from the float64 resize at
160 -> 96, and agree with each other to 1.2e-6 there [measured over 10 seeds; 1.2e-7
to 7.2e-7 at the other four pairs, 4.8e-7 upsampling; 3.3e-6 at 160 -> 96 on
standard normal images, largest entry 4.7]; the attack, as tests/test_torch_presets.py holds the presets: every loss
1e-3 relative, at most 1% of the pixels of the reconstruction 1e-3 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries import augmentations as jax_augs
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.augmentations import resize
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from breaching_tpu_torch.simulate_breach import main_process

torch.set_num_threads(1)
CASE = ["case=1_single_image_small", "case.model=resnet20", "case.data.shape=[3, 24, 24]",
        "attack=multiscale_ghiasi", "attack.num_stages=3", "attack.optim.max_iterations=3",
        "attack.optim.callback=1", "seed=0"]
PAIRS = ((64, 48), (96, 64), (128, 80), (160, 96), (192, 112))  # the 224 pyramid's focus resizes


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _both(overrides):
    cfg, jax_cfg = breaching.get_config(CASE + overrides), jax_breaching.get_config(CASE + overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    flat = {}
    for prefix, tree in (("params/", j_model.params), ("buffers/", j_model.buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    load_flat_state(model, flat, strict=True)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    shared, payloads, true = server.run_protocol(user)
    return dict(j_attacker=j_attacker, j_shared=j_shared, j_payloads=j_payloads, j_server=j_server,
                attacker=attacker, shared=shared, payloads=payloads, server=server, true=true, cfg=cfg,
                setup=setup)


@pytest.mark.parametrize("scheme,size,stages", [("linear", 224, 7), ("linear", 24, 3), ("linear", 32, 5),
                                                ("log", 224, 4), ("log", 24, 3), ("trivial", 24, 2)])
def test_scale_pyramid_matches_jax(scheme, size, stages):
    overrides = ["case=1_single_image_small", "case.model=ConvNet8", "attack=multiscale_ghiasi",
                 f"attack.scale_pyramid={scheme}", f"attack.num_stages={stages}"]
    j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    attacker = breaching.attacks.prepare_attack(None, None, cfg.attack, setup)
    j_attacker = jax_breaching.attacks.prepare_attack(None, None, j_cfg.attack,
                                                      jax_breaching.utils.system_startup(cfg=j_cfg))
    attacker.data_shape = j_attacker.data_shape = (3, size, size)
    assert attacker._scale_pyramid() == j_attacker._scale_pyramid()
    if (scheme, size) == ("linear", 224):
        assert attacker._scale_pyramid() == [32, 64, 96, 128, 160, 192, 224]


@pytest.mark.parametrize("pair", PAIRS + ((32, 64), (192, 224), (16, 16)))
@pytest.mark.parametrize("images", ["unit", "normal"])
def test_resize_matches_jax_image_resize(pair, images):
    size, out = pair
    rng = np.random.default_rng(size)
    x = (rng.uniform(size=(2, size, size, 3)) if images == "unit" else rng.normal(size=(2, size, size, 3)))
    x = x.astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, out, out, 3), "bilinear"))
    got = resize(torch.from_numpy(_nchw(x).copy()), (out, out)).numpy()
    atol = 2e-6 * (1.0 if images == "unit" else np.abs(x).max())
    np.testing.assert_allclose(got, _nchw(want), rtol=0, atol=atol)


@pytest.mark.parametrize("pair", PAIRS)
def test_focus_embedding_matches_jax(pair):
    """The previous stage's best at half the new size, centred in a fresh candidate, as
    ``breaching_tpu/attacks/multiscale_optimization_attack.py:59-65`` forms it."""
    previous_size, scale = pair[0], pair[0] + 32
    rng = np.random.default_rng(scale)
    prev = rng.uniform(size=(1, previous_size, previous_size, 3)).astype(np.float32)
    background = rng.normal(size=(1, scale, scale, 3)).astype(np.float32)
    p = scale // 2
    cx = (scale - p) // 2
    small = jax.image.resize(jnp.asarray(prev), (1, p, p, 3), "bilinear")
    want = jnp.asarray(background).at[:, cx:cx + p, cx:cx + p, :].set(small)

    cfg = breaching.get_config(["case=1_single_image_small", "attack=multiscale_ghiasi"])
    attacker = breaching.attacks.prepare_attack(None, None, cfg.attack,
                                                breaching.utils.system_startup(cfg=cfg, device="cpu"))
    attacker.data_shape = (3, scale, scale)
    attacker._initialize_data = lambda shape: torch.from_numpy(_nchw(background).copy())
    got = attacker._stage_init(torch.from_numpy(_nchw(prev).copy()), scale, 1)
    assert p == pair[1]
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0, atol=2e-6 * np.abs(background).max())


@pytest.mark.parametrize("augmented", [False, True])
def test_three_stages_match_jax(augmented, monkeypatch):
    e = _both([] if augmented else ["attack.augmentations=null"])
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    assert bool(attacker.augmentations) == augmented == bool(j_attacker.augmentations)
    # the JAX package's own initial candidate at every stage's size, for both
    j_attacker.prepare_attack(e["j_payloads"], e["j_shared"])
    backgrounds = {s: np.asarray(j_attacker._initialize_data((1, s, s, 3), jax.random.PRNGKey(s)))
                   for s in (8, 12, 16, 24)}
    j_attacker._initialize_data = lambda shape, key: jnp.asarray(backgrounds[shape[1]])
    attacker._initialize_data = lambda shape: torch.from_numpy(_nchw(backgrounds[shape[-1]]).copy()).expand(shape)
    if augmented:
        draws = {s: np.random.default_rng(s).uniform(size=(1, 4)).astype(np.float32) for s in (8, 16, 24)}
        stage, real_call, real_uniform = {}, jax_augs.RandomTransform.__call__, jax.random.uniform

        def call(self, x, key):
            stage["size"] = x.shape[1]
            return real_call(self, x, key)

        def uniform(key, shape=(), dtype=jnp.float32, *args, **kwargs):
            if tuple(shape) == (1, 4):
                return jnp.asarray(draws[stage["size"]], dtype)
            return real_uniform(key, shape, dtype, *args, **kwargs)

        monkeypatch.setattr(jax_augs.RandomTransform, "__call__", call)
        monkeypatch.setattr(jax.random, "uniform", uniform)
        attacker.augmentations[0].sample = lambda shape, generator: torch.from_numpy(draws[shape[-1]])

    j_rec, j_stats = j_attacker.reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    monkeypatch.undo()
    rec, stats = attacker.reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == 9 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert tuple(rec["data"].shape) == (1, 3, 24, 24)
    differing = np.abs(rec["data"].numpy() - _nchw(j_rec["data"])) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"
    metrics = breaching.analysis.report(rec, e["true"], e["payloads"], e["server"].model, cfg_case=e["cfg"].case,
                                        setup=e["setup"])
    assert np.isfinite(metrics["psnr"])


def test_multiscale_dry_run_through_the_entry_point(tmp_path):
    """``attack=multiscale_ghiasi`` through ``main_process``: a dry run stops after stage 0
    and resizes its result to the full shape."""
    cfg = breaching.get_config(["case=2_single_imagenet", "case.data.shape=[3, 32, 32]", "case.model=resnet18",
                                "attack=multiscale_ghiasi", "dryrun=True", "seed=7"])
    cfg.base_dir = str(tmp_path)  # the run's records stay out of the checkout
    metrics = main_process(cfg, device="cpu")
    assert np.isfinite(metrics["mse"]) and np.isfinite(metrics["psnr"])


def test_augmentations_are_refused_under_the_batched_trial_step():
    cfg = breaching.get_config(CASE + ["attack.restarts.num_trials=2"])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    with pytest.raises(NotImplementedError, match="Augmentations"):
        attacker.reconstruct(payloads, shared, server.secrets)
