"""The port's Inverting-Gradients attack (fused cosine objective, TV, Adam, box clamp,
best-iterate tracking, scoring) and its report against the JAX package's, through
the normal entry points, on the same weights (through the bridge), data and
initial candidate, with ConvNet-8 on CIFAR-10 shapes.

Hard-signed Adam takes sign() of the gradient, so entries near zero can flip on a
last-bit difference and the two trajectories then drift apart. The comparison is
in three parts (float32 on both sides, convolutions summed in other orders; the
agreement measured on this configuration is in brackets):
- step 0: the loss and its gradient before any transform, 1e-5 of the loss and
  1e-4 of the largest gradient entry [8e-7 and 1e-7];
- 10 steps of unsigned Adam: every loss of the trajectory within 1e-4 relative
  [3e-6], the reconstruction within 1e-4 of its largest entry [1e-5], and its
  score, a cosine distance 1 - cos with cos close to 1, within 1e-5 absolute
  [5e-6; the cancellation leaves only absolute precision]. The report's MSE and
  PSNR agree to 1e-4 relative [7e-7], its SSIM, near 0 here, to 1e-5 absolute
  [2e-6];
- 5 steps of hard-signed Adam: losses within 1e-3 relative [2e-6], and at most 1%
  of the pixels of the reconstruction more than 1e-3 apart [none]."""

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching

torch.set_num_threads(1)
WIDTH = 8
SLICE = ["case=1_single_image_small", "attack=invertinggradients",
         "attack.objective.type=fused-cosine-similarity", f"case.model=ConvNet{WIDTH}", "seed=0"]


def _run_both(overrides):
    """Build both cases on the same weights and run the FL exchange on each."""
    cfg, jax_cfg = breaching.get_config(SLICE + overrides), jax_breaching.get_config(SLICE + overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    port = dict(cfg=cfg, setup=setup, server=server, loss_fn=loss_fn,
                attacker=breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup))
    ref = dict(cfg=jax_cfg, setup=jax_setup, server=j_server, loss_fn=j_loss,
               attacker=jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss,
                                                             jax_cfg.attack, jax_setup))
    port["shared"], port["payloads"], port["true"] = server.run_protocol(user)
    ref["shared"], ref["payloads"], ref["true"] = j_server.run_protocol(j_user)
    return port, ref


def _initial(seed=3):
    x = np.random.default_rng(seed).normal(size=(1, 3, 32, 32)).astype(np.float32)
    return x, np.transpose(x, (0, 2, 3, 1))


@pytest.mark.parametrize("public_buffers", [True, False])
def test_step_zero_loss_and_gradient_match(public_buffers):
    # without public buffers the attacker's model runs BatchNorm in train mode
    port, ref = _run_both([f"case.server.provide_public_buffers={public_buffers}"])
    x, x_nhwc = _initial()

    attacker = ref["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(ref["payloads"], ref["shared"])
    attacker.objective.initialize(ref["loss_fn"], rec_models[0], None, attacker.cfg.impl)
    loss = attacker._build_loss_fn(rec_models, attacker._shared_data_cache, labels,
                                   include_outer_regs=True)
    value, grad = jax.value_and_grad(lambda c: loss(dict(data=c), jax.random.PRNGKey(0))[0])(
        jax.numpy.asarray(x_nhwc))

    attacker = port["attacker"]
    rec_models, labels, _ = attacker.prepare_attack(port["payloads"], port["shared"])
    assert rec_models[0].bn_train is not public_buffers
    attacker.objective.initialize(port["loss_fn"], rec_models[0].module, None, attacker.cfg.impl)
    targets = [tuple(attacker._shared_data_cache[0]["gradients"][k] for k in rec_models[0].params)]
    xt = torch.from_numpy(x).requires_grad_(True)
    got, _ = attacker._loss(xt, rec_models, targets, labels)
    got_grad, = torch.autograd.grad(got, xt)

    assert abs(got.item() - float(value)) <= 1e-5 * abs(float(value))
    want = np.transpose(np.asarray(grad), (0, 3, 1, 2))
    np.testing.assert_allclose(got_grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_unsigned_adam_trajectory_and_report_match():
    overrides = ["attack.optim.signed=False", "attack.optim.max_iterations=10",
                 "attack.optim.callback=5"]
    port, ref = _run_both(overrides)
    x, x_nhwc = _initial()
    rec, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                              initial_data=torch.from_numpy(x))
    j_rec, j_stats = ref["attacker"].reconstruct(ref["payloads"], ref["shared"], ref["server"].secrets,
                                                 initial_data=x_nhwc)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == 10 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert abs(stats["opt_value"] - j_stats["opt_value"]) <= 1e-5
    j_data = np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))
    np.testing.assert_allclose(rec["data"].numpy(), j_data, rtol=0, atol=1e-4 * np.abs(j_data).max())
    np.testing.assert_array_equal(rec["labels"].numpy(), np.asarray(j_rec["labels"]))

    metrics = breaching.analysis.report(rec, port["true"], port["payloads"], port["server"].model,
                                        cfg_case=port["cfg"].case, setup=port["setup"])
    j_metrics = jax_breaching.analysis.report(j_rec, ref["true"], ref["payloads"], ref["server"].model,
                                              cfg_case=ref["cfg"].case, setup=ref["setup"])
    for key in ("mse", "psnr", "max_mse", "feat_mse"):
        assert metrics[key] == pytest.approx(j_metrics[key], rel=1e-4), key
    assert abs(metrics["ssim"] - j_metrics["ssim"]) <= 1e-5
    assert metrics["label_acc"] == j_metrics["label_acc"] == 1.0
    assert metrics["parameters"] == j_metrics["parameters"]


def test_signed_adam_trajectory_stays_close():
    overrides = ["attack.optim.max_iterations=5", "attack.optim.callback=5"]
    port, ref = _run_both(overrides)
    x, x_nhwc = _initial()
    rec, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                              initial_data=torch.from_numpy(x))
    j_rec, j_stats = ref["attacker"].reconstruct(ref["payloads"], ref["shared"], ref["server"].secrets,
                                                 initial_data=x_nhwc)
    np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-3)
    differing = np.abs(rec["data"].numpy() - np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"


@pytest.mark.parametrize("override", ["attack.optim.signed=soft", "attack.optim.grad_clip=1.0",
                                      "attack.optim.langevin_noise=0.1", "attack.normalize_gradients=True"])
def test_unported_options_are_refused(override):
    cfg = breaching.get_config(SLICE + [override])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    with pytest.raises(NotImplementedError):
        attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        shared, payloads, _ = server.run_protocol(user)
        attacker.reconstruct(payloads, shared, server.secrets)
