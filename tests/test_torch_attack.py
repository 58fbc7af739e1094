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
  of the pixels of the reconstruction more than 1e-3 apart [none]; the same for a
  `dryrun=True` reconstruction and a 3-step one at 16x16, whose step sizes come from
  step-lr boundaries that coincide (max_iterations <= 3)."""

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


def _initial(seed=3, size=32):
    x = np.random.default_rng(seed).normal(size=(1, 3, size, size)).astype(np.float32)
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


@pytest.mark.parametrize("dryrun,iterations", [(True, 24_000), (False, 3)])
def test_short_signed_reconstructions_match(dryrun, iterations):
    # a dry run takes one step with max_iterations = 1: every step-lr boundary is 0
    overrides = ["case.data.shape=[3, 16, 16]", f"attack.optim.max_iterations={iterations}"]
    port, ref = _run_both(overrides)
    x, x_nhwc = _initial(size=16)
    rec, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets,
                                              initial_data=torch.from_numpy(x), dryrun=dryrun)
    j_rec, j_stats = ref["attacker"].reconstruct(ref["payloads"], ref["shared"], ref["server"].secrets,
                                                 initial_data=x_nhwc, dryrun=dryrun)
    assert len(stats["Trial_0_Val"]) == len(j_stats["Trial_0_Val"]) == (1 if dryrun else iterations)
    np.testing.assert_allclose(stats["Trial_0_Val"], j_stats["Trial_0_Val"], rtol=1e-3)
    differing = np.abs(rec["data"].numpy() - np.transpose(np.asarray(j_rec["data"]), (0, 3, 1, 2))) > 1e-3
    assert differing.mean() <= 0.01, f"{differing.mean():.4%} of the pixels differ"


@pytest.mark.parametrize("override,name", [
    ("attack.attack_type=permutation-optimization", "permutation-optimization"),
    ("attack.label_strategy=bias-text case.user.provide_labels=False", "bias-text")])
def test_unported_options_are_refused(override, name):
    cfg = breaching.get_config(SLICE + override.split())
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    with pytest.raises(NotImplementedError, match=name):
        attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        shared, payloads, _ = server.run_protocol(user)
        attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)


@pytest.mark.parametrize("modality", ["text", "audio"])
def test_unported_modality_is_refused(modality):
    """What the port has not ported of a data modality is refused by name, as the attack
    options above are: audio has no datasets. Text has, and its fedAVG user too, whose
    attack with restarts runs: its two trials one after the other through the single
    step (a text candidate has no batched step), each with its own loss."""
    if modality == "text":
        cfg = breaching.get_config(["case=10_causal_lang_training", "case/user=local_updates", "attack=tag",
                                    "attack.restarts.num_trials=2", "case.data.vocab_size=128",
                                    "case.data.shape=[8]"])
        setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
        user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
        shared, payloads, _ = server.run_protocol(user)
        assert shared[0]["metadata"]["data_key"] == "input_ids"
        assert shared[0]["metadata"]["local_hyperparams"] is not None
        attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
        rec, stats = attacker.reconstruct(payloads, shared, server.secrets, dryrun=True)
        losses = [stats[f"Trial_{t}_Val"] for t in range(2)]
        assert all(len(v) == 1 and np.isfinite(v).all() for v in losses) and losses[0] != losses[1]
        assert rec["data"].dtype == torch.int64 and rec["data"].shape[-1] == 8  # token ids of each sequence
        return
    cfg = breaching.get_config(SLICE)
    cfg.case.data.modality = modality
    with pytest.raises(NotImplementedError, match=modality):
        breaching.cases.construct_dataloader(cfg.case.data, cfg.case.impl)


@pytest.mark.parametrize("optimizer,trials", [("adam", 1), ("adam", 2), ("L-BFGS", 1)])
def test_an_interrupt_returns_the_best_iterate_so_far(optimizer, trials, monkeypatch):
    """Ctrl-C at the start of step k (here k = 3, inside the second readout chunk of 2
    steps): ``stats["interrupted_at"] == k``, every trial's history holds its k losses,
    and each trial's best iterate is its candidate at the step of its lowest loss, as
    the JAX package returns the best so far. Adam runs one trial through the single
    step and two through the batched trial step; L-BFGS is interrupted at the first
    evaluation of its outer step k."""
    k = 3
    cfg = breaching.get_config(SLICE + ["case.data.shape=[3, 16, 16]", f"attack.optim.optimizer={optimizer}",
                                        "attack.optim.max_iterations=8", "attack.optim.callback=2",
                                        f"attack.restarts.num_trials={trials}"])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    starts, scored = [], {}  # each step's candidate (trials stacked), the best iterates scored

    def interrupt_at_k(candidate):
        if len(starts) == k:
            raise KeyboardInterrupt
        starts.append(candidate.detach().clone().reshape(trials, *candidate.shape[-4:]))

    if trials > 1:
        real_losses = attacker._trial_losses

        def trial_losses(candidates, *args):
            interrupt_at_k(candidates)
            return real_losses(candidates, *args)
        monkeypatch.setattr(attacker, "_trial_losses", trial_losses)
    else:
        real, step_tree = attacker._value_and_grad, []

        def value_and_grad(tree, *args):
            step_tree[:] = step_tree or [tree]  # a step passes its own tree, L-BFGS's closure new ones
            if tree is step_tree[0]:
                interrupt_at_k(tree["data"])
            return real(tree, *args)
        monkeypatch.setattr(attacker, "_value_and_grad", value_and_grad)
    real_score = attacker._score_all_trials

    def score(best, *args):
        scored.update({key: value.clone() for key, value in best.items()})
        return real_score(best, *args)
    monkeypatch.setattr(attacker, "_score_all_trials", score)

    rec, stats = attacker.reconstruct(payloads, shared, server.secrets)
    assert stats["interrupted_at"] == k and len(starts) == k
    for t in range(trials):
        losses = stats[f"Trial_{t}_Val"]
        assert len(losses) == k and np.isfinite(losses).all()
        assert torch.equal(scored["data"][t], starts[int(np.argmin(losses))][t])
    assert torch.isfinite(rec["data"]).all()


@pytest.mark.parametrize("override", ["attack.optim.signed=soft", "attack.optim.grad_clip=1.0",
                                      "attack.optim.langevin_noise=0.1", "attack.normalize_gradients=True"])
def test_gradient_transforms_and_normalized_gradients_run(override):
    """The options refused until the optimization family was ported: a 3-step attack
    through the entry points ends with a finite reconstruction (they are held to the
    JAX package in tests/test_torch_optim.py and tests/test_torch_presets.py)."""
    port, _ = _run_both([override, "case.data.shape=[3, 16, 16]", "attack.optim.max_iterations=3"])
    rec, stats = port["attacker"].reconstruct(port["payloads"], port["shared"], port["server"].secrets)
    assert len(stats["Trial_0_Val"]) == 3 and np.isfinite(stats["Trial_0_Val"]).all()
    assert torch.isfinite(rec["data"]).all()
