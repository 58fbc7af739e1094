"""Local differential privacy in the port's users against the JAX package's, ConvNet-8,
4 images, the same weights through the bridge:

- the fedSGD user with input noise, per-example clipping and gradient noise, in eval
  and in train mode, and the fedAVG user with each step's batch gradient clipped and
  its own gradient noise, both fed the JAX package's own draws (``jax.random`` from the
  key the JAX user splits off the setup). The shared update agrees to 1e-5 of its
  largest entry: float32 gradients summed in other orders on both sides (the
  unclipped gradient agrees to 2e-5, tests/test_torch_users.py, measured here [3e-7]);
  the shared BatchNorm statistics of the full batch to 2e-5 of their largest;
- every per-example gradient the port clips has a norm of at most C (1 + 1e-6);
- the port's own draws: mean 0 and variance sigma^2 (gaussian) or 2 sigma^2 (laplacian)
  over about 15,000 gradient entries of noise at sigma = 0.1, each within 5 standard
  errors of the estimate.
"""

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases import users
from breaching_tpu_torch.cases.models.vision_nets import ConvNet

torch.set_num_threads(1)
WIDTH = 8
LDP = "case.user.local_diff_privacy"
FEDSGD = ["case=1_single_image_small", f"case.model=ConvNet{WIDTH}", "case.user.num_data_points=4",
          "case.data.partition=random", "seed=2"]
FEDAVG = ["case=4_fedavg_small_scale", "case/data=CIFAR10", f"case.model=ConvNet{WIDTH}",
          "case.server.pretrained=False", "case.user.num_data_points=4", "case.user.num_local_updates=3",
          "case.user.num_data_per_local_update_step=2", "seed=2"]


def _cases(overrides):
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    jax_case = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    case = breaching.cases.construct_case(cfg.case, setup)
    case[1].model.from_jax_state(jax.tree_util.tree_map(np.array, jax_case[2].params),
                                 jax.tree_util.tree_map(np.array, jax_case[2].buffers))
    return case, jax_case, jax_setup


def _jax_noise(key, tree, distribution):
    """The JAX package's ``_tree_add_noise`` draws for ``tree``'s leaves."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    draw = jax.random.normal if distribution == "gaussian" else jax.random.laplace
    keys = jax.random.split(key, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [draw(k, np.shape(x), np.float32) for k, x in zip(keys, leaves)])


def _as_port(params, buffers):
    return {k: v.detach() for k, v in ConvNet(WIDTH).from_jax_state(
        jax.tree_util.tree_map(np.array, params), jax.tree_util.tree_map(np.array, buffers)).named_parameters()}


def _feed(monkeypatch, draws):
    """Replace ``users.sample_noise`` by the given list of draws, one per call, checking
    the shapes asked for."""
    queue = list(draws)

    def fake(shapes, generator, distribution):
        got = queue.pop(0)
        assert [tuple(s) for s in shapes] == [tuple(d.shape) for d in got]
        return got
    monkeypatch.setattr(users, "sample_noise", fake)
    return queue


def _assert_close(got, want, tol):
    scale = max(v.abs().max().item() for v in want.values())
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("public_buffers,distribution", [(True, "laplacian"), (False, "gaussian")])
def test_fedsgd_user_with_noise_and_clipping_matches_jax(public_buffers, distribution, monkeypatch):
    overrides = FEDSGD + [f"case.server.provide_public_buffers={public_buffers}", f"{LDP}.distribution={distribution}",
                          f"{LDP}.gradient_noise=0.01", f"{LDP}.input_noise=0.05", f"{LDP}.per_example_clipping=0.5"]
    (user, server, _, _), (j_user, j_server, j_model, _), j_setup = _cases(overrides)
    # the JAX user's key: the first split of the setup's key after construction
    key = jax.random.split(j_setup["key"], 2)[1]
    key_in, key_grad = jax.random.split(key)
    j_shared, _, j_true = j_server.run_protocol(j_user)
    inputs = np.asarray(j_true["data"])
    input_noise = np.asarray(_jax_noise(key_in, [inputs], distribution)[0])
    grad_noise = _as_port(_jax_noise(key_grad, j_model.params, distribution), j_model.buffers)
    queue = _feed(monkeypatch, [[torch.from_numpy(np.transpose(input_noise, (0, 3, 1, 2)).copy())],
                                list(grad_noise.values())])
    shared, _, true_data = server.run_protocol(user)
    assert not queue
    want = _as_port(j_shared[0]["gradients"], j_model.buffers)
    _assert_close(shared[0]["gradients"], want, 1e-5)
    if not public_buffers:  # train mode: the full noisy batch's statistics
        for i in range(8):
            got = true_data["buffers"][f"bn{i}.running_var"].numpy()
            expected = np.asarray(j_true["buffers"][f"bn{i}"]["var"])
            np.testing.assert_allclose(got, expected, rtol=0, atol=2e-5 * np.abs(expected).max())
    # the true data is the clean input
    np.testing.assert_array_equal(true_data["data"].numpy(), np.transpose(inputs, (0, 3, 1, 2)))
    # every example's clipped gradient lies within the clip
    payload = server.distribute_payload(0)
    bn_train, buffers = user._local_buffers(payload["buffers"])
    inputs_t, labels = user._user_tensors(None)
    _, norms = user.clipped_gradient(payload["parameters"], buffers, inputs_t, labels, bn_train)
    assert norms.shape == (4,) and bool((norms <= 0.5 * (1 + 1e-6)).all())


def test_fedavg_user_with_clipping_and_noise_per_step_matches_jax(monkeypatch):
    overrides = FEDAVG + [f"{LDP}.gradient_noise=0.001", f"{LDP}.per_example_clipping=0.5"]
    (user, server, _, _), (j_user, j_server, j_model, _), j_setup = _cases(overrides)
    keys = jax.random.split(jax.random.split(j_setup["key"], 2)[1], 3)
    draws = [list(_as_port(_jax_noise(k, j_model.params, "laplacian"), j_model.buffers).values()) for k in keys]
    queue = _feed(monkeypatch, draws)
    j_shared, _, _ = j_server.run_protocol(j_user)
    shared, _, _ = server.run_protocol(user)
    assert not queue
    _assert_close(shared[0]["gradients"], _as_port(j_shared[0]["gradients"], j_model.buffers), 1e-5)


@pytest.mark.parametrize("distribution,variance", [("gaussian", 1.0), ("laplacian", 2.0)])
def test_own_draws_have_the_distributions_statistics(distribution, variance):
    sigma = 0.1
    updates = []
    for noise in (0.0, sigma):
        cfg = breaching.get_config(FEDSGD + [f"{LDP}.gradient_noise={noise}", f"{LDP}.distribution={distribution}"])
        setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
        user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
        shared, _, _ = server.run_protocol(user)
        updates.append(torch.cat([g.reshape(-1) for g in shared[0]["gradients"].values()]).double())
    draws = (updates[1] - updates[0]) / sigma
    n = draws.numel()
    assert n > 15_000
    # standard errors: of the mean sqrt(var / n); of the variance sqrt((kurtosis - 1) / n) var,
    # kurtosis 3 (gaussian) or 6 (laplacian)
    kurtosis = 3.0 if distribution == "gaussian" else 6.0
    assert abs(draws.mean().item()) <= 5 * np.sqrt(variance / n)
    assert abs(draws.var().item() - variance) <= 5 * np.sqrt((kurtosis - 1) / n) * variance
