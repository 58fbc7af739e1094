"""The simulated FL exchange of the port against the JAX package's: the same case,
the same weights through the bridge, the same user data; the shared gradients,
labels and (in train mode) BatchNorm statistics agree.

Tolerance: both sides compute float32 convolution gradients on the CPU in
different summation orders; entries agree to 2e-5 of the largest gradient entry
(the same bound as tests/test_torch_models.py).
"""

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.vision_nets import ConvNet

torch.set_num_threads(1)


def _cases(overrides):
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    jax_case = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    case = breaching.cases.construct_case(cfg.case, setup)
    case[1].model.from_jax_state(jax.tree_util.tree_map(np.array, jax_case[2].params),
                                 jax.tree_util.tree_map(np.array, jax_case[2].buffers))
    return case, jax_case


@pytest.mark.parametrize("public_buffers", [True, False])
def test_shared_gradients_match(public_buffers):
    width = 8
    (user, server, _, _), (j_user, j_server, j_model, _) = _cases(
        ["case=1_single_image_small", f"case.model=ConvNet{width}", "seed=0",
         f"case.server.provide_public_buffers={public_buffers}"])
    shared, _, true_data = server.run_protocol(user)
    j_shared, _, j_true = j_server.run_protocol(j_user)

    np.testing.assert_array_equal(true_data["data"].numpy(),
                                  np.transpose(np.asarray(j_true["data"]), (0, 3, 1, 2)))
    np.testing.assert_array_equal(shared[0]["metadata"]["labels"].numpy(),
                                  np.asarray(j_shared[0]["metadata"]["labels"]))
    j_buffers = jax.tree_util.tree_map(np.array, j_model.buffers)
    want = {k: v.detach() for k, v in ConvNet(width).from_jax_state(
        jax.tree_util.tree_map(np.array, j_shared[0]["gradients"]), j_buffers).named_parameters()}
    assert list(shared[0]["gradients"]) == list(want)
    scale = max(v.abs().max().item() for v in want.values())
    for name, grad in shared[0]["gradients"].items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), rtol=0, atol=2e-5 * scale)

    if public_buffers:  # eval mode: nothing of the user's batch statistics is shared
        assert true_data["buffers"] is None and j_true["buffers"] is None
    else:  # train mode: the user's running statistics are its batch statistics
        for i in range(8):
            for key, j_key in (("running_mean", "mean"), ("running_var", "var")):
                got = true_data["buffers"][f"bn{i}.{key}"].numpy()
                expected = np.asarray(j_true["buffers"][f"bn{i}"][j_key])
                np.testing.assert_allclose(got, expected, rtol=0, atol=2e-5 * np.abs(expected).max())
        # the payload the server sent is not changed by the user's train-mode pass
        assert all(float(b) == 0 for k, b in server.model.state_dict().items()
                   if k.endswith("num_batches_tracked"))


def test_noise_and_clipping_are_refused():
    cfg = breaching.get_config(["case=1_single_image_small", "case.model=ConvNet4",
                                "case.user.local_diff_privacy.gradient_noise=0.1"])
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        breaching.cases.construct_case(cfg.case, setup)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = breaching.get_config(["case=1_single_image_small"])
    with pytest.raises(RuntimeError):
        breaching.utils.system_startup(cfg=cfg)
