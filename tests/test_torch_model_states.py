"""The honest server's model states of the port against the JAX package's, ConvNet-8 on
CIFAR-10 shapes, the same weights in both through the bridge:

- ``linearized``: BatchNorm scale := running variance, bias := running mean + 10, and
  every biased convolution's bias + 10 on each payload, so that the convolution biases
  gain 10 per query (ROADMAP Queue C). Both add and copy float32 values: the payloads
  of two queries are held to the JAX package's bit for bit, on random running
  statistics;
- ``orthogonal``: each kernel, flattened to (-1, out) in the JAX package's layout (HWIO
  for a convolution, (in, out) for the dense head), has orthonormal columns where it
  has at least as many rows as columns and orthonormal rows otherwise, in both
  packages (to 1e-5: the port draws in float64, the JAX package in float32, to 1e-4);
- ``untrained``: a fresh initialization per query (the port's own draws), the same for
  the same seed, with the BatchNorm statistics reset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.layers import BatchNorm
from breaching_tpu_torch.cases.models.vision_nets import ConvNet

torch.set_num_threads(1)
WIDTH = 8
CASE = ["case=1_single_image_small", f"case.model=ConvNet{WIDTH}", "seed=4"]


def _servers(state, random_statistics=False):
    """The port's server and the JAX package's on one set of weights (and, with
    ``random_statistics``, one set of random BatchNorm statistics)."""
    overrides = CASE + [f"case.server.model_state={state}"]
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    _, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    if random_statistics:
        rng = np.random.default_rng(0)
        j_model.buffers = jax.tree_util.tree_map(
            lambda b: jnp.asarray(rng.uniform(0.5, 2.0, np.shape(b)).astype(np.float32)), j_model.buffers)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    _, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    return server, j_server


def _as_port(params, buffers):
    """The JAX package's parameters in the port's names and layouts."""
    return {k: v.detach() for k, v in ConvNet(WIDTH).from_jax_state(
        jax.tree_util.tree_map(np.array, params), jax.tree_util.tree_map(np.array, buffers)).named_parameters()}


def test_linearized_payloads_match_the_jax_package_exactly():
    server, j_server = _servers("linearized", random_statistics=True)
    before = {k: v.detach().clone() for k, v in server.model.named_parameters()}
    for query in (0, 1):
        payload, j_payload = server.distribute_payload(query), j_server.distribute_payload(query)
        want = _as_port(j_payload["parameters"], j_server.model.buffers)
        assert list(payload["parameters"]) == list(want)
        for name, value in payload["parameters"].items():
            assert torch.equal(value, want[name]), f"query {query}: {name}"
    bn = server.model.bn0
    assert torch.equal(payload["parameters"]["bn0.weight"], bn.running_var)
    assert torch.equal(payload["parameters"]["bn0.bias"], bn.running_mean + 10.0)
    # two queries: the convolution biases gained 20, the dense head kept its bias
    assert torch.equal(payload["parameters"]["conv3.bias"], before["conv3.bias"] + 10.0 + 10.0)
    assert torch.equal(payload["parameters"]["head.bias"], before["head.bias"])


def _orthonormal_axis(flat, tol):
    """'columns' or 'rows', whichever of the flat kernel's is orthonormal to ``tol``
    (the shorter side), or None."""
    rows, cols = flat.shape
    gram = flat.T @ flat if rows >= cols else flat @ flat.T
    if np.abs(gram - np.eye(gram.shape[0])).max() <= tol:
        return "columns" if rows >= cols else "rows"
    return None


def test_orthogonal_kernels_lie_on_the_jax_package_axes():
    server, j_server = _servers("orthogonal")
    payload, j_payload = server.distribute_payload(0), j_server.distribute_payload(0)
    j_params = j_payload["parameters"]
    kernels = 0
    for name, value in payload["parameters"].items():
        if not name.endswith(".weight") or name.startswith("bn"):
            continue
        module = name[:-len(".weight")]
        if value.dim() == 4:  # OIHW -> HWIO, then (-1, out)
            flat = value.permute(2, 3, 1, 0).reshape(-1, value.shape[0]).double().numpy()
            j_kernel = np.asarray(j_params[module]["conv"]["kernel"], np.float64)
        else:  # (out, in) -> (in, out)
            flat = value.T.double().numpy()
            j_kernel = np.asarray(j_params[module]["dense"]["kernel"], np.float64)
        j_flat = j_kernel.reshape(-1, j_kernel.shape[-1])
        assert flat.shape == j_flat.shape
        axis = _orthonormal_axis(flat, 1e-5)
        assert axis is not None and axis == _orthonormal_axis(j_flat, 1e-4), name
        kernels += 1
    assert kernels == 9  # eight convolutions and the head
    assert all(torch.equal(m.running_var, torch.ones_like(m.running_var))
               for m in server.model.modules() if isinstance(m, BatchNorm))


@pytest.mark.parametrize("state", ["untrained", "orthogonal"])
def test_reinitialization_differs_per_query_and_repeats_per_seed(state):
    server, _ = _servers(state)
    trained = {k: v.detach().clone() for k, v in server.model.named_parameters()}
    first, second = server.distribute_payload(0)["parameters"], server.distribute_payload(1)["parameters"]
    again, _ = _servers(state)
    repeated = again.distribute_payload(0)["parameters"]
    for name in ("conv0.weight", "conv5.bias", "head.weight"):
        assert not torch.equal(first[name], trained[name])
        assert not torch.equal(first[name], second[name])
        assert torch.equal(first[name], repeated[name])
    assert torch.equal(first["bn2.weight"], torch.ones_like(first["bn2.weight"]))
    if state == "untrained":  # the init's U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for name in ("conv0.weight", "conv7.weight"):
            assert first[name].abs().max() <= 1 / np.sqrt(first[name][0].numel())
