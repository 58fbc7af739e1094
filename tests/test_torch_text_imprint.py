"""The imprint blocks on text ("Robbing the Fed" and "Curious Abandon Honesty" after a
transformer's embedding) on the port against the JAX package, on the CPU, at the JAX
package's test size (tests/test_text_stack.py ``test_imprint_attack_on_text``:
transformer3, ``random-tokens``, vocab 512, 12 tokens, 48 bins), the victim's weights
carried across by the weight bridge:

- the imprinted model's parameters equal the JAX package's, the block's included, and
  the user's float32 gradient lies no farther from its float64 value than twice the JAX
  package's float32 gradient does (or 1e-5 of the largest entry): RtF's block multiplies
  by 1 / gain = 1000 on its way back, and puts both packages 1e-3 to 2e-3 of the
  largest entry from float64 in the block and the embedding;
- the readout on the JAX package's exchange gives its tokens exactly;
- each package on its own exchange: the same tokens and the same report, and the JAX
  test's threshold (positional accuracy above 0.9) on RtF.
"""

import copy
import types

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)
BASE = ["case=10_causal_lang_training", "attack=imprint", "case/data=random-tokens", "case.data.task=causal-lm",
        "case.model=transformer3", "case.data.shape=[12]", "case.data.vocab_size=512",
        "case.data.default_clients=40", "case.server.model_modification.num_bins=48"]
SERVERS = {
    "rtf": ["case/server=malicious-model-rtf", "case.user.num_data_points=1", "seed=4"],
    "cah": ["case/server=malicious-model-cah", "case.user.num_data_points=2", "seed=4",
            "case.server.model_modification.sigma=0.5", "case.server.model_modification.mu=0",
            "case.server.model_modification.scale_factor=0.999"],
}


def _flat(tree):
    return {"params/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(model, flat):
    """A flat JAX tree in the port's names and layouts of ``model``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(tensor)]: np.ascontiguousarray(transform(flat[key]) if transform else flat[key])
            for key, tensor, transform in _flat_entries(model)}


_built = {}


@pytest.fixture(params=sorted(SERVERS))
def case(request):
    name = request.param
    if name not in _built:
        overrides = BASE + SERVERS[name]
        j_cfg, cfg = jax_breaching.get_config(overrides), breaching.get_config(overrides)
        j_setup = jax_breaching.utils.system_startup(cfg=j_cfg)
        j_user, j_server, _, _ = jax_breaching.cases.construct_case(j_cfg.case, j_setup)
        setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
        model, loss = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
        load_flat_state(model, _flat(j_server.original_model.params), strict=True)
        server = breaching.cases.construct_server(model, loss, cfg.case, setup)
        model = server.vet_model(model)
        user = breaching.cases.construct_user(model, loss, cfg.case, setup)
        j_shared, j_payloads, j_true = j_server.run_protocol(j_user)
        shared, payloads, true = server.run_protocol(user)
        grads = _port(model, _flat(j_shared[0]["gradients"]))
        _built[name] = types.SimpleNamespace(
            cfg=cfg, j_cfg=j_cfg, setup=setup, j_setup=j_setup, server=server, j_server=j_server, model=model,
            shared=shared, payloads=payloads, true=true, j_shared=j_shared, j_payloads=j_payloads, j_true=j_true,
            jax_grads=grads,
            jax_exchange=[dict(shared[0], gradients={k: torch.tensor(v) for k, v in grads.items()})])
    return name, _built[name]


def _readouts(e, shared, j_shared):
    attacker = breaching.attacks.prepare_attack(e.server.model, e.server.loss, e.cfg.attack, e.setup)
    j_attacker = jax_breaching.attacks.prepare_attack(e.j_server.model, e.j_server.loss, e.j_cfg.attack, e.j_setup)
    rec, _ = attacker.reconstruct(e.payloads, shared, e.server.secrets)
    j_rec, _ = j_attacker.reconstruct(e.j_payloads, j_shared, e.j_server.secrets)
    return rec, j_rec


def test_imprinted_model_and_gradient_match_jax(case):
    name, e = case
    ours = {name: p.detach().numpy() for name, p in e.model.named_parameters()}
    theirs = _port(e.model, _flat(e.j_server.model.params))
    assert set(ours) == set(theirs) and any(k.startswith("imprint_block.linear0") for k in ours)
    for key, value in ours.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)
    secrets, j_secrets = e.server.secrets["ImprintBlock"], e.j_server.secrets["ImprintBlock"]
    assert secrets["weight_name"] == "imprint_block.linear0.weight" and j_secrets["weight_path"] == (
        "imprint_block", "linear0_kernel")
    assert secrets["shape"] == j_secrets["shape"] == (12, 96) and secrets["structure"] == j_secrets["structure"]
    model = copy.deepcopy(e.model).double()
    params = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
    data = e.true["data"]
    exact = torch.autograd.grad(e.server.loss(functional_call(model, params, (data,)), data), list(params.values()))
    for key, want in zip(params, exact):
        want = want.numpy()
        scale = max(np.abs(want).max(), 1e-30)
        ours = np.abs(e.shared[0]["gradients"][key].numpy() - want).max() / scale
        theirs = np.abs(e.jax_grads[key] - want).max() / scale
        assert ours <= max(2 * theirs, 1e-5), (key, ours, theirs)


def test_text_readout_on_the_jax_exchange_matches_jax(case):
    name, e = case
    rec, j_rec = _readouts(e, e.jax_exchange, [dict(d) for d in e.j_shared])
    assert rec["data"].dtype == torch.int64 and tuple(rec["data"].shape) == np.asarray(j_rec["data"]).shape
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))


def test_each_package_on_its_own_exchange(case):
    name, e = case
    rec, j_rec = _readouts(e, e.shared, e.j_shared)
    np.testing.assert_array_equal(e.true["data"].numpy(), np.asarray(e.j_true["data"]))
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
    metrics = breaching.analysis.report(rec, e.true, e.payloads, e.server.model, cfg_case=e.cfg.case, setup=e.setup)
    j_metrics = jax_breaching.analysis.report(j_rec, e.j_true, e.j_payloads, e.j_server.model,
                                              cfg_case=e.j_cfg.case, setup=e.j_setup)
    assert set(metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        if key == "feat_mse":
            np.testing.assert_allclose(metrics[key], value, rtol=1e-3)
        else:
            np.testing.assert_array_equal(np.asarray(metrics[key]), np.asarray(value), err_msg=key)
    if name == "rtf":
        assert metrics["accuracy"] > 0.9, metrics
