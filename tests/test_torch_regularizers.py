"""The port's regularizers against the JAX package's, on the CPU: ``norm``,
``orthogonality``, ``deep_inversion`` and ``features``, and the whole attack loss of
the ``legacy`` preset (cosine matching, double-opponent TV, feature regularization,
DeepInversion) with its gradient.

``norm`` and ``orthogonality`` take a batch of 4 images of 3x8x8 from numpy seed 0
(NCHW in the port, NHWC in the JAX package). ``deep_inversion`` and ``features``
read what the objective's forward captured: both packages build the same case on
the same weights and run the same FL exchange, ConvNet-8 on CIFAR-10 shapes cut to
16x16 (case 1) and ResNet-18 on the repo's checkpoint at 64x64 (case 2), and the
regularizer takes the intermediates of the cosine objective's forward at the same
candidate (numpy seed 3). BatchNorm runs in eval mode on the server's buffers
(``DeepInversion`` is exactly 0 there in both packages: the JAX BatchNorm sows its
batch statistics only in train mode), or in train mode where the server shares no
buffers. The JAX side runs op by op.

Tolerances (float32 on both sides, sums in other orders): values 1e-5 relative;
gradients with respect to the candidate 1e-4 of their largest entry, as
tests/test_torch_attack.py holds the attack gradient. The legacy preset's whole loss
on ResNet-18 passes a double backward through the trained checkpoint, where the JAX
package's float32 evaluation on the CPU is the less exact side: its cosine term's
gradient is 1.8e-4 (eval mode) and 1.24e-3 (train mode) of the largest entry from a
float64 evaluation, the port's 4.4e-7 and 7.0e-6. So it is held, as
tests/test_torch_resnets.py holds the attack gradient, against the port's own
float64 evaluation (value 1e-6 relative; gradient 1e-5 of its largest entry, 1e-4 in
train mode, where BatchNorm divides by the spread of as few as 4 values per channel,
the 2x2 maps of the last stage at 64x64) and against the JAX package's (value 1e-4
relative; gradient 1e-3 of its largest entry, 3e-3 in train mode, above the JAX
package's own 1.24e-3 there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.attacks.auxiliaries.objectives import CosineSimilarity as JaxCosine
from breaching_tpu.attacks.auxiliaries.regularizers import regularizer_lookup as jax_regularizer_lookup
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries.objectives import CosineSimilarity
from breaching_tpu_torch.attacks.auxiliaries.regularizers import regularizer_lookup

torch.set_num_threads(1)
CASES = {
    "convnet": ["case=1_single_image_small", "case.model=ConvNet8", "case.data.shape=[3, 16, 16]", "seed=0"],
    "resnet18": ["case=2_single_imagenet", "case.data.shape=[3, 64, 64]", "case.user.provide_labels=True",
                 "seed=7"],
}
TRAIN_MODE = ["case.server.provide_public_buffers=False", "case.user.provide_buffers=False"]


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def _assert_close(got, got_grad, want, want_grad):
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (float(got), float(want))
    want_grad = _nchw(want_grad)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=1e-4 * np.abs(want_grad).max())


@pytest.mark.parametrize("name,options", [("norm", dict(pnorm=1.0)), ("norm", dict(pnorm=2.0)),
                                          ("norm", dict(pnorm=3.0)), ("orthogonality", {})])
def test_candidate_regularizers_match_jax(name, options):
    x = np.random.default_rng(0).normal(size=(4, 3, 8, 8)).astype(np.float32)
    j_reg = jax_regularizer_lookup[name](None, scale=0.3, **options)
    want, want_grad = jax.value_and_grad(lambda c: j_reg(c))(_nhwc(x))
    reg = regularizer_lookup[name](None, scale=0.3, **options)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = reg(xt)
    got_grad, = torch.autograd.grad(got, xt)
    _assert_close(got.item(), got_grad.numpy(), want, want_grad)
    if name == "orthogonality":  # one image has no pair
        assert float(reg(xt[:1])) == float(j_reg(_nhwc(x[:1]))) == 0.0


def _exchange(case, train_mode):
    overrides = CASES[case] + ["attack=legacy"] + (TRAIN_MODE if train_mode else [])
    cfg, jax_cfg = breaching.get_config(overrides), jax_breaching.get_config(overrides)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    from breaching_tpu_torch.cases.models.model_preparation import load_flat_state

    flat = {}
    for prefix, tree in (("params/", j_model.params), ("buffers/", j_model.buffers)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)
    load_flat_state(model, flat, strict=True)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    shared, payloads, _ = server.run_protocol(user)
    j_models, j_labels, _ = j_attacker.prepare_attack(j_payloads, j_shared)
    models, labels, _ = attacker.prepare_attack(payloads, shared)
    assert models[0].bn_train is train_mode and j_models[0].bn_train is train_mode
    shape = (1, *cfg.case.data.shape)
    return dict(j_attacker=j_attacker, j_models=j_models, j_labels=j_labels, j_loss=j_loss,
                j_shared=j_attacker._shared_data_cache, attacker=attacker, models=models, labels=labels,
                loss=loss_fn, shared=attacker._shared_data_cache, impl=cfg.attack.impl,
                x=np.random.default_rng(3).normal(size=shape).astype(np.float32))


@pytest.fixture(scope="module", params=[("convnet", False), ("convnet", True), ("resnet18", False),
                                        ("resnet18", True)], ids=lambda p: f"{p[0]}-{'train' if p[1] else 'eval'}")
def exchange(request):
    return _exchange(*request.param)


def _captured_value_and_grad(e, name, options):
    """The regularizer on the intermediates of the cosine objective's forward, in both
    packages: ((value, gradient) of the JAX package, (value, gradient) of the port)."""
    j_reg = jax_regularizer_lookup[name](None, **options)
    j_reg.initialize(e["j_models"], e["j_shared"], e["j_labels"])
    j_objective = JaxCosine()
    j_objective.initialize(e["j_loss"], e["j_models"][0], None, e["impl"])
    m = e["j_models"][0]

    def j_value(candidate):
        _, _, inter = j_objective(m.params, m.buffers, e["j_shared"][0]["gradients"], candidate, e["j_labels"],
                                  bn_train=m.bn_train, capture=True)
        return j_reg(candidate, [inter])

    want = jax.value_and_grad(j_value)(_nhwc(e["x"]))

    reg = regularizer_lookup[name](None, **options)
    reg.initialize(e["models"], e["shared"], e["labels"])
    objective = CosineSimilarity()
    objective.initialize(e["loss"], e["models"][0].module, None, e["impl"])
    model = e["models"][0]
    x = torch.from_numpy(e["x"]).requires_grad_(True)
    captured = {}
    objective(model.params, model.buffers, tuple(e["shared"][0]["gradients"][k] for k in model.params), x,
              e["labels"], bn_train=model.bn_train, capture=captured)
    got = reg(x, [captured])
    grad = torch.autograd.grad(got, x)[0].numpy() if got.requires_grad else np.zeros_like(e["x"])
    return want, (got.item(), grad)


def test_deep_inversion_matches_jax(exchange):
    (want, want_grad), (got, got_grad) = _captured_value_and_grad(
        exchange, "deep_inversion", dict(scale=5e-5, first_bn_multiplier=10))
    if not exchange["models"][0].bn_train:  # no batch statistics in eval mode: exactly 0 in both
        assert got == float(want) == 0.0
        assert not got_grad.any() and not np.asarray(want_grad).any()
        return
    assert got > 0
    _assert_close(got, got_grad, want, want_grad)


def test_feature_regularization_matches_jax(exchange):
    (want, want_grad), (got, got_grad) = _captured_value_and_grad(exchange, "features", dict(scale=0.1))
    assert got > 0
    _assert_close(got, got_grad, want, want_grad)


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_legacy_attack_loss_and_gradient_match_jax(train_mode):
    """The whole loss of the legacy preset on ResNet-18 at 64x64: cosine matching,
    double-opponent TV (p=2, q=0.5), feature regularization and DeepInversion."""
    e = _exchange("resnet18", train_mode)
    attacker, j_attacker = e["attacker"], e["j_attacker"]
    assert [type(r).__name__ for r in attacker.regularizers] == \
        [type(r).__name__ for r in j_attacker.regularizers] == ["TotalVariation", "FeatureRegularization",
                                                                "DeepInversion"]
    j_attacker.objective.initialize(e["j_loss"], e["j_models"][0], None, e["impl"])
    for reg in j_attacker.regularizers:
        reg.initialize(e["j_models"], e["j_shared"], e["j_labels"])
    loss = j_attacker._build_loss_fn(e["j_models"], e["j_shared"], e["j_labels"], include_outer_regs=True)
    want, want_grad = jax.value_and_grad(lambda c: loss(dict(data=c), jax.random.PRNGKey(0))[0])(_nhwc(e["x"]))

    def port_loss(dtype):
        models = [dataclasses.replace(m, params={k: v.detach().to(dtype).requires_grad_(True)
                                                 for k, v in m.params.items()},
                                      buffers={k: v.to(dtype) for k, v in m.buffers.items()}) for m in e["models"]]
        shared = [dict(d, gradients={k: g.to(dtype) for k, g in d["gradients"].items()}) for d in e["shared"]]
        attacker.objective.initialize(e["loss"], models[0].module, None, e["impl"])
        for reg in attacker.regularizers:
            reg.initialize(models, shared, e["labels"])
        targets = [tuple(shared[0]["gradients"][k] for k in models[0].params)]
        x = torch.from_numpy(e["x"]).to(dtype).requires_grad_(True)
        value, _ = attacker._loss(x, models, targets, e["labels"])
        return value.item(), torch.autograd.grad(value, x)[0].numpy()

    exact, exact_grad = port_loss(torch.float64)
    got, got_grad = port_loss(torch.float32)
    assert abs(got - exact) <= 1e-6 * abs(exact)
    rel = 1e-4 if train_mode else 1e-5
    np.testing.assert_allclose(got_grad, exact_grad, rtol=0, atol=rel * np.abs(exact_grad).max())
    want_grad = _nchw(want_grad)
    assert abs(got - float(want)) <= 1e-4 * abs(float(want))
    rel = 3e-3 if train_mode else 1e-3
    np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=rel * np.abs(want_grad).max())
