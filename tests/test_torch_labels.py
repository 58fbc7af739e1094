"""The label strategies ported with slice 6 against the JAX package's, ConvNet-8 on
CIFAR-10 shapes (10 classes), 4 images, the same weights through the bridge:

- ``wainakh-whitebox`` on the JAX package's own fake data (``jax.random.normal`` of
  ``fold_in(key, c)`` in NHWC, transposed, fed through the port's ``_fake_data``): the
  offsets s to 1e-5 of the largest (float32 head gradients of 9 fake images summed in
  other orders), the impact m, a sum that is 0 but for rounding, to 1e-5 of that
  largest offset, and the recovered labels equal;
- ``exhaustive`` raises the JAX package's ``ValueError`` with its message.
"""

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu.attacks.base_attack import _BaseAttacker as JaxBaseAttacker
from breaching_tpu.cases.models.model_preparation import JaxModel
from breaching_tpu_torch.attacks.base_attack import _BaseAttacker

torch.set_num_threads(1)
CASE = ["case=1_single_image_small", "case.model=ConvNet8", "case.user.num_data_points=4",
        "case.data.partition=random", "case.user.provide_labels=False", "attack.label_strategy=wainakh-whitebox",
        "seed=5"]


def _attack_both():
    cfg, jax_cfg = breaching.get_config(CASE), jax_breaching.get_config(CASE)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, j_loss = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    model.from_jax_state(jax.tree_util.tree_map(np.array, j_model.params),
                         jax.tree_util.tree_map(np.array, j_model.buffers))
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    j_attacker = jax_breaching.attacks.prepare_attack(j_server.model, j_server.loss, jax_cfg.attack, jax_setup)
    shared, payloads, _ = server.run_protocol(user)
    j_shared, j_payloads, _ = j_server.run_protocol(j_user)
    rec_models, _, _ = attacker.prepare_attack(payloads, shared)
    j_rec_models, _, _ = j_attacker.prepare_attack(j_payloads, j_shared)
    return (attacker, rec_models), (j_attacker, j_rec_models, j_payloads, jax_setup)


def test_wainakh_whitebox_matches_jax_on_its_draws(monkeypatch):
    (attacker, rec_models), (j_attacker, j_rec_models, j_payloads, j_setup) = _attack_both()
    snapshot = j_setup["key"]
    key = jax.random.split(snapshot, 2)[1]  # the key the JAX sweeps split off the setup
    h, w, c = j_attacker.nhwc_shape

    def jax_draws(generator, index, count):
        draw = np.asarray(jax.random.normal(jax.random.fold_in(key, index), (count, h, w, c)))
        return torch.from_numpy(np.transpose(draw, (0, 3, 1, 2)).copy())
    monkeypatch.setattr(attacker, "_fake_data", jax_draws)

    m, s = attacker._wainakh_whitebox_estimates(rec_models, 4, 10, 1)
    j_m, j_s = j_attacker._wainakh_whitebox_estimates(j_rec_models, 4, 10, 1)
    # s to 1e-5 of its largest entry. m sums the whole head-weight gradient, which is 0 for
    # cross-entropy (each example's softmax minus its one-hot sums to 0): both packages give
    # rounding residue (about 1e-8; ROADMAP Queue C), held to 1e-5 of the offsets beside
    # which it is subtracted
    scale = np.abs(np.asarray(j_s)).max()
    np.testing.assert_allclose(s, np.asarray(j_s), rtol=0, atol=1e-5 * scale)
    assert abs(m - j_m) <= 1e-5 * scale, (m, j_m, scale)

    j_setup["key"] = snapshot  # the label recovery splits the same key again
    j_labels = j_attacker._recover_label_information(j_attacker._shared_data_cache, j_payloads, j_rec_models)
    labels = attacker._recover_label_information(attacker._shared_data_cache, rec_models)
    np.testing.assert_array_equal(labels, np.asarray(j_labels))
    assert sorted(labels.tolist()) == labels.tolist() and len(labels) == 4


def test_exhaustive_raises_the_jax_packages_error():
    grads = dict(gradients={"head.weight": torch.zeros(10, 6), "head.bias": torch.zeros(10)},
                 metadata=dict(num_data_points=3, labels=None))
    j_grads = dict(gradients={"head": {"dense": {"kernel": np.zeros((6, 10), np.float32),
                                                 "bias": np.zeros(10, np.float32)}}},
                   metadata=dict(num_data_points=3, labels=None))
    cfg = breaching.get_attack_config("invertinggradients", ["attack.label_strategy=exhaustive"])
    jax_cfg = jax_breaching.get_attack_config("invertinggradients", ["attack.label_strategy=exhaustive"])
    with pytest.raises(ValueError) as j_error:
        JaxBaseAttacker(None, None, jax_cfg, {})._recover_label_information(
            [j_grads], None, [JaxModel(name="head", module=None, params={}, buffers={})])
    with pytest.raises(ValueError) as error:
        _BaseAttacker(None, None, cfg, dict(device=torch.device("cpu")))._recover_label_information([grads])
    assert str(error.value) == str(j_error.value) and "1000 label vectors" in str(error.value)
