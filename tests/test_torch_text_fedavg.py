"""The fedAVG user and the secure-aggregation silo on text, and the attack on their updates,
against the JAX package, on the CPU: case 10 cut to vocab 128 and 8 tokens, on
``transformer1``, ``transformer3`` and ``gpt2-tiny``, the same weights in both packages.

- the fedAVG user's delta (4 sequences, 2 local steps of 1) and the silo's aggregate in its
  single-step form (the users' fedSGD gradients, averaged) and its multi-step form (the
  running mean of 2 fedAVG users' deltas, 2 local steps of 2 sequences), 2 users of 2
  sequences each, to 1e-5 of each leaf's largest entry (a delta, plus one float32 ulp of
  its parameter for each local step, which rounds p - lr g to the parameter's ulps);
- the shared metadata equal: ``data_key`` ``input_ids``, the per-step labels sorted along
  each sequence (the JAX package's ``np.sort`` of each step's (data per step, seq) rows),
  ``num_data_points``, ``num_users``, the labels;
- the attack's objective through the fedAVG user's unrolled local steps (``transformer1``,
  ``transformer3``) on the same candidate embeddings and soft labels: ``tag-euclidean``'s value to 1e-5, ``euclidean``'s value to 1e-5 of the
  port's float64 value and its embedding gradient to 1e-4 of the largest entry;
- ``tag`` over 3 steps from the JAX package's initial candidate on the fedAVG user and the
  single-step silo (``transformer1``): the losses to 1e-3, the same tokens; a multi-step silo's shared label
  rows of every user refused by both packages' attacks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_imprint import _as_port, _flat
from test_torch_text_presets import CASE10, both_cases, share_jax_initial_candidate

torch.set_num_threads(1)
USERS = {
    "fedavg": ["case/user=local_updates", "case.user.num_local_updates=2"],
    "silo_single_step": ["case/user=multiuser_aggregate", "case.user.user_range=[0,2]",
                         "case.user.num_data_points=2"],
    "silo_multi_step": ["case/user=multiuser_aggregate", "case.user.user_range=[0,2]", "case.user.num_data_points=2",
                        "case.user.num_local_updates=2", "case.user.num_data_per_local_update_step=1",
                        "case.user.provide_local_hyperparams=True"],
}
CASES = [("transformer1", user) for user in USERS] + [("transformer3", "fedavg"), ("gpt2-tiny", "fedavg")]


def _case(model, user, steps=3):
    return both_cases(CASE10 + ["attack=tag", f"case.model={model}", f"attack.optim.max_iterations={steps}",
                                "attack.optim.callback=1"] + USERS[user])


def _labels(value):
    return None if value is None else np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value)


@pytest.mark.parametrize("model,user", CASES)
def test_update_and_metadata_match_jax(model, user):
    e = _case(model, user)
    (shared,), (j_shared,) = e["shared"], e["j_shared"]
    module = e["server"].model
    want = _as_port(module, _flat(j_shared["gradients"]))
    assert sorted(want) == sorted(shared["gradients"])
    parameters = e["payloads"][0]["parameters"]
    for name, delta in shared["gradients"].items():
        # each local step p - lr g rounds to the parameter's float32 ulps: one ulp a step on top
        steps = 0 if user == "silo_single_step" else int(e["cfg"].case.user.num_local_updates)
        ulp = steps * np.spacing(np.abs(parameters[name].numpy()))
        excess = np.abs(delta.numpy() - want[name]) - (1e-5 * np.abs(want[name]).max() + ulp)
        assert excess.max() <= 0, (name, float(excess.max()))

    metadata, j_metadata = shared["metadata"], j_shared["metadata"]
    assert metadata["data_key"] == j_metadata["data_key"] == "input_ids"
    assert metadata["num_data_points"] == j_metadata["num_data_points"] == 4
    assert metadata.get("num_users") == j_metadata.get("num_users") == (None if user == "fedavg" else 2)
    np.testing.assert_array_equal(_labels(metadata["labels"]), _labels(j_metadata["labels"]))
    hyper, j_hyper = metadata["local_hyperparams"], j_metadata["local_hyperparams"]
    assert (hyper is None) == (j_hyper is None) == (user == "silo_single_step")
    if hyper is not None:
        assert (hyper["lr"], hyper["steps"], hyper["data_per_step"]) == \
            (j_hyper["lr"], j_hyper["steps"], j_hyper["data_per_step"])
        assert len(hyper["labels"]) == len(j_hyper["labels"]) == (2 if user == "fedavg" else 4)
        for step, j_step in zip(hyper["labels"], j_hyper["labels"]):
            assert step.dtype == torch.int64 and step.shape[-1] == 8
            np.testing.assert_array_equal(step.numpy(), np.asarray(j_step))
            np.testing.assert_array_equal(step.numpy(), np.sort(step.numpy(), axis=-1))

    data, j_data = e["true"]["data"], e["j_true"]["data"]
    assert data.dtype == torch.int64
    np.testing.assert_array_equal(data.numpy(), np.asarray(j_data))
    np.testing.assert_array_equal(e["true"]["labels"].numpy(), np.asarray(e["j_true"]["labels"]))


def _objectives(e, objective, j_objective):
    """Each package's ``objective`` initialized on its own prepared attack of the exchange
    (the local hyperparameters as the attack stacks them), with its model and target."""
    attacker, j_attacker = e["attacker"], e["j_attacker"]
    models, _, _ = attacker.prepare_attack(e["payloads"], e["shared"])
    j_models, _, _ = j_attacker.prepare_attack(e["j_payloads"], [dict(d) for d in e["j_shared"]])
    shared, j_shared = attacker._shared_data_cache[0], j_attacker._shared_data_cache[0]
    hyper = attacker._local_hyperparams(shared["metadata"])
    j_hyper = dict(j_shared["metadata"]["local_hyperparams"])
    j_hyper["labels"] = jnp.asarray(np.stack([np.asarray(step) for step in j_hyper["labels"]]))
    np.testing.assert_array_equal(hyper["labels"].numpy(), np.asarray(j_hyper["labels"]))
    objective.initialize(attacker.loss_fn, models[0].module, hyper, e["cfg"].attack.impl)
    j_objective.initialize(j_attacker.loss_fn, j_models[0], j_hyper, e["cfg"].attack.impl)
    rec = models[0]
    target = tuple(shared["gradients"][k] for k in rec.params)

    def port(candidate, soft, dtype=torch.float32):
        """The port's value and candidate gradient, in ``dtype``."""
        module = rec.module if dtype == torch.float32 else copy.deepcopy(rec.module).to(dtype)
        objective.model = module
        params = {k: v.detach().to(dtype).requires_grad_(True) for k, v in rec.params.items()}
        x = torch.tensor(candidate, dtype=dtype, requires_grad=True)
        value, _ = objective(params, {k: v.to(dtype) for k, v in rec.buffers.items()},
                             tuple(t.to(dtype) for t in target), x, torch.as_tensor(soft, dtype=dtype))
        objective.model = rec.module
        return float(value), torch.autograd.grad(value, x)[0].numpy()

    def jax_side(candidate, soft):
        def value(c):
            return j_objective(j_models[0].params, j_models[0].buffers, j_shared["gradients"], c,
                               jnp.asarray(soft))[0]
        val, grad = jax.value_and_grad(value)(jnp.asarray(candidate))
        return float(val), np.asarray(grad)

    return port, jax_side


@pytest.mark.parametrize("model", ["transformer1", "transformer3"])
def test_objective_through_the_unrolled_steps_matches_jax(model):
    """On the fedAVG user's exchange, the same candidate embeddings and soft labels:
    ``euclidean``'s value within 1e-5 of the port's float64 value and 1e-4 of the JAX
    package's (whose float32 sum lies up to 3.3e-5 from float64), its embedding gradient
    within 1e-4 of the JAX package's largest entry; ``tag-euclidean`` (the preset's) in value
    within 1e-5 of the JAX package's. TAG's L1 term takes the sign of each delta difference,
    so its gradient in float32, in either package, lies up to 1.9e-3 of its largest entry
    from float64 (ROADMAP Queue C), and is not compared entry by entry."""
    from breaching_tpu.attacks.auxiliaries.objectives import Euclidean as JaxEuclidean
    from breaching_tpu_torch.attacks.auxiliaries.objectives import Euclidean

    e = _case(model, "fedavg")
    rng = np.random.default_rng(7)
    width = e["server"].model.embedding.shape[1]
    candidate = (0.5 * rng.standard_normal((4, 8, width))).astype(np.float32)
    soft = np.asarray(jax.nn.softmax(rng.standard_normal((4, 8, 128)).astype(np.float32), axis=-1))

    port, jax_side = _objectives(e, e["attacker"].objective, e["j_attacker"].objective)
    assert type(e["attacker"].objective).__name__ == "EuclideanTag"
    np.testing.assert_allclose(port(candidate, soft)[0], jax_side(candidate, soft)[0], rtol=1e-5)

    port, jax_side = _objectives(e, Euclidean(), JaxEuclidean())
    (value, grad), (j_value, j_grad) = port(candidate, soft), jax_side(candidate, soft)
    value64, _ = port(candidate, soft, torch.float64)
    np.testing.assert_allclose(value, value64, rtol=1e-5)
    np.testing.assert_allclose(value, j_value, rtol=1e-4)
    np.testing.assert_allclose(grad, j_grad, rtol=0, atol=1e-4 * np.abs(j_grad).max())


def test_a_multi_step_silos_label_rows_are_refused_by_the_attack():
    """A multi-step silo that shares its local hyperparameters shares every user's per-step
    label rows (4 for 2 users of 2 steps): the JAX package's unrolled scan refuses them, and
    so does the port's attack, by name."""
    e = _case("transformer1", "silo_multi_step")
    with pytest.raises(ValueError, match="4 per-step label rows for 2 local steps"):
        e["attacker"].reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    with pytest.raises(ValueError, match="different leading axis sizes"):
        e["j_attacker"].reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)


@pytest.mark.parametrize("model,user", [("transformer1", "fedavg"), ("transformer1", "silo_single_step")])
def test_tag_steps_match_jax(model, user):
    e = _case(model, user)
    share_jax_initial_candidate(e)
    j_rec, j_stats = e["j_attacker"].reconstruct(e["j_payloads"], e["j_shared"], e["j_server"].secrets)
    rec, stats = e["attacker"].reconstruct(e["payloads"], e["shared"], e["server"].secrets)
    got, want = np.asarray(stats["Trial_0_Val"]), np.asarray(j_stats["Trial_0_Val"])
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert rec["data"].dtype == torch.int64 and rec["data"].shape == (4, 8)
    np.testing.assert_array_equal(rec["data"].numpy(), np.asarray(j_rec["data"]))
