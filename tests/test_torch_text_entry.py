"""The text stack through the port's entry point, and the reference behaviours it follows
on purpose, on the CPU.

- ``main_process(cfg, device="cpu")`` with ``dryrun=True`` runs the ``tag``,
  ``permutation`` and ``dlg_text`` presets and case 9 with ``attack=tag`` (vocab 128, 8
  tokens) and writes the text report's metrics and the reconstruction's token ids.
- The tied ``gpt2`` under ``run-embedding``: the target's embedding leaf is zeroed, while
  the candidate's embedding gradient still carries the tied decoder's; both are matched
  all the same, as the JAX package matches them: the port's TAG objective lies within 1e-6
  of its float64 value, the JAX package's eager value within 1e-4.
- At case 10's transformer3 the euclidean objective of ``dlg_text`` is a float32 sum over
  about 1.1M gradient entries: the port's value lies within 1e-6 of the float64 value of
  the same gradients, the JAX package's eager value within 1e-4, and its jitted value, as its
  attack computes it, within 2e-3 (about 1.1e-3 off: its reductions; so
  tests/test_torch_text_presets.py holds ``dlg_text``'s L-BFGS trajectory to the JAX
  package's on the linear model).
- ``postprocess_text_data``'s ``from-limited-embedding`` and ``from-labels`` give the JAX
  package's tokens.
- ``attack.impl.grad_accum`` on text: the user gradient of 2 sentences as the mean over 2
  micro-batches, where the embedding table gets no gradient from the candidate, equals the
  whole batch's: the objective within 1e-6 relative, its gradient within 1e-5 of the largest
  entry (float32, sums in other orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from breaching_tpu.attacks.auxiliaries import text_utils as jax_text_utils
import breaching_tpu_torch as breaching
from breaching_tpu_torch.attacks.auxiliaries import text_utils
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries
from breaching_tpu_torch.simulate_breach import main_process

from test_torch_text_presets import both_cases, share_jax_initial_candidate

torch.set_num_threads(1)
SMALL = ["case.data.vocab_size=128", "case.data.shape=[8]", "seed=0"]
ENTRY = {
    "tag": ["case=10_causal_lang_training", "attack=tag", "case.model=transformer1"],
    "permutation": ["case=10_causal_lang_training", "attack=permutation", "case.model=transformer1",
                    "case.user.num_data_points=2"],
    "dlg_text": ["case=10_causal_lang_training", "attack=deepleakage", "case.user.provide_labels=False",
                 "case.model=transformer1"],
    "bert_tag": ["case=9_bert_training", "attack=tag", "case.model=bert-tiny"],
    "tag_lstm": ["case=10_causal_lang_training", "attack=tag", "case.model=LSTM"],
}
TEXT_KEYS = {"accuracy", "token_acc", "bleu", "google_bleu", "sacrebleu", "rouge1", "rouge2", "rougeL", "order",
             "label_acc", "feat_mse", "parameters"}


@pytest.mark.parametrize("preset", sorted(ENTRY))
def test_text_preset_dry_run_through_the_entry_point(preset, tmp_path, caplog):
    cfg = breaching.get_config(ENTRY[preset] + SMALL + ["dryrun=True", "save_reconstruction=True"])
    cfg.base_dir = str(tmp_path)
    outputs = {}
    metrics = main_process(cfg, device="cpu", outputs=outputs)
    assert set(metrics) == TEXT_KEYS
    assert 0.0 <= metrics["token_acc"] <= 1.0 and np.isfinite(metrics["feat_mse"])
    assert "METRICS: | Accuracy:" in caplog.text
    rec = outputs["reconstruction"]["data"]
    assert rec.dtype == torch.int64 and rec.shape == outputs["true"]["data"].shape
    with open(os.path.join(tmp_path, f"metrics_{cfg.name}.yaml")) as fh:
        saved = yaml.safe_load(fh)
    assert saved["token_acc"] == metrics["token_acc"] and saved["parameters"] == metrics["parameters"]
    with open(os.path.join(tmp_path, "reconstructions", f"{cfg.name}_rec.txt")) as fh:
        assert fh.read() == str(rec.tolist())


def _objective_values(e):
    """(port value, JAX eager value, the port's formula in float64, port gradients, port
    targets, their index by parameter name) of the attack's objective at the JAX
    package's initial candidate."""
    tree = share_jax_initial_candidate(e)
    j_attacker, attacker = e["j_attacker"], e["attacker"]
    j_models, _, _ = j_attacker.prepare_attack(e["j_payloads"], [dict(d) for d in e["j_shared"]])
    models, _, _ = attacker.prepare_attack(e["payloads"], [dict(d) for d in e["shared"]])
    j_attacker.objective.initialize(j_attacker.loss_fn, j_models[0], None, j_attacker.cfg.impl)
    attacker.objective.initialize(attacker.loss_fn, models[0].module, None, attacker.cfg.impl)
    j_labels = jax.nn.softmax(jnp.asarray(tree["labels"]), axis=-1)
    want, _, _ = j_attacker.objective(j_models[0].params, j_models[0].buffers,
                                      j_attacker._shared_data_cache[0]["gradients"], jnp.asarray(tree["data"]),
                                      j_labels)
    model = models[0]
    targets = tuple(attacker._shared_data_cache[0]["gradients"][k] for k in model.params)
    data, labels = torch.from_numpy(tree["data"].copy()), torch.softmax(torch.from_numpy(tree["labels"].copy()), -1)
    got, _ = attacker.objective(model.params, model.buffers, targets, data, labels)
    grads, _ = attacker.objective.grad_fn(model.params, model.buffers, data, labels)
    exact = float(attacker.objective.gradient_based_loss(tuple(g.detach().double() for g in grads),
                                                         tuple(t.double() for t in targets)))
    return float(got.detach()), float(want), exact, grads, targets, dict(zip(model.params, range(len(targets))))


def _jax_trees(e, *tensor_tuples):
    """Tuples of tensors in the port model's parameter order as JAX parameter trees."""
    model = e["server"].model
    position = {id(p): i for i, p in enumerate(model.parameters())}
    params = e["j_server"].model.params
    paths = ["params/" + "/".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    trees = []
    for values in tensor_tuples:
        flat = {}
        for key, tensor, transform in _flat_entries(model):
            value = values[position[id(tensor)]].detach().numpy()
            flat[key] = transform(value) if transform is not None else value
        trees.append(jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                                  [jnp.asarray(flat[k]) for k in paths]))
    return trees


def test_tied_gpt2_matches_the_decoders_gradient_against_the_zeroed_target():
    e = both_cases(["case=10_causal_lang_training", "attack=tag", "case.model=gpt2-tiny"] + SMALL)
    got, want, exact, grads, targets, index = _objective_values(e)
    embedding = index["embedding"]
    assert not targets[embedding].any()                        # the target's leaf: zeroed
    assert float(grads[embedding].detach().abs().max()) > 1e-3  # the candidate's: the decoder's gradient
    assert e["server"].model.tie_weights
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    np.testing.assert_allclose(want, exact, rtol=1e-4)


def test_case10_euclidean_value_is_the_float64_value():
    e = both_cases(["case=10_causal_lang_training", "attack=deepleakage", "case.user.provide_labels=False"] + SMALL)
    got, want, exact, grads, targets, _ = _objective_values(e)
    assert exact == 0.5 * sum(float(((g.detach().double() - t.double()) ** 2).sum()) for g, t in zip(grads, targets))
    assert sum(t.numel() for t in targets) > 1_000_000
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    np.testing.assert_allclose(want, exact, rtol=1e-4)
    # the JAX package's jitted value, as its attack computes it: its float32 sums, about 1e-3 off
    objective = e["j_attacker"].objective
    jitted = float(jax.jit(objective.gradient_based_loss)(*_jax_trees(e, grads, targets)))
    np.testing.assert_allclose(jitted, exact, rtol=2e-3)


@pytest.mark.parametrize("recovery", ["from-limited-embedding", "from-labels", "from-embedding"])
def test_postprocessing_matches_jax(recovery):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((128, 16)).astype(np.float32)
    rec = rng.standard_normal((2, 6, 16)).astype(np.float32)
    labels = rng.integers(0, 128, (2, 6))

    class Attacker:
        def __init__(self, weight):
            self.cfg = dict(token_recovery=recovery)
            self.embeddings = [dict(weight=weight)]

    want = jax_text_utils.postprocess_text_data(Attacker(jnp.asarray(table)),
                                                dict(data=jnp.asarray(rec), labels=jnp.asarray(labels)))
    got = text_utils.postprocess_text_data(Attacker(torch.from_numpy(table)),
                                           dict(data=torch.from_numpy(rec), labels=torch.from_numpy(labels)))
    np.testing.assert_array_equal(np.asarray(got["data"]), np.asarray(want["data"]))
    assert tuple(got["data"].shape) == (2, 6)


def test_micro_batched_text_objective_equals_the_whole_batch():
    overrides = ["case=10_causal_lang_training", "attack=deepleakage", "case.user.provide_labels=False",
                 "case.model=transformer1", "case.user.num_data_points=2", "case.data.batch_size=2"] + SMALL
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    models, _, _ = attacker.prepare_attack(payloads, shared)
    targets = tuple(attacker._shared_data_cache[0]["gradients"][k] for k in models[0].params)
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(2, 8, model.embedding.shape[1], generator=gen)
    labels = torch.softmax(torch.randn(2, 8, 128, generator=gen), dim=-1)
    results = []
    for accum in (1, 2):
        cfg.attack.impl.grad_accum = accum
        attacker.objective.initialize(loss_fn, models[0].module, None, cfg.attack.impl)
        x = data.clone().requires_grad_(True)
        value, _ = attacker.objective(models[0].params, models[0].buffers, targets, x, labels)
        results.append((float(value.detach()), torch.autograd.grad(value, x)[0]))
    (whole, g_whole), (micro, g_micro) = results
    np.testing.assert_allclose(micro, whole, rtol=1e-6)
    torch.testing.assert_close(g_micro, g_whole, rtol=0, atol=1e-5 * float(g_whole.abs().max()))
