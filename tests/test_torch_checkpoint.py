"""Attack-state checkpoints and the profiler trace of the port's attack loop, on the CPU
(ConvNet-8, 16x16, the fused cosine objective):

- a run of 12 steps (read back every 4, checkpointed after every chunk) and a fresh
  attacker resumed from its checkpoint at step 8 end bit for bit alike: the same last
  four losses, best value and reconstruction. For Adam on one trial (with Langevin
  noise, whose generator the checkpoint carries), for the batched trial step of two
  trials, for plain gradient descent, and for L-BFGS (its history, ``h_diag``, last
  direction, step scale and counters as named arrays, as the JAX package's carry holds
  them);
- two trials of gradient descent run one after the other keep a section each of one
  file: a run resumed from the file as it stood at the second trial's step 8 restores
  the first trial where it ended and the second at step 8, and ends as the
  uninterrupted run;
- the multiscale attack (2 stages of 8 steps, ResNet-20 at 16x16) passes the same file
  to every stage, as the JAX package's does: resumed from stage 0's state at step 4 it
  resumes stage 0 there; from stage 1's state at step 4, stage 0 finds a state of
  another size, warns and starts afresh, and so does stage 1 after it; both end as the
  uninterrupted run;
- a checkpoint whose shapes do not fit the run is ignored with a warning: the run
  starts fresh and ends as one without a checkpoint;
- ``trace_dir`` writes a Chrome trace of the second chunk.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

import breaching_tpu_torch as breaching
from breaching_tpu_torch import utils_checkpoint

torch.set_num_threads(1)
SLICE = ["case=1_single_image_small", "attack=invertinggradients", "attack.objective.type=fused-cosine-similarity",
         "case.model=ConvNet8", "case.data.shape=[3, 16, 16]", "attack.optim.max_iterations=12",
         "attack.optim.callback=4", "seed=0"]


def _attack(overrides, base=SLICE):
    cfg = breaching.get_config(base + overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    return attacker.reconstruct(payloads, shared, server.secrets)


@pytest.mark.parametrize("overrides,trials", [
    (["attack.optim.langevin_noise=0.1"], 1),
    (["attack.restarts.num_trials=2"], 2),
    (["attack.optim.optimizer=gd", "attack.optim.step_size=0.01"], 1),
    (["attack.optim.optimizer=L-BFGS", "attack.optim.step_size=0.01"], 1)])
def test_a_resumed_run_ends_as_the_uninterrupted_one(overrides, trials, tmp_path, monkeypatch):
    path, at_8 = str(tmp_path / "state.npz"), str(tmp_path / "state_at_8.npz")
    save = utils_checkpoint.save_attack_state

    def save_and_keep_step_8(target, arrays, iteration):
        save(target, arrays, iteration)
        if iteration == 8 and target == path:
            shutil.copy(path, at_8)
    monkeypatch.setattr(utils_checkpoint, "save_attack_state", save_and_keep_step_8)
    knobs = ["attack.impl.checkpoint_every=1"]
    rec, stats = _attack(overrides + knobs + [f"attack.impl.checkpoint_path={path}"])
    with np.load(at_8) as blob:  # the state of step 8
        assert int(blob["iteration"]) == 8 and "state/tree/data" in blob.files
    resumed, resumed_stats = _attack(overrides + knobs + [f"attack.impl.checkpoint_path={at_8}"])
    assert "resumed_at" not in stats and resumed_stats["resumed_at"] == 8
    for t in range(trials):
        assert len(stats[f"Trial_{t}_Val"]) == 12
        assert resumed_stats[f"Trial_{t}_Val"] == stats[f"Trial_{t}_Val"][8:]
    assert resumed_stats["opt_value"] == stats["opt_value"]
    assert torch.equal(resumed["data"], rec["data"])


def test_trials_one_after_the_other_resume_from_their_sections(tmp_path, monkeypatch):
    path, kept = str(tmp_path / "state.npz"), str(tmp_path / "kept.npz")
    save = utils_checkpoint.save_attack_state

    def save_and_keep(target, arrays, iteration, section=None):
        save(target, arrays, iteration, section=section)
        if section == "trial1" and iteration == 8 and target == path:
            shutil.copy(path, kept)
    monkeypatch.setattr(utils_checkpoint, "save_attack_state", save_and_keep)
    knobs = ["attack.optim.optimizer=gd", "attack.optim.step_size=0.01", "attack.restarts.num_trials=2",
             "attack.impl.checkpoint_every=1"]
    rec, stats = _attack(knobs + [f"attack.impl.checkpoint_path={path}"])
    with np.load(kept) as blob:  # the first trial where it ended, the second at step 8
        assert int(blob["trial0/iteration"]) == 12 and int(blob["trial1/iteration"]) == 8
        assert "trial0/state/tree/data" in blob.files and "iteration" not in blob.files
    resumed, resumed_stats = _attack(knobs + [f"attack.impl.checkpoint_path={kept}"])
    assert len(stats["Trial_0_Val"]) == len(stats["Trial_1_Val"]) == 12
    assert resumed_stats["Trial_0_Val"] == [] and resumed_stats["Trial_1_Val"] == stats["Trial_1_Val"][8:]
    assert resumed_stats["resumed_at"] == 8
    assert resumed_stats["opt_value"] == stats["opt_value"] and torch.equal(resumed["data"], rec["data"])


MULTISCALE = ["case=1_single_image_small", "case.model=resnet20", "case.data.shape=[3, 16, 16]",
              "attack=multiscale_ghiasi", "attack.num_stages=2", "attack.optim.max_iterations=8",
              "attack.optim.callback=4", "seed=0"]


@pytest.mark.parametrize("stage_size,resumed_at", [(8, 4), (16, None)])
def test_multiscale_stages_share_one_file_as_jax(stage_size, resumed_at, tmp_path, monkeypatch, caplog):
    path, kept = str(tmp_path / "state.npz"), str(tmp_path / "kept.npz")
    save = utils_checkpoint.save_attack_state

    def save_and_keep(target, arrays, iteration):
        save(target, arrays, iteration)
        if arrays["tree/data"].shape[-1] == stage_size and iteration == 4 and target == path:
            shutil.copy(path, kept)
    monkeypatch.setattr(utils_checkpoint, "save_attack_state", save_and_keep)
    knobs = ["attack.impl.checkpoint_every=1"]
    rec, stats = _attack(knobs + [f"attack.impl.checkpoint_path={path}"], base=MULTISCALE)
    with caplog.at_level(logging.WARNING):
        resumed, resumed_stats = _attack(knobs + [f"attack.impl.checkpoint_path={kept}"], base=MULTISCALE)
    assert len(stats["Trial_0_Val"]) == 16
    assert resumed_stats.get("resumed_at") == resumed_at
    if resumed_at is None:  # stage 0 found stage 1's state and started afresh
        assert "ignoring checkpoint" in caplog.text
        assert resumed_stats["Trial_0_Val"] == stats["Trial_0_Val"]
    else:
        assert resumed_stats["Trial_0_Val"] == stats["Trial_0_Val"][4:]
    assert resumed_stats["opt_value"] == stats["opt_value"] and torch.equal(resumed["data"], rec["data"])


def test_a_checkpoint_that_does_not_fit_is_ignored(tmp_path, caplog):
    path = str(tmp_path / "state.npz")
    _attack(["attack.impl.checkpoint_every=1", f"attack.impl.checkpoint_path={path}"])
    overrides = ["case.user.num_data_points=2"]  # a candidate of another shape
    fresh, fresh_stats = _attack(overrides)
    with caplog.at_level(logging.WARNING):
        rec, stats = _attack(overrides + [f"attack.impl.checkpoint_path={path}"])
    assert "ignoring checkpoint" in caplog.text and "resumed_at" not in stats
    assert stats["Trial_0_Val"] == fresh_stats["Trial_0_Val"] and torch.equal(rec["data"], fresh["data"])


def test_trace_dir_writes_a_trace_of_one_chunk(tmp_path):
    trace_dir = str(tmp_path / "trace")
    _, stats = _attack([f"attack.impl.trace_dir={trace_dir}", "attack.optim.max_iterations=8"])
    assert stats["trace_file"] == os.path.join(trace_dir, "attack_chunk_4.json")
    with open(stats["trace_file"]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {event.get("name", "") for event in events}
    assert any(name.startswith("aten::") for name in names) and len(events) > 100
