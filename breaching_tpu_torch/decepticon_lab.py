"""Offline Decepticon lab: simulate the exchange once, cache it, rerun the attack (counterpart
of ``tools/decepticon_lab.py``).

    python3 -m breaching_tpu_torch.decepticon_lab simulate --name decepticons_gpt2 [--lab DIR] [overrides...]
    python3 -m breaching_tpu_torch.decepticon_lab attack --name decepticons_gpt2 [--lab DIR] [overrides...]

``simulate`` builds the case from the named preset's overrides (``PRESETS``, this module's
copy of the Decepticon presets of ``examples/run_example.py``) and the extra ones, computes
the user's update, and pickles (payload, shared data, secrets, true data), every tensor as
a numpy array, to ``DIR/<name>.pkl`` (DIR defaults to ``outputs/lab``). ``attack`` rebuilds
the case, loads that file, reruns only the attacker on it and prints three stage-wise scores
against the true tokens: the recall of the recovered token multiset (the token strategy
alone), the per-sentence multiset overlap after clustering, and the positional accuracy.
``simulate`` and ``attack`` take ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from collections import Counter

import numpy as np
import torch

import breaching_tpu_torch as breaching
from .analysis.text_metrics import run_text_metrics

PMOD = "case.server.param_modification"
PRESETS = {
    "decepticons_transformer": ["case=10_causal_lang_training", "attack=decepticon",
                                "case/server=malicious-transformer", "case.user.num_data_points=8",
                                "case.user.user_idx=1", "case.data.batch_size=8", "case.data.default_clients=1000"],
    "decepticons_bert": ["case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer",
                         "case.model=bert-base-uncased", "case.user.num_data_points=1", "case.user.user_idx=1",
                         "case.data.shape=[512]"],
    "decepticons_gpt2": ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
                         "case.model=gpt2S", "case.user.num_data_points=8", "case.user.user_idx=1",
                         "case.data.shape=[512]", "case.data.batch_size=8", "case.data.default_clients=1000",
                         f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e6",
                         f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm",
                         "attack.embedding_token_weight=0.25"],
    "decepticons_hf_gpt2": ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
                            "case.model=hf-gpt2", "case.user.num_data_points=8", "case.data.shape=[512]",
                            "case.user.user_idx=1", "case.data.batch_size=8", "case.data.default_clients=1000",
                            f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e6",
                            f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm",
                            "attack.embedding_token_weight=0.25"],
    "decepticons_hf_bert": ["case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer",
                            "case.model=hf-bert", "case.user.num_data_points=1", "case.data.shape=[512]",
                            "case.user.user_idx=1", f"{PMOD}.reset_embedding=True", f"{PMOD}.v_length=32",
                            f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e8", f"{PMOD}.softmax_skew=1e8",
                            "attack.token_strategy=embedding-norm", "attack.exact_supplement=True",
                            "attack.collision_recovery=True", "attack.exact_refinement=2",
                            "attack.embedding_token_weight=0.8"],
}
LAB_DIR = os.path.join("outputs", "lab")


def _to_numpy(tree):
    """Every tensor of a tree of dicts, lists and tuples as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return type(tree)({k: _to_numpy(v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree, device, keep=()):
    """``_to_numpy`` undone: every numpy array as a tensor on ``device`` (the keys in ``keep``
    stay as they are)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    if isinstance(tree, dict):
        return type(tree)({k: v if k in keep else _to_torch(v, device, keep) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device, keep) for v in tree)
    return tree


def _case(name, overrides, device):
    cfg = breaching.get_config(PRESETS.get(name, []) + [f"name=lab_{name}", *overrides])
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    return cfg, setup, user, server, model


def simulate(name, overrides=(), lab_dir=LAB_DIR, device="cuda") -> str:
    """Compute the user's update of the preset and cache the exchange; returns the file."""
    cfg, setup, user, server, _ = _case(name, overrides, device)
    payload = server.distribute_payload()
    start = time.perf_counter()
    shared, true_data = user.compute_local_updates(payload)
    print(f"user update computed in {time.perf_counter() - start:.1f}s", flush=True)
    os.makedirs(lab_dir, exist_ok=True)
    path = os.path.join(lab_dir, f"{name}.pkl")
    with open(path, "wb") as fh:
        pickle.dump(dict(payload=_to_numpy(payload), shared=_to_numpy(shared), secrets=_to_numpy(server.secrets),
                         true_data=_to_numpy(true_data), overrides=list(overrides)), fh)
    print(f"cached exchange -> {path}", flush=True)
    return path


def _multiset_recall(rec_bag, true_bag):
    overlap = sum(min(c, rec_bag[t]) for t, c in true_bag.items())
    return overlap / max(sum(true_bag.values()), 1)


def attack(name, overrides=(), lab_dir=LAB_DIR, device="cuda") -> dict:
    """Rerun the attacker on the cached exchange; its reconstruction, the token-bag recall
    and the text metrics."""
    cfg, setup, _, server, model = _case(name, overrides, device)
    with open(os.path.join(lab_dir, f"{name}.pkl"), "rb") as fh:
        blob = pickle.load(fh)  # written by ``simulate``
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    device = setup["device"]
    payload, shared = _to_torch(blob["payload"], device), _to_torch(blob["shared"], device)
    secrets = _to_torch(blob["secrets"], device)
    start = time.perf_counter()
    rec, _ = attacker.reconstruct([payload], [shared], secrets, dryrun=cfg.dryrun)
    print(f"attack ran in {time.perf_counter() - start:.1f}s", flush=True)
    ref = np.asarray(blob["true_data"]["data"])
    out = rec["data"].detach().cpu().numpy()
    bag_recall = _multiset_recall(Counter(out.reshape(-1).tolist()), Counter(ref.reshape(-1).tolist()))
    metrics = run_text_metrics(dict(data=out.copy()), dict(data=ref), [payload], model)
    print(f"STAGES: | token-bag recall: {bag_recall:.4f} | per-sentence multiset: {metrics['token_acc']:.4f} "
          f"| positional acc: {metrics['accuracy']:.4f} | BLEU: {100 * metrics['google_bleu']:.2f}", flush=True)
    return dict(reconstruction=out, bag_recall=bag_recall, metrics=metrics)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=["simulate", "attack"])
    parser.add_argument("--name", required=True)
    parser.add_argument("--lab", default=LAB_DIR)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)
    if args.mode == "simulate":
        return simulate(args.name, args.overrides, args.lab)
    return attack(args.name, args.overrides, args.lab)


if __name__ == "__main__":
    main()
