"""Where the time of a slice's attack step goes, on the card.

    python3 -m breaching_tpu_torch.profile_slice [--slice 1|2|3|4|5|6|7|12|13|14|15|16|17]
                                                 [--path 5a|...|7d|12a|...|12e'|13a|...|13e|14a|...|14f|15a|...|15e|
                                                         16a|16a'|16a''|16b|16c]
                                                 [--fleet F] [--fused] [--lbfgs] [--iterations N]

Slice 1 (the default) runs Inverting Gradients with the fused cosine objective on
ConvNet-64 / CIFAR-10 shapes; slice 2 the JAX package's bench preset on ResNet-18
at ImageNet shapes (the repo's trained checkpoint), with ``--fused`` the fused
cosine objective, and with ``--fleet F`` as F experiments of one server through
``reconstruct_fleet``; slice 3 the fedAVG user of case 4 on the same ResNet-18 (4
images, 4 local steps of 2), as the JAX package's notebook preset
``inverting_gradients_fedavg_imagenet`` runs it, with ``--fused`` the fused cosine
objective; slice 4 the JAX package's ``modern_hyperparams`` preset on the same
ResNet-18 at ImageNet shapes (soft-signed Adam with warmup and cosine decay,
double-opponent TV, feature regularization), or with ``--lbfgs`` its
``deep_leakage`` preset with the fused euclidean objective on ConvNet-64 (the joint
attack of data and label logits with L-BFGS; a step is an outer L-BFGS step of up to
21 evaluations of the objective, 20 steps by default); slice 5 one of the JAX
package's remaining vision presets, chosen by ``--path``: 5a ``multiscale`` (ResNet-18
on its checkpoint at 224, seven stages 32, 64, ..., 224 of N steps each), 5b
``inverting_large_batch_cifar`` (ResNet32-10 on 100 images of CIFAR-100's shape,
grad_accum=10), 5b' the same with grad_accum=1, 5c ``see_through_gradients``
(ResNet-50 on the repo's checkpoint at 224); slice 6 its path 6a, the same ResNet-18 at
ImageNet shapes with 4 images and their labels, the user's gradient clipped per example at 1
with Laplace noise of scale 1e-3; slice 7 one of the fishing server's presets, chosen by
``--path``: 7c ``fishing`` (ResNet-50 on its checkpoint, 8 images at 224, the class attack
on one of them) or 7d ``fishing_optimization_unique`` (ResNet-18 on its checkpoint, 50
images of one class, the one-shot binary attack), the clsattack optimization on the one
image the server isolates; slice 12 one of the honest server's text presets, chosen by
``--path``: 12a ``tag`` (case 10's transformer3, one sentence of 32 tokens of the GPT-2
vocabulary), 12b ``permutation``, 12c ``dlg_text`` (L-BFGS; a step is an outer step, 10 by
default), 12d case 9's ``bert-base-uncased`` with ``tag``, 12e ``tag`` on ``gpt2`` and 12e'
``permutation`` on ``gpt2`` with 8 sentences; slice 13 one of the malicious text servers and its
analytic readout, chosen by ``--path``: 13a ``decepticons_transformer`` (transformer3, 8 sentences of
32 tokens, k-means on the assignment solver), 13b ``decepticons_bert`` (``bert-base-uncased``, 1 x
512), 13c ``decepticons_gpt2``'s overrides on the port's ``gpt2`` (8 x 512), 13d
``robbing_the_fed_text`` and 13e ``curious_abandon_honesty_text`` (128 x 32 on transformer3); slice 14
one of the HuggingFace architectures' paths: the readouts 14a ``decepticons_gpt2`` (``gpt2S``, 8 x 512),
14b ``decepticons_hf_gpt2`` (``hf-gpt2``) and 14c ``decepticons_hf_bert`` (``hf-bert``, 1 x 512, the
exact-reference stack), profiled as slice 13's, and the attacks 14d ``tag`` on ``hf-roberta-base`` (case
10 as a masked LM) and 14d' on ``hf-distilbert`` (case 9), 14e ``tag`` on ``hf-bert``'s classification
head (cola, 2 sentences) and 14f ``permutation`` on ``hf-gpt2`` (8 sentences); slice 15 one of
``handle_preceding_layers=VAE`` on ``robbing_the_fed`` (ResNet-18 on its checkpoint, 1 image at
224, the server's external data), profiled as slice 13's paths with the decoder's training in
the server's seconds: 15a the top placement (a VAE, 200 steps) and 15b the block before stage 2
(a ``FeatureDecoder``, 800 steps), or ``tag`` on case 10 under 15c the fedAVG user (4 sentences,
4 local steps), 15d the silo of 8 users x 4 sentences (single-step) and 15d' with 2 local steps,
and 15e on ``gpt2`` under the fedAVG user (1 sentence, 2 local steps); slice 16 slice 2 with the
fused cosine objective under the attack's precision knobs: 16a ``attack.impl.dtype=bfloat16``, 16a''
``attack.impl.dtype=float16``, 16a' ``case.impl.dtype=bfloat16`` (a bfloat16 candidate), 16b
``case.impl.dtype=float64`` (20 steps by default) and 16c ``attack.impl.mixed_precision=True``; slice 17
the in-repo trainer's materialized epoch (``train_model.materialized_epoch``) on case 1's ConvNet-64 at
3x32x32, 4,096 synthetic training images on the card in batches of 128 with the device augmentation,
SGD on the cosine schedule: one warm-up epoch, one timed with the profiler off and one under the
profiler (its steps are the epoch's 32; ``--iterations`` does not apply). The attacks each
go through the entry points: one warm-up attack, an
attack of N steps (default 200) timed with the profiler off, and the same attack
under ``torch.profiler``. Slice 13, the readouts of slice 14 and 15a-b have no steps: one warm-up run of
the whole path, one timed with the profiler off (seconds of the server's model, rewiring or block and calibration; of the
user's gradient; of the readout, by stage, and of the assignment solver in it), and one under
the profiler (device busy and idle share of the whole path, launches, peak memory). Prints one JSON line: milliseconds per step with the
profiler off and on (wall clock around the synchronised attack; the difference
is the profiler's cost), device-busy milliseconds per step (the sum of the
kernels' device times; one stream, so they do not overlap), the idle share of
the unprofiled step, kernel launches per step (and, for L-BFGS, the objective's
evaluations per step), device time per step of the
kernels that take most of it, and device time and launches per step of each of
the port's own kernels (``csrc/``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import breaching_tpu_torch as breaching

SLICES = {
    1: ["case=1_single_image_small", "attack=invertinggradients",
        "attack.objective.type=fused-cosine-similarity", "attack.optim.callback=0", "seed=0"],
    2: ["case=2_single_imagenet", "attack=invertinggradients", "attack.restarts.num_trials=1",
        "case.user.provide_labels=True", "attack.optim.callback=0", "seed=7"],
    3: ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.user.num_data_points=4",
        "case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
        "case.user.provide_labels=True", "case.user.user_idx=1", "attack.optim.callback=0", "seed=7"],
    4: ["case=2_single_imagenet", "attack=modern", "attack.optim.callback=0", "seed=7"],
    6: ["case=2_single_imagenet", "attack=invertinggradients", "case.user.num_data_points=4",
        "case.user.provide_labels=True", "case.user.local_diff_privacy.per_example_clipping=1.0",
        "case.user.local_diff_privacy.gradient_noise=1e-3", "attack.optim.callback=0", "seed=7"],
}
# slice 5's paths (examples/run_example.py's presets)
SLICE5 = {
    "5a": ["case=2_single_imagenet", "attack=multiscale_ghiasi"],
    "5b": ["case=6_large_batch_cifar", "attack=invertinggradients", "attack.impl.grad_accum=10"],
    "5b'": ["case=6_large_batch_cifar", "attack=invertinggradients", "attack.impl.grad_accum=1"],
    "5c": ["case=5_small_batch_imagenet", "attack=seethroughgradients", "case.data.partition=unique-class",
           "case.user.num_data_points=1", "case.server.provide_public_buffers=False",
           "case.user.provide_buffers=True"],
}
# slice 7's fishing paths (examples/run_example.py's presets)
SLICE7 = {
    "7c": ["case=5_small_batch_imagenet", "attack=clsattack", "case/server=malicious-fishing",
           "case.user.provide_labels=True", "case.user.num_data_points=8"],
    "7d": ["case=2_single_imagenet", "attack=clsattack", "case/server=malicious-fishing",
           "case.data.partition=unique-class", "case.user.num_data_points=50", "case.user.user_idx=1",
           "case.user.provide_labels=True", "case.server.target_cls_idx=0"],
}
# slice 12's text paths (examples/run_example.py's presets)
SLICE12 = {
    "12a": ["case=10_causal_lang_training", "attack=tag"],
    "12b": ["case=10_causal_lang_training", "attack=permutation"],
    "12c": ["case=10_causal_lang_training", "attack=deepleakage", "case.user.provide_labels=False"],
    "12d": ["case=9_bert_training", "attack=tag"],
    "12e": ["case=10_causal_lang_training", "attack=tag", "case.model=gpt2"],
    "12e'": ["case=10_causal_lang_training", "attack=permutation", "case.model=gpt2", "case.user.num_data_points=8",
             "case.data.default_clients=1000"],
}
# slice 13's paths (examples/run_example.py's presets; 13c on the port's own gpt2)
DECEPTICON = ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
              "case.user.user_idx=1"]
TEXT_IMPRINT = ["case=10_causal_lang_training", "attack=imprint", "case.user.num_data_points=128",
                "case.user.user_idx=1", "case.data.default_clients=1000", "case.server.model_modification.num_bins=512"]
PMOD = "case.server.param_modification"
# decepticons_gpt2's (and decepticons_hf_gpt2's) overrides but the model: 8 x 512
GPT2_DECEPTICON = DECEPTICON + ["case.user.num_data_points=8", "case.data.shape=[512]", "case.data.batch_size=8",
                                "case.data.default_clients=1000", f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8",
                                f"{PMOD}.measurement_scale=1e6", f"{PMOD}.softmax_skew=1e8",
                                "attack.token_strategy=embedding-norm", "attack.embedding_token_weight=0.25"]
SLICE13 = {
    "13a": DECEPTICON + ["case.user.num_data_points=8", "case.data.batch_size=8", "case.data.default_clients=1000"],
    "13b": ["case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer",
            "case.model=bert-base-uncased", "case.user.num_data_points=1", "case.user.user_idx=1",
            "case.data.shape=[512]"],
    "13c": GPT2_DECEPTICON + ["case.model=gpt2"],
    "13d": TEXT_IMPRINT + ["case/server=malicious-model-rtf", "case.server.model_modification.linfunc=randn"],
    "13e": TEXT_IMPRINT + ["case/server=malicious-model-cah", "case.server.model_modification.sigma=0.5",
                           "case.server.model_modification.mu=0",
                           "case.server.model_modification.scale_factor=0.999"],
}
# slice 14's paths (examples/run_example.py's presets on the HuggingFace architectures)
COLA = ["case=9_bert_training", "case/data=cola", "case.data.task=classification", "case.data.default_clients=1000"]
SLICE14 = {
    "14a": GPT2_DECEPTICON + ["case.model=gpt2S"],
    "14b": GPT2_DECEPTICON + ["case.model=hf-gpt2"],
    "14c": ["case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer", "case.model=hf-bert",
            "case.user.num_data_points=1", "case.data.shape=[512]", "case.user.user_idx=1",
            f"{PMOD}.reset_embedding=True", f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e8",
            f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm", "attack.exact_supplement=True",
            "attack.collision_recovery=True", "attack.exact_refinement=2", "attack.embedding_token_weight=0.8"],
    "14d": ["case=10_causal_lang_training", "attack=tag", "case.model=hf-roberta-base", "case.data.task=masked-lm"],
    "14d'": ["case=9_bert_training", "attack=tag", "case.model=hf-distilbert"],
    "14e": COLA + ["attack=tag", "case.model=hf-bert", "case.user.num_data_points=2"],
    "14f": ["case=10_causal_lang_training", "attack=permutation", "case.model=hf-gpt2", "case.user.num_data_points=8",
            "case.data.default_clients=1000", "attack.token_strategy=embedding-norm"],
}
# slice 15's paths: robbing_the_fed under handle_preceding_layers=VAE (the server trains its
# decoder), tag on case 10 under the fedAVG user and the silo (8 users x 4 sentences), and on gpt2
RTF = ["case=2_single_imagenet", "attack=imprint", "case/server=malicious-model-rtf",
       "case.server.model_modification.handle_preceding_layers=VAE", "case.server.has_external_data=True"]
TEXT_FEDAVG = ["case=10_causal_lang_training", "attack=tag", "case/user=local_updates"]
TEXT_SILO = ["case=10_causal_lang_training", "attack=tag", "case/user=multiuser_aggregate", "case.user.user_range=[0,8]",
             "case.user.num_data_points=4"]
SLICE15 = {
    "15a": RTF,
    "15b": RTF + ["case.server.model_modification.position=2", "case.server.model_modification.num_bins=64"],
    "15c": TEXT_FEDAVG,
    "15d": TEXT_SILO,
    "15d'": TEXT_SILO + ["case.user.num_local_updates=2", "case.user.num_data_per_local_update_step=2"],
    "15e": TEXT_FEDAVG + ["case.model=gpt2", "case.user.num_data_points=1", "case.user.num_local_updates=2"],
}
# slice 16: slice 2 fused under the precision knobs
SLICE16 = {
    "16a": SLICES[2] + ["attack.objective.type=fused-cosine-similarity", "attack.impl.dtype=bfloat16"],
    "16a'": SLICES[2] + ["attack.objective.type=fused-cosine-similarity", "case.impl.dtype=bfloat16"],
    "16a''": SLICES[2] + ["attack.objective.type=fused-cosine-similarity", "attack.impl.dtype=float16"],
    "16b": SLICES[2] + ["attack.objective.type=fused-cosine-similarity", "case.impl.dtype=float64"],
    "16c": SLICES[2] + ["attack.objective.type=fused-cosine-similarity", "attack.impl.mixed_precision=True"],
}
# the paths without steps
READOUTS = {**SLICE13, **{p: SLICE14[p] for p in ("14a", "14b", "14c")}, **{p: SLICE15[p] for p in ("15a", "15b")}}
# slice 17: the trainer's materialized epoch at chip_smoke.py's 17a settings
SLICE17 = ["case=1_single_image_small"]
TRAIN17 = dict(limit=4096, batch_size=128, device_aug=1, epochs=3)
FUSED = ["attack.objective.type=fused-cosine-similarity"]
# slice 4 --lbfgs: the deep_leakage preset with the fused euclidean objective (path 4a')
LBFGS = ["case=1_single_image_small", "attack=deepleakage", "case.user.provide_labels=False",
         "attack.objective.type=fused-euclidean", "attack.optim.callback=0", "seed=7"]


def _attack(overrides, iterations, fleet=1):
    cfg = breaching.get_config(overrides + [f"attack.optim.max_iterations={iterations}"])
    setup = breaching.utils.system_startup(cfg=cfg)
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    if fleet == 1:
        shared_data, payloads, _ = server.run_protocol(user)
        return lambda: attacker.reconstruct(payloads, shared_data, server.secrets)
    payload_lists, shared_lists = [], []
    for idx in range(fleet):
        cfg.case.user.user_idx = idx
        shared_data, payloads, _ = server.run_protocol(
            breaching.cases.construct_user(model, server.loss, cfg.case, setup))
        payload_lists.append(payloads)
        shared_lists.append(shared_data)
    return lambda: attacker.reconstruct_fleet(payload_lists, shared_lists, server.secrets)


def _timed(run):
    """(milliseconds of ``run()``, what it returned)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3, result


def _readout_path(overrides):
    """One run of a path without attack steps (slices 13, 14a-c, 15a-b) through the entry
    points: its seconds by part (the server's includes training a decoder on 15a-b), the
    readout's stages and the report's token accuracy, or PSNR and SSIM."""
    from . import native

    seconds = {}

    def part(name, run):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return result

    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg)
    user, server, _, _ = part("server", lambda: breaching.cases.construct_case(cfg.case, setup))
    shared, payloads, true = part("user_gradient", lambda: server.run_protocol(user))
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    native.capacitated_assignment.seconds = 0.0
    rec, stats = part("readout", lambda: attacker.reconstruct(payloads, shared, server.secrets))
    metrics = breaching.analysis.report(rec, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
    quality = {k: metrics[k] for k in ("token_acc", "accuracy", "psnr", "ssim") if k in metrics}
    return dict(seconds=seconds, readout_stages=dict(stats.get("decepticon_seconds", {})),
                solver_seconds=native.capacitated_assignment.seconds, **quality, model=cfg.case.model,
                data=list(true["data"].shape))


def profile_readout(path):
    """A path without steps: a warm-up run, a timed run, a profiled run; one JSON line."""
    overrides = READOUTS[path] + ["seed=7"]
    _readout_path(overrides)
    torch.cuda.reset_peak_memory_stats()
    wall_ms, timed = _timed(lambda: _readout_path(overrides))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = _timed(lambda: _readout_path(overrides))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), slice=int(path[:2]), path=path, **timed, peak_memory_gib=peak / 2**30,
        wall_ms=wall_ms, profiled_ms=profiled_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        launches=sum(e.count for e in kernels),
        top_kernels_us={e.key[:90]: e.self_device_time_total for e in top})))


def profile_trainer():
    """Slice 17: one epoch of the trainer's materialized path on the card after a warm-up
    epoch, timed with the profiler off and under it; one JSON line per step of the epoch."""
    from .attacks.auxiliaries.optimizers import make_schedule
    from .cases.data.data_preparation import construct_dataloader
    from .train_model import TRAIN_DEFAULTS, DeviceSplit, _materialize_vision, make_optimizer, materialized_epoch

    tr = dict(TRAIN_DEFAULTS, **TRAIN17)
    cfg = breaching.get_config(SLICE17)
    cfg.case.data.examples_from_split, cfg.case.data.partition = "training", "none"
    setup = breaching.utils.system_startup(device="cuda")
    device = setup["device"]
    dataset = construct_dataloader(cfg.case.data, cfg.case.impl, 0, return_full_dataset=True).dataset
    dataset = dataset.subset(np.arange(tr["limit"]))
    split = DeviceSplit(*_materialize_vision(dataset), dataset.mean, dataset.std, torch.float32, device)
    model, loss_fn = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    model.to(device)
    optimizer = make_optimizer(model, tr)
    steps = len(split) // tr["batch_size"]
    schedule = make_schedule(tr["lr"], "cosine-decay", 0, tr["epochs"] * steps)
    rng = np.random.default_rng(0)
    position = [0]

    def epoch():
        idxs = torch.as_tensor(rng.permutation(len(split))[: steps * tr["batch_size"]].reshape(steps, -1),
                               device=device)
        loss_sum, position[0] = materialized_epoch(model, loss_fn, optimizer, schedule, position[0], split, idxs,
                                                   True, 0.0, torch.Generator(device=device).manual_seed(position[0]))
        return float(loss_sum) / steps

    epoch()  # warm-up: cuDNN's heuristics, the optimizer's state
    torch.cuda.reset_peak_memory_stats()
    wall_ms, loss = _timed(epoch)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = _timed(epoch)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), slice=17, model=cfg.case.model, batch=tr["batch_size"],
        images=len(split), steps=steps, mean_loss=loss, peak_memory_gib=peak / 2**30, ms_per_step=wall_ms / steps,
        images_per_s=steps * tr["batch_size"] / wall_ms * 1e3, profiled_ms_per_step=profiled_ms / steps,
        device_busy_ms_per_step=busy_ms / steps, idle_share=1.0 - busy_ms / wall_ms,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels_us_per_step={e.key[:90]: e.self_device_time_total / steps for e in top})))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slice", type=int, choices=sorted([*SLICES, 5, 7, 12, 13, 14, 15, 16, 17]), default=1)
    parser.add_argument("--path", choices=sorted([*SLICE5, *SLICE7, *SLICE12, *SLICE13, *SLICE14, *SLICE15,
                                                  *SLICE16]),
                        default=None, help="slice 5's path (default 5a), slice 7's (default 7c), slice 12's (default "
                                           "12a), slice 13's (default 13a), slice 14's (default 14a), slice 15's "
                                           "(default 15a) or slice 16's (default 16a)")
    parser.add_argument("--fleet", type=int, default=1, help="experiments through reconstruct_fleet")
    parser.add_argument("--fused", action="store_true", help="slice 2 or 3 with the fused cosine objective")
    parser.add_argument("--lbfgs", action="store_true", help="slice 4: deep_leakage with fused euclidean, L-BFGS")
    parser.add_argument("--iterations", type=int, default=None, help="steps (default 200; 20 with --lbfgs)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device.")
    if args.lbfgs and args.slice != 4:
        parser.error("--lbfgs is a path of slice 4.")
    if args.slice == 17:
        return profile_trainer()
    paths = {5: SLICE5, 7: SLICE7, 12: SLICE12, 13: SLICE13, 14: SLICE14, 15: SLICE15, 16: SLICE16}.get(args.slice)
    if paths is not None:
        args.path = args.path or min(paths)
        if args.path not in paths:
            parser.error(f"--path {args.path} is not a path of slice {args.slice}.")
    if args.path in READOUTS:
        return profile_readout(args.path)
    if paths is not None:
        overrides = paths[args.path] + ["attack.optim.callback=0", "seed=7"]
    else:
        overrides = LBFGS if args.lbfgs else SLICES[args.slice] + (FUSED if args.fused else [])

    cfg = breaching.get_config(overrides)
    lbfgs = cfg.attack.optim.optimizer.lower() == "l-bfgs"
    _attack(overrides, 5 if lbfgs else 20, args.fleet)()  # warm-up: kernel build, cuDNN heuristics
    iterations = args.iterations or (10 if args.path == "12c" else 20 if lbfgs or args.path == "16b" else 200)
    run = _attack(overrides, iterations, args.fleet)
    wall_ms, (_, stats) = _timed(run)
    steps = len(stats["Trial_0_Val"])  # on 5a, the iterations of every stage
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms, _ = _timed(run)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    # the port's kernels by name, without the return type that templates carry
    port = {e.key.removeprefix("void ").split("(")[0]: e for e in kernels if "breaching::" in e.key}
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), slice=args.slice, path=args.path if paths is not None else None,
        fleet=args.fleet, objective=cfg.attack.objective.type, optimizer=cfg.attack.optim.optimizer,
        model=cfg.case.model, iterations=steps,
        evaluations_per_step=stats.get("objective_evaluations", steps) / steps,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        ms_per_step=wall_ms / steps, profiled_ms_per_step=profiled_ms / steps,
        device_busy_ms_per_step=busy_ms / steps, idle_share=1.0 - busy_ms / wall_ms,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels_us_per_step={e.key[:90]: e.self_device_time_total / steps for e in top},
        port_kernels_us_per_step={k: e.self_device_time_total / steps for k, e in port.items()},
        port_launches_per_step={k: e.count / steps for k, e in port.items()})))


if __name__ == "__main__":
    main()
