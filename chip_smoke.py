#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from any directory; needs one CUDA device

Phases, one line each on standard output:
  1. the card, as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives it;
  2. the kernels' build with ``nvcc`` (breaching_tpu_torch/ops/_build.py) into the
     ops of ``torch.ops.breaching``, with its seconds;
  3. each kernel against its plain PyTorch version on the card, at every slice's
     shapes and at ragged shapes, with the tolerance stated (the fused
     kernels bit for bit, NaN positions included; the fused Adam step's soft
     sign, whose tanhf need not round as PyTorch's tanh, to a stated
     tolerance; ``fused_euclidean``, B1 and ``b2_axpby``, against its plain
     version at ConvNet-64's 2,904,970 entries): B1 and the fused cosine
     backward also at ResNet-18's 11,380,173 gradient entries, the fused Adam
     step also at 1x3x224x224, at slice 3's 4x3x224x224 and in its trials form on
     the fleet's 8x1x3x224x224 stack and the restarts' 4x1x3x32x32 (one launch, each
     trial bit for bit its own single call's), the fused cosine backward's trials
     form on the restarts' 4 rows of 2,904,970 (one launch, each row bit for bit its
     own call's), the fused TV kernel also at 1x3x224x224 and
     4x3x224x224, with NaN and infinite pixels at the boundary, twice in a row
     and in a replayed CUDA graph; for slice 5 the fused TV kernel and the fused
     Adam step at 100x3x32x32 (5b) and 1x3x96x96 (a stage of 5a), TV also at
     1x3x192x192; the fused TV kernel's trials form, one launch for every trial
     of 8x1x3x224x224 (p = q = 1) and 8x1x6x224x224 (p = 2, q = 0.5) stacks,
     against the plain version per trial and bit for bit against single-trial
     calls; the rebuilt box clamp bit for bit, out of place and in place,
     at 1x3x32x32 and 4x3x224x224, 4 bytes off a 16-byte boundary and at a
     width that is not a multiple of 4, with NaN, infinities and values on the
     bounds;
  4. the attack gradient of each slice on the card against the same computation
     on the CPU, through the plain versions (and whether the card gives the same
     bits twice, which is reported, not required); for slice 3 the gradient
     through the fedAVG user's four unrolled local steps; for slice 4 the
     gradient of ``deep_leakage`` (data and label logits), ``wei_framework`` and
     ``modern_hyperparams``; for slice 5 the multiscale attack's at a 96x96
     stage (one draw of its augmentation, the same on both) and
     ``see_through_gradients``' on ResNet-50 at 224; for 5b the gradient of its
     objective on 100 images through grad_accum=10 against grad_accum=1 in
     float64 on the card, and float32 on the card and on the CPU against that;
     for slice 7 the user's gradient through 7a's imprinted ResNet-18 at 224 (to 1e-4
     of its largest entry) and the readout's images where both pick the same bins
     (else both selections, printed), and 7c's gradient of 8 images through
     ResNet-50's class-poisoned head (1e-4) with the class's feature (1e-3);
  5. the main paths end to end through the entry points, each with the kernels'
     launch counts set to 0 just before it and read just after: slice 1,
     Inverting Gradients with the fused cosine objective on ConvNet-64 /
     CIFAR-10 shapes, and the same with 4 restarts (the batched trial step: the
     fused TV kernel, the cosine backward and the Adam step once a step for all
     four, B1 once a trial); slice 2, the bench preset on
     ResNet-18 at ImageNet shapes
     (the repo's trained checkpoint where the checkout holds it, else random
     weights, printed either way) solo, the same with the fused cosine
     objective, and as the 8-experiment fleet through ``reconstruct_fleet`` (the
     fused TV kernel and the Adam step once a step for the 8);
     slice 3, the fedAVG user of case 4 on the same ResNet-18 (4 images of
     3x224x224, 4 local SGD steps of 2 images, the JAX package's notebook preset
     ``inverting_gradients_fedavg_imagenet``), with the preset's cosine objective
     and with the fused one; slice 4, the JAX package's other named optimization
     presets (examples/run_example.py): ``deep_leakage`` (the joint attack of data
     and label logits with L-BFGS), the same with the fused euclidean objective,
     ``wei_framework`` and ``beyond_inferring`` on ConvNet-64 (20 outer L-BFGS
     steps each), ``modern_hyperparams`` and ``legacy_hyperparams`` on ResNet-18
     (200 steps each); slice 5, the remaining vision presets: 5a ``multiscale``
     (ResNet-18 on its checkpoint at 224, seven stages 32, 64, ..., 224 of 50
     steps), 5b ``inverting_large_batch_cifar`` (ResNet32-10 on 100 images of
     CIFAR-100's shape with grad_accum=10, 50 steps) and 5b' (the same with
     grad_accum=1, 5 steps, for the peak memory, which grad_accum=10 must
     lower), 5c ``see_through_gradients`` (ResNet-50 on the checkout's
     ResNet50.npz, which it must hold, at 224, 200 steps), 5d
     ``inverting_gradients_fedavg``, ``inverting_gradients_fedavg_cifar`` and
     ``inverting_gradients_resnet18`` (50 steps each); slices 1 and 2 solo take
     1,000 and 200 steps; slice 6, the honest server's remaining configuration
     surface: 6a the fedSGD user with per-example clipping (C = 1) and Laplace
     gradient noise on ResNet-18 at 224 (the checkpoint, 4 images, 200 steps),
     where every clipped per-example norm is at most C (1 + 1e-5) and, with
     the noise off, the clipped gradient on the card equals the CPU's to
     1e-12 of its largest entry in float64 and to 1e-4 in float32; 6b the server's model states ``linearized``,
     ``orthogonal`` (every kernel orthonormal to 1e-4 on the card) and
     ``untrained``, 50 steps each; 6c case 4's fedAVG user with its batch
     gradient clipped and noised at every local step (50 steps); 6d
     ``wainakh-whitebox`` labels on ConvNet-64, CIFAR-10, 4 images, equal to
     the CPU's (50 steps); 6e a checkpointed run of 101 steps and a fresh
     attacker resumed from its file of step 100: the restored state bit for
     bit, its loss to 1e-6 and its one step to 1e-6 but for 1e-4 of the
     entries; 6f the Chrome trace that ``trace_dir`` writes of one chunk of
     slice 1, which must name the path's four kernels; slice 7, the malicious servers'
     vision presets through ``main_process``: 7a ``robbing_the_fed`` (an imprint block of
     64 bins in front of ResNet-18 on its checkpoint, one image at 224, which the readout
     must recover to MSE < 5e-2 in normalized space and PSNR > 25 dB), 7a' the same with
     16 images (the images recovered, beside ``imprint_guarantee``'s expectation), 7b
     ``curious_abandon_honesty`` (ConvNet-64, CIFAR-10), 7c ``fishing`` (ResNet-50 on its
     checkpoint, 8 images) and 7d ``fishing_optimization_unique`` (ResNet-18, 50 images
     of one class, so that the binary attack runs: more than 2 user queries; each cutoff
     query and the images behind the final gradient printed), 200 attack steps each with
     the fused TV and Adam step once a step, 7d'' 7d's one-shot search alone at the JAX
     package's test's feat_multiplier of 30000, which must take at least two cutoff queries
     and leave fewer than the 50 images behind the final gradient, 7e ``sanity_check`` (the
     ``linear`` model on ImageNet shapes, exact to MSE < 1e-6); 7a, 7a', 7b and 7e launch
     no port kernel; slice 10, the full report and the run's records: the port's
     ``benchmark_breaches`` on case 2 (ResNet-18 on its checkpoint at 224) as one wave of
     8 users, 50 steps of the fused cosine objective (B1 once a step for each user, the
     cosine backward, the fused TV kernel and the Adam step once a step for all 8), every
     user reported with ``compute_full_iip=True`` and LPIPS on random AlexNet weights from
     ``LPIPS.random_init``: a report of every key of the JAX package's for each of the 8
     users (a user's failure fails the phase), registered PSNR at least the PSNR, the
     benchmark table of 8 rows and the averaged row, 8 PNGs of 224x224x3 holding the
     reconstructions' pixels, the report's seconds per user and in its registered PSNR,
     DTCWT CW-SSIM, LPIPS and IIP, and user 7's report held against the same tensors'
     report on the CPU (the CPU tests' tolerances; registered PSNR to 0.1 dB), and every
     user's registered PSNR registered again on the card and on the CPU in float32 and
     float64 (the card held to the CPU's float32 to 0.1 dB); then ``simulate_breach`` on
     slice 1 (100 steps) with ``save_reconstruction=True``, whose table row, metrics YAML
     (read back to the metrics) and PNG it checks; for each: set-up
     seconds, loss at the start and end of every trial, PSNR and SSIM (of the
     batch put in the true images' order, and the order), it/s (the fleet's aggregate; with L-BFGS also the
     objective's evaluations per second), peak memory and launches per step;
  6. each kernel's time beside its bound, the plain version's time and one
     PyTorch call of the same function (for a fused kernel, the library call of
     the kernel it grew from), each as time per call (200 calls between two
     events), device time (``timing.time_ms``: the calls captured in a CUDA
     graph and replayed, each after a read of 100 MB that evicts its operands
     from the 50 MB L2, whose time is subtracted; and warm, back to back), and
     host time per call (the 200 calls enqueued, no wait); B1, the fused
     cosine backward, the fused TV kernel and the fused Adam step also at
     slice 2's shapes (100 calls), the fused TV kernel and the fused Adam step
     at slice 3's (100 calls), the fused Adam step's soft sign at 1x3x224x224
     and the fused TV kernel at 1x6x224x224 (slice 4's double opponents), the
     fused TV kernel and the fused Adam step at slice 5's 100x3x32x32 and
     1x3x96x96, TV at 1x3x192x192 (100 calls); the box clamp also in place (the
     form slices 4b-c call) beside ``torch.clamp(out=)``; each form of the box clamp
     and ``b2_axpby`` (beside ``torch.add(alpha=)``, at 2,904,970 entries), the
     fused Adam step (beside ``torch.clamp``) and the fused cosine backward (beside
     ``torch.add(alpha=)``) timed in turns with its library call over five rounds
     (medians); the fused Adam step also beside ``torch._fused_adam_`` on one tensor
     of the candidate's shape, where the installed torch has it; the trials forms
     of the fused TV kernel and the fused Adam step at 8x1x3x224x224 and of the
     fused cosine backward at 4 rows of 2,904,970, each beside its T single calls;
     the launch of ``b2_axpby``, the fused cosine backward, the fused TV kernel and
     the fused Adam step at the paths' shapes (registers, blocks resident per SM,
     grid) and the host time of every kernel's wrapper split into its Python
     wrapper and its dispatcher op; and which device times, if any, come in under
     their bound.
Then one JSON line with the kernels, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, without that line, when no CUDA device is present, a kernel does
not build, launch or agree, a kernel of a path was not launched as often as the
path needs (on slice 4's L-BFGS paths: B1 and ``b2_axpby`` once per evaluation of
the objective, TV once per evaluation, ``b4_box_project`` once per outer step; on the
fleet and the restarts, TV and the Adam step once a step for every trial, and on the
restarts the cosine backward too), an
attack's loss does not fall (on slice 4: its best value stays at its first, or a
loss is not finite; on slice 5a: a stage's), an experiment of the fleet does not
keep its own labels, a batch's order is not a permutation, or a check of slice 6
or slice 10 fails. A loss that turns non-finite fails every path but the fedAVG users' (slices
3, 5d and 6c): there the simulated local SGD of the fedAVG user can overflow float32 on the attack's candidates, as it does in the
JAX package, and the attack stops at such a candidate. The same local steps at
that candidate, in float64 on the CPU, must then reach a magnitude above 1e30
(float32 overflows in sums of such terms), which the script prints beside the
magnitude on the user's own images.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ITERATIONS = 1000
DEVICE = "cuda"
SLICE = ["case=1_single_image_small", "attack=invertinggradients",
         "attack.objective.type=fused-cosine-similarity"]
# slice 2: the JAX package's bench.py preset (ResNet-18, ImageNetAnimals shapes)
SLICE2 = ["case=2_single_imagenet", "attack=invertinggradients", "attack.restarts.num_trials=1",
          "case.user.provide_labels=True", "seed=7"]
SLICE2_STEPS, SLICE2_FUSED_STEPS, FLEET, FLEET_STEPS = 200, 100, 8, 100
RESTARTS, RESTART_STEPS = 4, 100  # slice 1's restarts: the batched trial step on ConvNet-64
# slice 3: the fedAVG user of case 4 on ResNet-18, the JAX package's notebook preset
# inverting_gradients_fedavg_imagenet (examples/run_example.py)
SLICE3 = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
          "case.user.provide_labels=True", "case.user.user_idx=1", "seed=7"]
SLICE3_STEPS, SLICE3_FUSED_STEPS = 100, 50
# slice 4: the JAX package's other named optimization presets (examples/run_example.py):
# path -> (overrides, steps, the launches per step or per objective evaluation it needs)
CASE1 = ["case=1_single_image_small", "seed=7"]
SLICE4 = {
    "slice 4a deep_leakage": (CASE1 + ["attack=deepleakage", "case.user.provide_labels=False"], 20, {}),
    "slice 4a' deep_leakage fused": (CASE1 + ["attack=deepleakage", "case.user.provide_labels=False",
                                              "attack.objective.type=fused-euclidean"], 20,
                                     dict(b1_matching_sums="evaluation", b2_axpby="evaluation")),
    "slice 4b wei_framework": (CASE1 + ["attack=wei"], 20, dict(b4_box_project="step")),
    "slice 4c beyond_inferring": (CASE1 + ["attack=beyondinfering", "case.data.partition=unique-class",
                                           "case.user.user_idx=1",
                                           "attack.regularization.total_variation.scale=1e-4"], 20,
                                  dict(b3_tv_value_and_grad="evaluation", b4_box_project="step")),
    "slice 4d modern_hyperparams": (["case=2_single_imagenet", "attack=modern", "seed=7"], 200,
                                    dict(b3_tv_value_and_grad="step", b4_adam_box_step="step")),
    "slice 4e legacy_hyperparams": (["case=2_single_imagenet", "attack=legacy", "seed=7"], 200,
                                    dict(b3_tv_value_and_grad="step", b4_adam_box_step="step")),
}
OPPONENTS = (1, 6, 224, 224)  # slice 4d-e's TV input: three channels and their three differences
# slice 5: the JAX package's remaining vision presets (examples/run_example.py), seed 7:
# path -> (overrides, steps (per stage on 5a), the launches per step each kernel needs)
IMAGE_KERNELS = dict(b3_tv_value_and_grad=1, b4_adam_box_step=1)
FEDAVG = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
          "case.user.provide_labels=True", "seed=7"]
LARGE_BATCH = ["case=6_large_batch_cifar", "attack=invertinggradients", "seed=7"]
SEE_THROUGH = ["case=5_small_batch_imagenet", "attack=seethroughgradients", "case.data.partition=unique-class",
               "case.user.num_data_points=1", "case.server.provide_public_buffers=False",
               "case.user.provide_buffers=True", "seed=7"]
MULTISCALE = ["case=2_single_imagenet", "attack=multiscale_ghiasi", "seed=7"]
SLICE5 = {
    "slice 5a multiscale": (MULTISCALE, 50, IMAGE_KERNELS),
    "slice 5b inverting_large_batch_cifar": (LARGE_BATCH + ["attack.impl.grad_accum=10"], 50, IMAGE_KERNELS),
    "slice 5b' grad_accum=1": (LARGE_BATCH + ["attack.impl.grad_accum=1"], 5, IMAGE_KERNELS),
    "slice 5c see_through_gradients": (SEE_THROUGH, 200, IMAGE_KERNELS),
    "slice 5d inverting_gradients_fedavg": (FEDAVG + [
        "case/data=CIFAR10", "case.data.partition=random", "case.model=ResNet18", "case.server.pretrained=False",
        "case.user.user_idx=1", "attack.regularization.total_variation.scale=1e-3"], 50, IMAGE_KERNELS),
    "slice 5d inverting_gradients_fedavg_cifar": (FEDAVG + ["case/data=CIFAR10", "case.model=ConvNet"], 50,
                                                  IMAGE_KERNELS),
    "slice 5d inverting_gradients_resnet18": (["case=2_single_imagenet", "attack=invertinggradients", "seed=7"], 50,
                                              IMAGE_KERNELS),
}
# slice 6: the honest server's remaining configuration surface, ResNet-18 at 224 on its
# checkpoint, 4 images with their labels (6a-6c, 6e), ConvNet-64 for the labels (6d)
LDP = "case.user.local_diff_privacy"
SLICE6 = ["case=2_single_imagenet", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.provide_labels=True", "seed=7"]
CLIP = 1.0
DP = [f"{LDP}.per_example_clipping={CLIP}", f"{LDP}.gradient_noise=1e-3", f"{LDP}.distribution=laplacian"]
SLICE6_STEPS, STATE_STEPS, RESUME_STEPS = 200, 50, 100
WAINAKH = ["case=1_single_image_small", "attack=invertinggradients", "case.user.num_data_points=4",
           "case.user.provide_labels=False", "attack.label_strategy=wainakh-whitebox", "seed=7"]
# slice 7: the malicious servers' vision presets (examples/run_example.py), seed 7:
# path -> (overrides, attack steps (0: an analytic attack), the launches per step it needs)
RTF = ["case=2_single_imagenet", "attack=imprint", "case/server=malicious-model-rtf", "seed=7"]
FISHING = ["case=5_small_batch_imagenet", "attack=clsattack", "case/server=malicious-fishing",
           "case.user.provide_labels=True", "case.user.num_data_points=8", "seed=7"]
FISHING_UNIQUE = ["case=2_single_imagenet", "attack=clsattack", "case/server=malicious-fishing",
                  "case.data.partition=unique-class", "case.user.num_data_points=50", "case.user.user_idx=1",
                  "case.user.provide_labels=True", "case.server.target_cls_idx=0", "seed=7"]
SLICE7_STEPS = 200
# the feature multiplier of the JAX package's binary-attack test (tests/test_binary_attack.py):
# an image then leaves the subset where its feature exceeds the cutoff by 1000 / 30000,
# where the preset's 300 lets it leave only 1000 / 300 above it. The bias multiplier
# stays the preset's: at the test's 0 the class attack's head saturates on ResNet-18's
# features, and its feature estimate is 0.
SHARP = ["case.server.feat_multiplier=30000"]
SLICE7 = {
    "slice 7a robbing_the_fed": (RTF, 0, {}),
    "slice 7a' robbing_the_fed 16 images": (RTF + ["case.user.num_data_points=16"], 0, {}),
    "slice 7b curious_abandon_honesty": (["case=1_single_image_small", "attack=imprint",
                                          "case/server=malicious-model-cah", "seed=7"], 0, {}),
    "slice 7c fishing": (FISHING, SLICE7_STEPS, IMAGE_KERNELS),
    "slice 7d fishing_optimization_unique": (FISHING_UNIQUE, SLICE7_STEPS, IMAGE_KERNELS),
    "slice 7e sanity_check": (["case=0_sanity_check", "attack=analytic", "seed=7"], 0, {}),
}
# a recovered image of 7a': the readout of a bin that held it alone, exact up to float32
RECOVERED_PSNR = 40.0
STAGE = (1, 3, 96, 96)  # a stage of 5a's pyramid (32, 64, ..., 224) that slices 1-4 do not run
STAGE2 = (1, 3, 192, 192)
LARGE = (100, 3, 32, 32)  # 5b's candidate: 100 CIFAR-100 images
CHECKPOINT50 = os.path.join(REPO, "assets", "checkpoints", "ResNet50.npz")
# a magnitude in the fedAVG user's local SGD (in float64) that shows float32 overflow:
# sums of such terms in a convolution's backward leave float32 (largest value 3.4e38)
DIVERGED = 1e30
CHECKPOINT = os.path.join(REPO, "assets", "checkpoints", "ResNet18.npz")
# slice 10: the full report and the run's records, through the port's benchmark_breaches on
# case 2 (ResNet-18 at 224 on its checkpoint) as one wave of 8 users, 50 steps of the fused
# cosine objective, every user reported with its IIP scores and LPIPS (random weights from
# the port's own LPIPS.random_init); then simulate_breach's records on slice 1
BENCHMARK = ["case=2_single_imagenet", "attack=invertinggradients", "attack.objective.type=fused-cosine-similarity",
             "num_trials=8", "fleet=8", "attack.optim.max_iterations=50", "attack.optim.callback=25",
             "save_reconstruction=True", "seed=7", "name=fleet"]
BENCHMARK_USERS, BENCHMARK_STEPS, RECORDS_STEPS = 8, 50, 100
REPORT_KEYS = ("mse", "psnr", "ssim", "cw_ssim", "gabor_cw_ssim", "rpsnr", "max_mse", "lpips", "order", "IIP-pixel",
               "IIP-lpips", "IIP-self", "label_acc", "feat_mse", "parameters")
# one user's report on the card against the same tensors' on the CPU, at the tolerances the
# CPU tests hold the port to the JAX package (tests/test_torch_metrics_full.py): relative,
# absolute for the indices in [-1, 1], and exact for the IIP, the labels and the count.
# Registered PSNR runs 500 Adam steps of registration on each side, and float32 rounding
# moves where they end: on the H100 user 7 of BENCHMARK ended 0.028 dB from the CPU (the card
# 0.033 dB and the CPU 0.0055 dB from the CPU's float64 registration), past a first 1e-3 dB.
# Held to 0.1 dB; check_rpsnr_of_every_user prints each user's gaps to the CPU and float64
REPORT_RELATIVE = dict(mse=1e-5, psnr=1e-5, max_mse=1e-5, lpips=1e-5, feat_mse=1e-4)
REPORT_ABSOLUTE = dict(ssim=1e-5, cw_ssim=1e-5, gabor_cw_ssim=1e-5)
RPSNR_TOLERANCE = 0.1
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNELS = {  # name -> (source, what it replaces in the JAX package)
    "b1_matching_sums": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:83"),
    "b2_axpby": ("breaching_tpu_torch/csrc/matching.cu", "breaching_tpu/ops/matching.py:104"),
    "b2_cosine_backward": ("breaching_tpu_torch/csrc/matching.cu",
                           "breaching_tpu/ops/matching.py:104 (_axpby inside _cos_bwd, :135-146)"),
    "b3_tv_forward": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:47"),
    "b3_tv_value_and_grad": ("breaching_tpu_torch/csrc/image.cu",
                             "breaching_tpu/ops/image.py:47 (_tv_kernel) with the JAX VJP "
                             "breaching_tpu/attacks/auxiliaries/regularizers.py:40-49,75-87"),
    "b4_box_project": ("breaching_tpu_torch/csrc/image.cu", "breaching_tpu/ops/image.py:75"),
    "b4_adam_box_step": ("breaching_tpu_torch/csrc/image.cu",
                         "breaching_tpu/ops/image.py:75 (_box_kernel) with the fused update chain "
                         "breaching_tpu/attacks/optimization_based_attack.py:206-217,401-466"),
}
# The kernels the slice's attack step runs; b2_axpby, b3_tv_forward and b4_box_project
# stay as the counterparts of the JAX package's _axpby, fused_total_variation and
# ops.box_project, checked and timed.
SLICE_KERNELS = ("b1_matching_sums", "b2_cosine_backward", "b3_tv_value_and_grad", "b4_adam_box_step")
BIG = (1, 3, 224, 224)  # the image batch of slice 2 (ResNet-18 at ImageNet shapes)
BATCH = (4, 3, 224, 224)  # the image batch of slice 3 (the fedAVG user's 4 images)
N2 = 11_380_173  # the gradient entries of slice 2
# the kernels timed in turns with their library call (per-call figures within 2 us of each other)
IN_TURNS = ("b2_axpby", "b4_box_project", "b4_box_project in place", "b2_cosine_backward", "b4_adam_box_step")
TURNS = 5
# (p, q) whose powers p, p-1, q, q-1 cheap_pow forms exactly: the fused TV gradient bit for bit
TV_EXACT = ((1.0, 1.0), (2.0, 1.0), (1.5, 2.0))


class CheckFailed(Exception):
    pass


def require(condition, message):
    if not condition:
        raise CheckFailed(message)


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def check_kernels(ops, n_params, image_shape):
    """Phase 3: every kernel against its plain version. Returns the largest error
    of each kernel at slice 1's shapes, and under "<name> slice2" at slice 2's."""
    from breaching_tpu_torch.ops import image, matching

    gen = torch.Generator().manual_seed(1234)
    dev = torch.device(DEVICE)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    worst = {}

    def record(name, slice_shape, err):
        """``slice_shape``: False, True (slice 1's shape) or the key to record under."""
        if slice_shape:
            key = slice_shape if isinstance(slice_shape, str) else name
            worst[key] = max(worst.get(key, 0.0), err)

    def report_exact(name, shape, got, want, slice_shape):
        """Bit for bit where not NaN (signed zeros included), NaN in the same places."""
        nan = torch.isnan(want)
        ok = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                                  want[~nan].view(torch.int32))
        err = (got[~nan] - want[~nan]).abs().max().item() if bool((~nan).any()) else 0.0
        print(f"check {name} {shape}: max_abs_err={err:.3e} tol=0 (bits, {int(nan.sum())} NaN) "
              f"{'ok' if ok else 'FAILED'}", flush=True)
        require(ok, f"{name} disagrees with its plain version at {shape}")
        record(name, slice_shape, err)

    def report(name, shape, got, want, tol, slice_shape):
        err = (got - want).abs()
        ok = bool((err <= tol).all())
        print(f"check {name} {shape}: max_abs_err={err.max().item():.3e} "
              f"tol={torch.as_tensor(tol).min().item():.3e} {'ok' if ok else 'FAILED'}", flush=True)
        require(ok, f"{name} disagrees with its plain version at {shape}")
        record(name, slice_shape, err.max().item())

    for n, offset in ((n_params, 0), (N2, 0), (1_000_003, 0), (1_000_003, 1)):
        # offset 1 starts both vectors 4 bytes into their buffers: the unaligned path
        r, d = randn(n + offset)[offset:], randn(n + offset)[offset:]
        shape = f"n={n}{' unaligned' if offset else ''}"

        def at(name, n=n, offset=offset):
            """Where this shape's error is recorded: slice 1's, slice 2's or nowhere."""
            return False if offset else n == n_params or (n == N2 and f"{name} slice2")

        got = ops.matching_sums(r, d).double()
        want = matching.matching_sums_plain(r, d).double()
        # float32 sums of n terms in two different orders: each within about
        # (terms per thread + log2 n) * 2^-24 of the sum of |terms|; 1e-5 covers both
        scale = torch.stack([(r * d).abs().double().sum(), (r * r).double().sum(), (d * d).double().sum()])
        report("b1_matching_sums", shape, got, want, 1e-5 * scale, at("b1_matching_sums"))

        a, b = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
        got, want = ops.axpby(a, r, b, d), matching.axpby_plain(a, r, b, d)
        # products and sum rounded separately in both: equal up to one rounding
        tol = 2.0 ** -23 * want.abs().max().item()
        report("b2_axpby", shape, got, want, tol, n == n_params and not offset)

        sums, upstream = ops.matching_sums(r, d), torch.tensor(0.37, device=dev)
        for wrt_data in (False, True):
            got = ops.cosine_backward(sums, upstream, r, d, wrt_data)
            want = matching.cosine_backward_plain(sums, upstream, r, d, wrt_data)
            report_exact("b2_cosine_backward", f"{shape} wrt_data={wrt_data}", got, want,
                         at("b2_cosine_backward"))
    check_cosine_trials(ops, matching, report_exact, randn, n_params)

    for shape in (image_shape, (2, 3, 331, 1007)):
        x = randn(*shape)
        slice_shape = shape == image_shape
        for p, q in ((1.0, 1.0), (2.0, 0.5)):
            got, want = ops.tv_forward(x, p, q, 1e-8), image.tv_forward_plain(x, p, q, 1e-8)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report("b3_tv_forward", f"{shape} p={p} q={q}", got, want, 1e-5 * abs(want.item()),
                   slice_shape and p == 1.0)
        lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
        hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
        for signed in (True, False):
            check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed, slice_shape)
    for shape in (image_shape, BIG, (2, 3, 331, 1007)):  # slice 4d-e's soft sign
        check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, "soft",
                            shape == BIG and "b4_adam_box_step soft", report)
    for signed in (True, False):  # slice 2: one image, and the trials form on the fleet's stack
        check_adam_box_step(ops, image, report_exact, randn, BIG, lo, hi, signed,
                            signed and "b4_adam_box_step slice2")
        check_adam_box_step(ops, image, report_exact, randn, (FLEET, *BIG), lo, hi, signed,
                            signed and "b4_adam_box_step trials")
        check_adam_box_step(ops, image, report_exact, randn, (RESTARTS, *image_shape), lo, hi, signed, False)
        check_adam_box_step(ops, image, report_exact, randn, BATCH, lo, hi, signed,
                            signed and "b4_adam_box_step slice3")
        for shape in (LARGE, STAGE):  # slice 5: 5b's 100 images, a stage of 5a's pyramid
            check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed,
                                signed and f"b4_adam_box_step slice5 {shape}")
    check_box_project(ops, image, report_exact, randn, image_shape, lo, hi)
    check_tv_value_and_grad(ops, image, report, report_exact, randn, image_shape)
    check_fused_euclidean(ops, matching, report, randn, n_params)
    return worst


def check_box_project(ops, image, report_exact, randn, image_shape, lo, hi):
    """b4_box_project against its plain version bit for bit, NaN positions included, out
    of place and in place (``out=`` its input): at the path's 1x3x32x32 and at slice 3's
    4x3x224x224 (the float4 kernel), 4 bytes off a 16-byte boundary and at a width that
    is not a multiple of 4 (the scalar kernel), with NaN, infinities and values on the
    bounds planted."""
    for shape in (image_shape, BATCH, (2, 3, 331, 1007)):
        n = math.prod(shape)
        for offset in (0, 1):
            buffer = randn(n + offset) * 2
            flat = buffer[offset:]
            flat[::97], flat[1::89], flat[2::89] = float("nan"), float("inf"), float("-inf")
            x = flat.view(shape)
            x[0, :, 0, 3], x[-1, :, -1, -1] = lo, hi  # on the bounds
            where = f"{shape}{' unaligned' if offset else ''}"
            want = image.box_project_plain(x, lo, hi)
            report_exact("b4_box_project", where, ops.box_project(x, lo, hi), want,
                         shape == image_shape and not offset)
            inplace = buffer.clone()[offset:].view(shape)
            ops.box_project(inplace, lo, hi, out=inplace)
            report_exact("b4_box_project", f"{where} in place", inplace, want, False)


def check_fused_euclidean(ops, matching, report, randn, n):
    """``fused_euclidean`` (B1 forward, ``b2_axpby`` backward) against
    ``fused_euclidean_plain`` (autograd through the plain sums), value and gradient."""
    rec, data = randn(n), randn(n) * 0.5
    upstream = torch.tensor(0.37, device=DEVICE)
    results = []
    for fn in (ops.fused_euclidean, matching.fused_euclidean_plain):
        r = rec.clone().requires_grad_(True)
        value = fn(r, data)
        grad, = torch.autograd.grad(value, r, upstream)
        results.append((value.detach(), grad))
    (value, grad), (want_value, want) = results
    sums = matching.matching_sums_plain(rec, data)
    # the value is a difference of float32 sums of n terms in two orders: 1e-5 of the sums,
    # as B1 is held; the gradient g rec - g data, rounded otherwise by autograd: 2^-22
    report("fused_euclidean (b1 + b2_axpby)", f"n={n} value", value, want_value,
           1e-5 * 0.5 * (sums[1] + sums[2]).item(), False)
    report("fused_euclidean (b1 + b2_axpby)", f"n={n} gradient", grad, want,
           2.0 ** -22 * (0.37 * (rec.abs() + data.abs())).max().item(), False)


def check_cosine_trials(ops, matching, report_exact, randn, n):
    """The fused cosine backward's trials form on slice 1's restarts: ``RESTARTS`` rows
    of n in one launch, each row with its own sums and upstream gradient, bit for bit
    against the plain version and against the kernel's single call on each row (n % 4
    = 2 at ConvNet-64's n: every other row starts 8 bytes off a 16-byte boundary)."""
    rec, data = randn(RESTARTS, n), randn(RESTARTS, n)
    sums = torch.stack([ops.matching_sums(r, d) for r, d in zip(rec, data)])
    upstream = torch.linspace(0.2, 0.9, RESTARTS, device=rec.device)
    for wrt_data in (False, True):
        before = ops.cosine_backward.launches
        got = ops.cosine_backward(sums, upstream, rec, data, wrt_data)
        launched = ops.cosine_backward.launches - before
        require(launched == 1, f"b2_cosine_backward trials: {launched} launches for one call")
        where = f"{RESTARTS}x{n} trials wrt_data={wrt_data}"
        report_exact("b2_cosine_backward", where, got, matching.cosine_backward_plain(sums, upstream, rec, data,
                                                                                      wrt_data),
                     "b2_cosine_backward trials")
        same = all(differing_bits(got[t], ops.cosine_backward(sums[t], upstream[t], rec[t], data[t], wrt_data)) == 0
                   for t in range(RESTARTS))
        print(f"check b2_cosine_backward {where}: one launch, each row equal to its own single call's bits: "
              f"{'ok' if same else 'FAILED'}", flush=True)
        require(same, f"b2_cosine_backward {where}: a row differs from its single call")


def check_tv_value_and_grad(ops, image, report, report_exact, randn, image_shape):
    """b3_tv_value_and_grad against its plain version: the gradient bit for bit for the
    exponents cheap_pow forms exactly (one rounding of the largest |value| otherwise),
    the value to 1e-5 relative; at the slice's shape, at 1x3x224x224 and at ragged
    shapes; with NaN and +-inf pixels at the boundary; repeated and graph-replayed."""
    name = "b3_tv_value_and_grad"
    scale = torch.tensor([0.2], device=DEVICE)

    def run(x, p, q):
        return ops.tv_value_and_grad(x, scale, p, q, 1e-8), image.tv_value_and_grad_plain(x, scale, p, q, 1e-8)

    for shape in (image_shape, BIG, BATCH, OPPONENTS, LARGE, STAGE, STAGE2, (2, 3, 331, 1007), (2, 3, 17, 23),
                  (1, 6, 33, 31), (1, 6, 9, 1), (1, 3, 1, 7)):
        x = randn(*shape)
        # where this shape's error is recorded: slice 1's, slice 3's, slice 5's or nowhere
        record = shape == image_shape or (shape == BATCH and f"{name} slice3") or (
            shape in (LARGE, STAGE, STAGE2) and f"{name} slice5 {shape}")
        # slice 4: p = 2, q = 0.5 on the double opponents (4d-e), q = 1.25 at 1x3x32x32 (4c)
        for p, q in TV_EXACT + ((2.0, 0.5), (2.0, 1.25)):
            if (p, q) == (2.0, 1.25) and shape != image_shape:
                continue
            (value, grad), (want_value, want) = run(x, p, q)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report(name, f"{shape} p={p} q={q} value", value, want_value, 1e-5 * abs(want_value.item()),
                   p == q == 1.0 and record)
            if (p, q) in TV_EXACT:
                report_exact(name, f"{shape} p={p} q={q} gradient", grad, want, p == q == 1.0 and record)
            else:  # q - 1 = -0.5 is rsqrtf in both; q - 1 = 0.25 is powf in the kernel, pow in PyTorch
                slice4 = (shape, q) in ((OPPONENTS, 0.5), (image_shape, 1.25)) and f"{name} slice4 {shape} q={q}"
                report(name, f"{shape} p={p} q={q} gradient", grad, want,
                       2.0 ** -22 * want.abs().max().item(), slice4)
                if shape in (image_shape, OPPONENTS):
                    print(f"check {name} {shape} p={p} q={q} gradient: {differing_bits(grad, want)} of "
                          f"{want.numel()} entries differ from the plain version's bits", flush=True)
            if shape in (image_shape, (2, 3, 331, 1007)) and (p, q) in ((1.0, 1.0), (2.0, 0.5)):
                xr = x.clone().requires_grad_(True)
                auto, = torch.autograd.grad(image.tv_forward_plain(xr, p, q, 1e-8) * 0.2, xr)
                # autograd differentiates pow and the mean by other formulas: 1e-4 relative
                report(f"{name} vs autograd", f"{shape} p={p} q={q}", grad, auto,
                       1e-4 * auto.abs().max().item(), False)

    # C1: the plain version's rolls carry a NaN to the wrapped boundary column and row
    for shape in (image_shape, (2, 3, 17, 23)):
        H, W = shape[-2:]
        places = {"last column": (H // 2, W - 1), "last row": (H - 1, W // 2), "column 0": (H // 2, 0),
                  "row 0": (0, W // 2), "corner": (H - 1, W - 1)}
        cases, nan_cases = 0, 0
        for place, (h, w) in places.items():
            for planted in (float("nan"), float("inf"), float("-inf")):
                for p, q in ((1.0, 1.0), (2.0, 1.0)):
                    x = randn(*shape)
                    x[-1, -1, h, w] = planted
                    (value, grad), (want_value, want) = run(x, p, q)
                    nan = torch.isnan(want)
                    same = torch.equal(torch.isnan(grad), nan) and torch.equal(
                        grad[~nan].view(torch.int32), want[~nan].view(torch.int32))
                    require(same, f"{name} gradient at {shape}, {planted} at the {place}, p={p} q={q}: "
                                  f"{int(torch.isnan(grad).sum())} NaN, the plain version {int(nan.sum())}")
                    require(str(value.item()) == str(want_value.item()),
                            f"{name} value at {shape}, {planted} at the {place}: {value.item()} against "
                            f"{want_value.item()}")
                    cases, nan_cases = cases + 1, nan_cases + bool(nan.any())
        print(f"check {name} {shape} non-finite pixels at the boundary: {cases} cases ({nan_cases} with NaN "
              f"in the gradient), gradient bits and NaN positions equal, values non-finite alike ok", flush=True)

    # the same bits twice; a graph replayed on new images (the partials' slots are emptied)
    x, other = randn(*BIG), randn(*BIG)
    first, second = ops.tv_value_and_grad(x, scale), ops.tv_value_and_grad(x, scale)
    wants = [first, ops.tv_value_and_grad(other, scale)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ops.tv_value_and_grad(x, scale)
    replays = []
    for source in (x.clone(), other):
        x.copy_(source)
        graph.replay()
        replays.append(tuple(t.clone() for t in static))
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for got, want in [(second, first), *zip(replays, wants)] for a, b in zip(got, want)]
    print(f"check {name} {BIG} repeated launch and two graph replays: "
          f"{'ok' if all(same) else 'FAILED'}", flush=True)
    require(all(same), f"{name} gives other bits when repeated or replayed: {same}")

    # the trials form (the fleet's and the restarts' step): one launch for every trial
    # of a stack, each trial against the plain version on it, and bit for bit a
    # single-trial call's value and gradient
    for shape, p, q in (((FLEET, *BIG), 1.0, 1.0), ((FLEET, *OPPONENTS), 2.0, 0.5)):
        x = randn(*shape)
        before = ops.tv_value_and_grad.launches
        values, grad = ops.tv_value_and_grad_trials(x, scale, p, q, 1e-8)
        launched = ops.tv_value_and_grad.launches - before
        require(launched == 1, f"{name} trials at {shape}: {launched} launches for one call")
        want_values, want = image.tv_value_and_grad_trials_plain(x, scale, p, q, 1e-8)
        record = p == q == 1.0 and f"{name} trials"
        report(name, f"{shape} trials p={p} q={q} values", values, want_values, 1e-5 * want_values.abs(), record)
        if (p, q) in TV_EXACT:
            report_exact(name, f"{shape} trials p={p} q={q} gradient", grad, want, record)
        else:
            report(name, f"{shape} trials p={p} q={q} gradient", grad, want, 2.0 ** -22 * want.abs().max().item(),
                   False)
        singles = [ops.tv_value_and_grad(x[t], scale, p, q, 1e-8) for t in range(shape[0])]
        same = all(differing_bits(values[t], value) == 0 and differing_bits(grad[t], single) == 0
                   for t, (value, single) in enumerate(singles))
        print(f"check {name} {shape} trials p={p} q={q}: one launch, each trial's value and gradient equal to a "
              f"single-trial call's bits: {'ok' if same else 'FAILED'}", flush=True)
        require(same, f"{name} trials at {shape}: a trial differs from its single-trial call")


def differing_bits(got, want):
    """The entries whose bits differ (NaN with NaN counts as equal)."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((got.view(torch.int32) != want.view(torch.int32)) & ~both_nan).sum())


def check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed, slice_shape, report=None):
    """b4_adam_box_step against its plain version over three steps, with NaN and signed
    zeros planted in the gradient and a loss that improves, does not, then improves,
    so that the two best-value buffers swap and the best iterate is taken and kept.
    A 5-dimensional shape is a stack of trials: ``ops.adam_box_step_trials`` (one
    launch a step for every trial, each trial with its own loss and best value) against
    the plain version run on each trial in turn, and bit for bit against the kernel's
    single calls on each trial in turn. ``signed="soft"``: the soft sign at steps 3-5 of
    10 (s = 0.7, 0.6, 0.5), whose tanhf need not round as PyTorch's tanh: NaN in the
    same places, and elsewhere within 4 float32 ulps of each tensor's largest entry
    (``report``); the best values equal."""
    dev = lo.device
    trials = shape[0] if len(shape) == 5 else 0
    grads = [randn(*shape) for _ in range(3)]
    grads[0].view(-1)[::997] = float("nan")
    grads[1].view(-1)[::499] = -0.0
    grads[2].view(-1)[1::499] = 0.0
    start = dict(x=randn(*shape) * 2, mu=randn(*shape) * 0.1, nu=randn(*shape) ** 2 * 0.01,
                 best=randn(*shape))
    # each trial's losses differ by a small offset, so that no two trials share a value
    offsets = torch.arange(max(trials, 1), device=dev) * 1e-3 if trials else torch.zeros((), device=dev)

    def singles(x, grad, mu, nu, best, lo, hi, value, best_val, new_best_val, step, signed, soft_scale):
        for t in range(trials):
            ops.adam_box_step(x[t], grad[t], mu[t], nu[t], best[t], lo, hi, value[t], best_val[t], new_best_val[t],
                              step, signed, soft_scale=soft_scale)

    runs = ((ops.adam_box_step_trials, image.adam_box_step_trials_plain, singles) if trials
            else (ops.adam_box_step, image.adam_box_step_plain))
    states = []
    for run, fn in enumerate(runs):
        st = {k: v.clone() for k, v in start.items()}
        vals = [torch.full(offsets.shape, float("inf"), device=dev), torch.empty(offsets.shape, device=dev)]
        seen = []
        for t, (grad, value) in enumerate(zip(grads, (0.5, 0.7, 0.3)), start=3):
            step = ops.AdamStep(lr=0.1 / t, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** t,
                                bias2=1 - 0.999 ** t)
            args = (st["x"], grad, st["mu"], st["nu"], st["best"], lo, hi, value + offsets, *vals, step)
            soft = ops.soft_sign_scalars(t, 10) if signed == "soft" else None
            before = ops.adam_box_step.launches
            fn(*args, signed=signed, soft_scale=soft)
            if run == 0:
                launched = ops.adam_box_step.launches - before
                require(launched == 1, f"b4_adam_box_step at {shape}: {launched} launches for one step")
            vals.reverse()
            seen.append({**{k: v.clone() for k, v in st.items()}, "best_val": vals[0].reshape(-1).clone()})
        states.append(seen)
    if trials:  # each trial of the stack against its own single calls, bit for bit
        same = all(differing_bits(got[key], single[key]) == 0 for got, single in zip(states[0], states[2])
                   for key in ("x", "mu", "nu", "best", "best_val"))
        print(f"check b4_adam_box_step {shape} signed={signed} trials: one launch a step, each trial equal to "
              f"its own single calls' bits over three steps: {'ok' if same else 'FAILED'}", flush=True)
        require(same, f"b4_adam_box_step trials at {shape}: a trial differs from its single calls")
    best_vals = [s["best_val"][0].item() for s in states[0]]
    require(best_vals == [0.5, 0.5, float(torch.tensor(0.3))],
            f"b4_adam_box_step best values over three steps: {best_vals}")
    for step, (got, want) in enumerate(zip(states[0], states[1])):
        for key in ("x", "mu", "nu", "best", "best_val"):
            where = f"{shape} signed={signed} step={step} {key}"
            if signed == "soft" and key != "best_val":
                nan = torch.isnan(want[key])
                require(torch.equal(torch.isnan(got[key]), nan), f"b4_adam_box_step soft: NaN positions at {where}")
                tol = 4 * torch.finfo(torch.float32).eps * want[key][~nan].abs().max().item()
                report("b4_adam_box_step", where, got[key][~nan], want[key][~nan], tol, slice_shape)
            else:
                report_exact("b4_adam_box_step", where, got[key], want[key], signed and slice_shape)


def attack_gradient(breaching, device, tree0, overrides):
    """A slice's loss and its gradient at the candidate tree tree0 (``data``, and for
    the joint attack ``labels``, the label logits), on `device`: the gradient of every
    leaf, flattened and joined. An attack with augmentations (5a) takes one draw of
    them from a seeded generator on the CPU, the same on every device."""
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    rec_models, labels, _ = attacker.prepare_attack(payloads, shared)
    attacker.objective.initialize(loss_fn, rec_models[0].module,
                                  attacker._local_hyperparams(shared[0]["metadata"]), cfg.attack.impl)
    for reg in attacker.regularizers:
        reg.initialize(rec_models, attacker._shared_data_cache, labels)
    targets = [tuple(shared[0]["gradients"][k] for k in rec_models[0].params)]
    tree = {k: v.to(device).requires_grad_(True) for k, v in tree0.items()}
    draws = None
    if attacker.augmentations:  # the same draws on both devices, made on the CPU
        gen = torch.Generator().manual_seed(11)
        draws = [d if d is None or augmentation.host_draws else d.to(device) for augmentation, d in
                 zip(attacker.augmentations, attacker._draw_augmentations(tuple(tree0["data"].shape), (gen, gen)))]
    value, _ = attacker._loss(tree, rec_models, targets, labels, draws)
    grads = torch.autograd.grad(value, tuple(tree.values()))
    return value.item(), torch.cat([g.reshape(-1) for g in grads]).cpu()


def check_reference(breaching, name, overrides, shape, classes=None):
    """Phase 4: a slice's attack gradient on the card (kernels, cuDNN) against the CPU
    (plain versions), same weights, data and candidate; with ``classes``, the joint
    attack's, with respect to the data and label logits of that many classes."""
    gen = torch.Generator().manual_seed(5)
    x0 = dict(data=torch.randn(*shape, generator=gen))
    if classes:
        x0["labels"] = torch.randn(shape[0], classes, generator=gen)
    v_gpu, g_gpu = attack_gradient(breaching, DEVICE, x0, overrides)
    v_again, g_again = attack_gradient(breaching, DEVICE, x0, overrides)
    # not a check: cuDNN's backward need not give the same bits twice
    print(f"reference {name}: the card's loss and gradient computed twice: loss bits "
          f"{'equal' if v_again == v_gpu else 'differ'}, gradient bits "
          f"{'equal' if torch.equal(g_again.view(torch.int32), g_gpu.view(torch.int32)) else 'differ'} "
          f"(max |difference| {(g_again - g_gpu).abs().max().item():.3e})", flush=True)
    start = time.perf_counter()
    v_cpu, g_cpu = attack_gradient(breaching, "cpu", x0, overrides)
    # float32 on both sides, convolutions and sums in other orders; the gradient
    # passes through a double backward: 1e-4 relative on the value, 1e-3 on the gradient
    v_err = abs(v_gpu - v_cpu) / abs(v_cpu)
    g_err = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    ok = v_err <= 1e-4 and g_err <= 1e-3 and bool(torch.isfinite(g_gpu).all())
    print(f"reference {name}: loss card={v_gpu:.7f} cpu={v_cpu:.7f} rel_err={v_err:.2e} (tol 1e-4); "
          f"gradient rel_err={g_err:.2e} (tol 1e-3) {'ok' if ok else 'FAILED'} "
          f"(CPU side {time.perf_counter() - start:.1f} s)", flush=True)
    require(ok, f"{name}'s attack gradient on the card disagrees with the CPU")


def run_slice(breaching, ops):
    """Phase 5: the main path through the entry points; launch counts from this run only."""
    cfg = breaching.get_config(SLICE + [f"attack.optim.max_iterations={ITERATIONS}",
                                        "attack.optim.callback=500", "seed=0"])
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared_data, payloads, true_user_data = server.run_protocol(user)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start = time.perf_counter()
    reconstruction, stats = attacker.reconstruct(payloads, shared_data, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    metrics = breaching.analysis.report(reconstruction, true_user_data, payloads, server.model,
                                        cfg_case=cfg.case, setup=setup)
    losses = stats["Trial_0_Val"]
    data = reconstruction["data"]
    print(f"slice: ConvNet-64 {sum(p.numel() for p in model.parameters())} parameters, "
          f"{len(losses)} iterations in {seconds:.2f} s = {len(losses) / seconds:.1f} it/s; "
          f"loss first={losses[0]:.6f} last={losses[-1]:.6f} best={stats['opt_value']:.6f}; "
          f"PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; launches {launches}", flush=True)
    require(tuple(data.shape) == (1, 3, 32, 32) and bool(torch.isfinite(data).all()),
            f"reconstruction is not a finite (1, 3, 32, 32) tensor: {tuple(data.shape)}")
    require(losses[-1] < losses[0], "the attack's loss did not fall")
    for name in SLICE_KERNELS:
        require(launches[name] > 0, f"kernel {name} was not launched on the slice")
    require(launches["b3_tv_value_and_grad"] == len(losses) and launches["b3_tv_forward"] == 0,
            f"TV was not one fused launch per step: {launches}")
    return launches


def run_restarts(breaching, ops):
    """Phase 5: slice 1 with ``RESTARTS`` restarts, the batched trial step: the fused TV
    kernel, the cosine backward and the Adam step once a step for every trial, B1 once a
    trial."""
    cfg, setup, user, server, model = build(breaching, SLICE + [
        f"attack.restarts.num_trials={RESTARTS}", f"attack.optim.max_iterations={RESTART_STEPS}",
        "attack.optim.callback=50", "seed=0"])
    shared, payloads, true = server.run_protocol(user)
    needs = dict(b1_matching_sums=RESTARTS, b2_cosine_backward=1, b3_tv_value_and_grad=1, b4_adam_box_step=1)
    return attack_path(breaching, ops, f"slice 1 restarts ({RESTARTS} trials)", cfg, setup, server, shared, payloads,
                       true, RESTART_STEPS, needs=needs)[0]


def resnet_weights():
    """The overrides that choose ResNet-18's weights (slices 2 and 3), and what they
    are: the trained checkpoint where the checkout holds it, else random weights,
    passed explicitly."""
    if os.path.exists(CHECKPOINT):
        return [], f"trained checkpoint {os.path.relpath(CHECKPOINT, REPO)}"
    return ["case.server.pretrained=False"], "random weights from seed 7 (no ResNet18.npz in the checkout)"


def run_resnet(breaching, ops, path, case, overrides, steps, experiments=1):
    """Phase 5, slices 2 and 3: ``case`` (the bench preset, or the fedAVG user's) on
    ResNet-18 through the entry points, solo or as a fleet of ``experiments`` users of
    one server through ``reconstruct_fleet``; launch counts from the attack alone.
    Returns the launch counts."""
    weight_overrides, weights = resnet_weights()
    cfg = breaching.get_config(case + weight_overrides + overrides + [
        f"attack.optim.max_iterations={steps}", "attack.optim.callback=100"])
    start = time.perf_counter()
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    if not weight_overrides:  # the package found the checkout's checkpoint
        require_checkpoint(model, CHECKPOINT)
    payload_lists, shared_lists, truths = [], [], []
    for idx in range(experiments):
        if experiments > 1:  # the fleet: users 0, 1, ... of one server
            cfg.case.user.user_idx = idx
            user = breaching.cases.construct_user(model, server.loss, cfg.case, setup)
        shared, payloads, true = server.run_protocol(user)
        payload_lists.append(payloads)
        shared_lists.append(shared)
        truths.append(true)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    if experiments > 1:
        results, stats = attacker.reconstruct_fleet(payload_lists, shared_lists, server.secrets)
    else:
        result, stats = attacker.reconstruct(payload_lists[0], shared_lists[0], server.secrets)
        results = [result]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    shape = (int(cfg.case.user.num_data_points), *cfg.case.data.shape)
    print(f"{path}: ResNet-18 {sum(p.numel() for p in model.parameters())} parameters on {weights}; "
          f"{user.__class__.__name__} with {shape[0]} image(s) of {tuple(shape[1:])}; "
          f"{experiments} experiment(s), set-up {setup_seconds:.2f} s; {steps} steps in {seconds:.2f} s = "
          f"{experiments * steps / seconds:.2f} it/s{' (aggregate)' if experiments > 1 else ''}; "
          f"peak memory {peak / 2**30:.3f} GiB; launches per step "
          f"{ {k: v / steps for k, v in launches.items() if v} }", flush=True)
    for idx, (result, true, payloads) in enumerate(zip(results, truths, payload_lists)):
        losses = stats[f"Trial_{idx}_Val"]
        diverged = first_nonfinite(losses)
        metrics = breaching.analysis.report(result, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
        order = metrics["order"]
        score = stats["fleet_opt_values"][idx] if experiments > 1 else stats["opt_value"]
        print(f"{path} experiment {idx}: labels {result['labels'].tolist()}; loss first={losses[0]:.6f} "
              f"lowest={min(losses[:diverged] or [math.nan]):.6f} last={losses[-1]:.6f}"
              f"{'' if diverged is None else f' (not finite from step {diverged} on)'}; best iterate's score "
              f"{score:.6f}; PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}"
              f"{'' if order is None else f' (in the order {order.tolist()})'}", flush=True)
        data = result["data"]
        require(tuple(data.shape) == shape and bool(torch.isfinite(data).all()),
                f"{path}: reconstruction {idx} is not a finite {shape} tensor: {tuple(data.shape)}")
        require(len(losses) == steps, f"{path}: {len(losses)} losses of {idx} for {steps} steps")
        if diverged is None:
            require(losses[-1] < losses[0], f"{path}: the loss of {idx} did not fall")
        else:
            require_local_sgd_overflow(f"{path} experiment {idx}", user, server, payloads[0], shared_lists[idx],
                                       true, stats, idx, losses, diverged)
        require(torch.equal(result["labels"].cpu(), true["labels"].cpu()),
                f"{path}: experiment {idx} did not keep its own labels")
        require(order is None or sorted(order.tolist()) == list(range(shape[0])),
                f"{path}: the batch order {order} is not a permutation")
    return launches


def require_checkpoint(model, path):
    """Fails unless ``model`` holds the head of the checkpoint at ``path``."""
    import numpy as np

    with np.load(path) as blob:
        head = torch.from_numpy(blob["params/head/dense/kernel"].T.copy())
    require(torch.equal(model.head.weight.detach().cpu(), head), f"{os.path.basename(path)} was not loaded")


def first_nonfinite(losses):
    """The first step whose loss is not finite, or None."""
    return next((i for i, value in enumerate(losses) if not math.isfinite(value)), None)


def require_local_sgd_overflow(name, user, server, payload, shared, true, stats, trial, losses, diverged):
    """A loss that turned non-finite is accepted only from a fedAVG user whose simulated
    local SGD overflows float32 on the attack's candidates, as it does in the JAX
    package: the cosine does not see the delta's size. The attack stops at the
    candidate whose loss is not finite and keeps its best iterate. The overflow must be
    the local SGD's own: the same steps in float64 on the CPU reach magnitudes that
    float32 cannot sum."""
    from breaching_tpu_torch.cases.users import UserMultiStep

    require(isinstance(user, UserMultiStep) and diverged > 0 and not math.isfinite(losses[-1]),
            f"{name}: the loss turned non-finite at step {diverged}")
    start = time.perf_counter()
    hyper = shared[0]["metadata"]["local_hyperparams"]
    own = local_sgd_peak(server.model, server.loss, payload, hyper, true["data"])
    peak = local_sgd_peak(server.model, server.loss, payload, hyper, stats[f"Trial_{trial}_nonfinite_candidate"])
    print(f"{name}: the user's local SGD in float64 on the CPU reaches |value| {own:.3e} on its own images and "
          f"{peak:.3e} at the candidate where the loss turned non-finite (float32 overflow shown above "
          f"{DIVERGED:.0e}; CPU side {time.perf_counter() - start:.1f} s)", flush=True)
    require(not peak < DIVERGED, f"{name}: the loss turned non-finite at step {diverged}, but the local SGD "
                                 f"stays below {DIVERGED:.0e} in float64 ({peak:.3e})")


def local_sgd_peak(model, loss_fn, payload, hyper, data):
    """The largest magnitude among the logits, task losses, gradients and parameters of
    the fedAVG user's local SGD steps (``hyper``: its shared local hyperparameters) on
    ``data``, from the payload's weights, in float64 on the CPU; inf where even float64
    overflows."""
    from torch.func import functional_call

    buffers = payload["buffers"]
    bn_train = buffers is None
    buffers = {k: v.detach().cpu().double() for k, v in (buffers or dict(model.named_buffers())).items()}
    params = {k: v.detach().cpu().double() for k, v in payload["parameters"].items()}
    x = data.detach().cpu().double()
    per_step, peak = int(hyper["data_per_step"]), 0.0
    for k, labels in enumerate(hyper["labels"][:int(hyper["steps"])]):
        rows = [(k * per_step + j) % x.shape[0] for j in range(per_step)]
        current = {name: v.requires_grad_(True) for name, v in params.items()}
        outputs = functional_call(model, {**current, **buffers}, (x[rows],), dict(train=bn_train))
        loss = loss_fn(outputs, torch.as_tensor(labels).cpu())
        grads = torch.autograd.grad(loss, tuple(current.values()))
        params = {name: (v - float(hyper["lr"]) * g).detach() for (name, v), g in zip(current.items(), grads)}
        for t in (outputs, loss, *grads, *params.values()):
            top = t.detach().abs().max().item()
            if not math.isfinite(top):
                return math.inf
            peak = max(peak, top)
    return peak


def run_slice4(breaching, ops, path, overrides, steps, needs):
    """Phase 5, slice 4: a named preset through the entry points; launch counts from the
    attack alone. ``needs`` gives each kernel the path must launch, once per outer
    "step" or once per "evaluation" of the objective (L-BFGS evaluates it up to 21
    times a step); no other port kernel may launch. Returns the launch counts."""
    resnet = "case=2_single_imagenet" in overrides
    weight_overrides, weights = resnet_weights() if resnet else ([], "random weights from seed 7")
    cfg = breaching.get_config(overrides + weight_overrides + [
        f"attack.optim.max_iterations={steps}", f"attack.optim.callback={100 if resnet else 5}"])
    start = time.perf_counter()
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, true = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    result, stats = attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    metrics = breaching.analysis.report(result, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
    losses, evaluations = stats["Trial_0_Val"], stats["objective_evaluations"]
    shape = (int(cfg.case.user.num_data_points), *cfg.case.data.shape)
    print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters on {weights}; "
          f"{cfg.attack.optim.optimizer}, {cfg.attack.objective.type}; set-up {setup_seconds:.2f} s; {steps} steps "
          f"in {seconds:.2f} s = {steps / seconds:.2f} steps/s, {evaluations} objective evaluations = "
          f"{evaluations / seconds:.1f} evaluations/s; loss first={losses[0]:.6f} best={min(losses):.6f} "
          f"last={losses[-1]:.6f}; score {stats['opt_value']:.6f}; labels {result['labels'].tolist()} "
          f"(true {true['labels'].tolist()}); PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; "
          f"peak memory {peak / 2**30:.3f} GiB; launches per step { {k: v / steps for k, v in launches.items() if v} }",
          flush=True)
    data = result["data"]
    require(tuple(data.shape) == shape and bool(torch.isfinite(data).all()),
            f"{path}: the reconstruction is not a finite {shape} tensor: {tuple(data.shape)}")
    require(len(losses) == steps and all(math.isfinite(v) for v in losses),
            f"{path}: {len(losses)} losses for {steps} steps, or a loss that is not finite")
    require(min(losses) < losses[0], f"{path}: the best value did not fall below the first")
    want = {name: evaluations if per == "evaluation" else steps for name, per in needs.items()}
    require({k: v for k, v in launches.items() if v} == want,
            f"{path}: launches {launches}, the path needs {want} ({evaluations} evaluations, {steps} steps)")
    return launches


def run_slice5(breaching, ops, path, overrides, steps, needs):
    """Phase 5, slice 5: a preset through the entry points; launch counts from the
    attack alone. ``steps``: per stage of the multiscale pyramid (5a), else in all;
    ``needs``: the launches per step of each kernel the path must launch (no other port
    kernel may launch). The ImageNet cases run on the repo's checkpoints: case 2 on
    ResNet18.npz where the checkout holds it, case 5 (5c) on ResNet50.npz, which it must
    hold. Returns (the launch counts, the peak memory in bytes)."""
    weight_overrides, weights = resnet_weights() if "case=2_single_imagenet" in overrides else ([], None)
    cfg = breaching.get_config(overrides + weight_overrides + [
        f"attack.optim.max_iterations={steps}", f"attack.optim.callback={steps}"])
    start = time.perf_counter()
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    if weights is not None and not weight_overrides:
        require_checkpoint(model, CHECKPOINT)
    if "case=5_small_batch_imagenet" in overrides:
        require(os.path.exists(CHECKPOINT50), "ResNet50.npz is not in the checkout")
        require_checkpoint(model, CHECKPOINT50)
        weights = f"trained checkpoint {os.path.relpath(CHECKPOINT50, REPO)}"
    weights = weights or "random weights from seed 7"
    shared, payloads, true = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - start
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    result, stats = attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    metrics = breaching.analysis.report(result, true, payloads, server.model, order_batch=True, cfg_case=cfg.case,
                                        setup=setup)
    losses = stats["Trial_0_Val"]
    stages = attacker._scale_pyramid() if hasattr(attacker, "_scale_pyramid") else [cfg.case.data.shape[-1]]
    total = steps * len(stages)
    shape = (int(cfg.case.user.num_data_points), *cfg.case.data.shape)
    diverged = first_nonfinite(losses)
    by_stage = [losses[i * steps:(i + 1) * steps] for i in range(len(stages))]
    labels = (f"labels {result['labels'].tolist()} (true {true['labels'].tolist()})" if shape[0] <= 8 else
              f"label accuracy {metrics['label_acc']:.2f}")
    print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters on {weights}; "
          f"{user.__class__.__name__} with {shape[0]} image(s) of {tuple(shape[1:])}; {cfg.attack.objective.type}, "
          f"{cfg.attack.optim.optimizer}, grad_accum={cfg.attack.impl.grad_accum}; set-up {setup_seconds:.2f} s; "
          f"{len(stages)} stage(s) {stages} of {steps} steps in {seconds:.2f} s = {total / seconds:.2f} it/s; loss "
          f"first={losses[0]:.6f} lowest={min(losses[:diverged] or [math.nan]):.6f} last={losses[-1]:.6f}"
          f"{'' if diverged is None else f' (not finite from step {diverged} on)'}; score {stats['opt_value']:.6f}; "
          f"{labels}; PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; peak memory {peak / 2**30:.3f} GiB; "
          f"launches per step { {k: v / total for k, v in launches.items() if v} }", flush=True)
    if len(stages) > 1:
        print(f"{path} by stage: " + "; ".join(f"{size}x{size} {stage[0]:.6f} -> {min(stage):.6f}"
                                                for size, stage in zip(stages, by_stage)), flush=True)
    data = result["data"]
    require(tuple(data.shape) == shape and bool(torch.isfinite(data).all()),
            f"{path}: the reconstruction is not a finite {shape} tensor: {tuple(data.shape)}")
    require(len(losses) == total, f"{path}: {len(losses)} losses for {total} steps")
    if diverged is None:
        require(all(min(stage) < stage[0] for stage in by_stage), f"{path}: a stage's loss did not fall")
    else:
        require_local_sgd_overflow(path, user, server, payloads[0], shared, true, stats, 0, losses, diverged)
    want = {name: n * total for name, n in needs.items()}
    require({k: v for k, v in launches.items() if v} == want,
            f"{path}: launches {launches}, the path needs {want} ({total} steps)")
    return launches, peak


def check_large_batch(breaching, shape):
    """Phase 4, slice 5b: the gradient of 5b's objective (the cosine between the user
    gradient of 100 candidate images on ResNet32-10 and the target) by the candidate.
    The micro-batched user gradient (grad_accum=10) against the full batch (grad_accum=1),
    in float64 on the card: equal to 1e-12 of the largest entry (the same sums grouped
    otherwise). Then float32 on the card (cuDNN) and on the CPU (the plain versions),
    both through grad_accum=10, against that float64 evaluation: this gradient is a small
    difference of large terms, and float32 keeps only a few digits of it (measured on
    the H100, max error over the largest entry: cuDNN 1.4e-2, cuDNN at grad_accum=1
    5.5e-3, PyTorch's own CUDA convolutions 3.1e-3, the CPU 4.6e-3), so each is held to
    5e-2 of the largest entry, and the value to 1e-5 relative."""
    import copy

    from breaching_tpu_torch.attacks.auxiliaries.objectives import CosineSimilarity

    cfg = breaching.get_config(LARGE_BATCH)
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    rec_models, labels, _ = attacker.prepare_attack(payloads, shared)
    payload_model = rec_models[0]
    target = tuple(attacker._shared_data_cache[0]["gradients"][k] for k in payload_model.params)
    x0 = torch.randn(*shape, generator=torch.Generator().manual_seed(5))

    def gradient(accum, dtype, device):
        objective = CosineSimilarity()
        objective.initialize(loss_fn, copy.deepcopy(payload_model.module).to(device=device, dtype=dtype), None,
                             {"grad_accum": accum})
        params = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
                  for k, v in payload_model.params.items()}
        buffers = {k: v.to(device=device, dtype=dtype) for k, v in payload_model.buffers.items()}
        x = x0.to(device=device, dtype=dtype).requires_grad_(True)
        value, _ = objective(params, buffers, tuple(t.to(device=device, dtype=dtype) for t in target), x,
                             labels.to(device))
        grad, = torch.autograd.grad(value, x)
        return value.item(), grad.double().cpu()

    start = time.perf_counter()
    (exact_value, exact), (value1, grad1) = gradient(10, torch.float64, DEVICE), gradient(1, torch.float64, DEVICE)
    scale = exact.abs().max().item()
    err = (exact - grad1).abs().max().item() / scale
    print(f"reference slice 5b: the attack gradient through grad_accum=10 against grad_accum=1, float64 on the card: "
          f"loss {exact_value:.12f} / {value1:.12f}, max error {err:.2e} of the largest entry (tol 1e-12) "
          f"{'ok' if err <= 1e-12 else 'FAILED'}", flush=True)
    require(err <= 1e-12, "slice 5b: the micro-batched user gradient differs from the full batch")
    for name, device in (("the card", DEVICE), ("the CPU", "cpu")):
        value, grad = gradient(10, torch.float32, device)
        err = (grad - exact).abs().max().item() / scale
        l2 = ((grad - exact).norm() / exact.norm()).item()
        ok = err <= 5e-2 and abs(value - exact_value) <= 1e-5 * abs(exact_value) and bool(torch.isfinite(grad).all())
        print(f"reference slice 5b: float32 on {name} through grad_accum=10 against float64: loss {value:.7f} "
              f"(rel_err {abs(value - exact_value) / abs(exact_value):.2e}, tol 1e-5); gradient max error "
              f"{err:.2e} of the largest entry (tol 5e-2), L2 error {l2:.2e} {'ok' if ok else 'FAILED'}", flush=True)
        require(ok, f"slice 5b's float32 attack gradient on {name} is off its float64 evaluation")
    print(f"reference slice 5b: {time.perf_counter() - start:.1f} s", flush=True)


def build(breaching, overrides, device=None):
    """(cfg, setup, user, server, model) of a case through the entry points, on the card
    unless ``device`` says otherwise."""
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device=device or DEVICE)
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    return cfg, setup, user, server, model


def attack_path(breaching, ops, path, cfg, setup, server, shared, payloads, true, steps, needs=IMAGE_KERNELS,
                require_fall=True):
    """Phase 5: ``steps`` attack steps on an exchange already made, launch counts from the
    attack alone, each kernel of ``needs`` launched that many times a step and no other.
    Returns (the launch counts, the result, the stats, the losses, it/s, peak bytes)."""
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    result, stats = attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = stats["Trial_0_Val"]
    metrics = breaching.analysis.report(result, true, payloads, server.model, order_batch=True, cfg_case=cfg.case,
                                        setup=setup)
    diverged = first_nonfinite(losses)
    print(f"{path}: {steps} steps in {seconds:.2f} s = {len(losses) / seconds:.2f} it/s; loss first={losses[0]:.6f} "
          f"lowest={min(losses[:diverged] or [math.nan]):.6f} last={losses[-1]:.6f}"
          f"{'' if diverged is None else f' (not finite from step {diverged} on)'}; labels "
          f"{result['labels'].tolist()} (true {true['labels'].tolist()}); PSNR={metrics['psnr']:.3f} "
          f"SSIM={metrics['ssim']:.4f}; peak memory {peak / 2**30:.3f} GiB; launches per step "
          f"{ {k: v / len(losses) for k, v in launches.items() if v} }", flush=True)
    data = result["data"]
    require(tuple(data.shape) == tuple(true["data"].shape) and bool(torch.isfinite(data).all()),
            f"{path}: the reconstruction is not a finite {tuple(true['data'].shape)} tensor")
    require(len(losses) == steps, f"{path}: {len(losses)} losses for {steps} steps")
    if require_fall:
        require(diverged is None and min(losses) < losses[0], f"{path}: the loss did not fall, or is not finite")
    want = {name: n * steps for name, n in needs.items()}
    require({k: v for k, v in launches.items() if v} == want, f"{path}: launches {launches}, the path needs {want}")
    return launches, result, stats, losses


def run_dp(breaching, ops):
    """6a: the fedSGD user with per-example clipping at C and laplacian gradient noise on
    ResNet-18 at 224 (4 images). Every clipped per-example gradient's norm is at most
    C (1 + 1e-5). With the noise off, the clipped gradient in float64 on the card equals
    the CPU's to 1e-12 of its largest entry (the same arithmetic on both), and in float32
    on the card it is within 1e-4 of the largest entry of both float64 and the CPU's
    float32: measured on the H100, 3.35e-5, where the CPU's float32 is 4.0e-7 from
    float64 (PERF.md §6). The attack's loss falls. Times the per-example clipped
    gradient (3 calls after one warm-up)."""
    weight_overrides, weights = resnet_weights()
    cfg, setup, user, server, model = build(breaching, SLICE6 + DP + weight_overrides + [
        f"attack.optim.max_iterations={SLICE6_STEPS}", "attack.optim.callback=100"])
    if not weight_overrides:
        require_checkpoint(model, CHECKPOINT)
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    torch.cuda.synchronize()
    exchange = time.perf_counter() - start
    payload = payloads[0]
    bn_train, buffers = user._local_buffers(payload["buffers"])
    inputs, labels = user._user_tensors(None)
    user.clipped_gradient(payload["parameters"], buffers, inputs, labels, bn_train)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        grads, norms = user.clipped_gradient(payload["parameters"], buffers, inputs, labels, bn_train)
    torch.cuda.synchronize()
    per_example_ms = (time.perf_counter() - start) / 3 * 1e3

    def clipped(device, dtype):
        """The clipped gradient on ``device`` in ``dtype``, flattened, float64 on the CPU."""
        moved = [{k: v.to(device, dtype) for k, v in tree.items()} for tree in (payload["parameters"], buffers)]
        found, _ = user.clipped_gradient(*moved, inputs.to(device, dtype), labels.to(device), bn_train)
        return torch.cat([found[k].reshape(-1).double().cpu() for k in payload["parameters"]])

    card = torch.cat([grads[k].reshape(-1).double().cpu() for k in payload["parameters"]])
    exact, cpu, cpu64 = clipped(DEVICE, torch.float64), clipped("cpu", torch.float32), clipped("cpu", torch.float64)
    scale = exact.abs().max()
    errs = {name: ((a - b).abs().max() / scale).item() for name, a, b in (
        ("float64 card-CPU", exact, cpu64), ("float32 card-float64", card, exact), ("float32 card-CPU", card, cpu),
        ("float32 CPU-float64", cpu, exact))}
    noisy = torch.cat([g.reshape(-1).cpu() for g in shared[0]["gradients"].values()])
    print(f"slice 6a: ResNet-18 on {weights}, {tuple(inputs.shape)}, {'train' if bn_train else 'eval'}-mode BatchNorm; "
          f"exchange {exchange:.2f} s; per-example clipped gradient {per_example_ms:.1f} ms a call; clipped norms "
          f"{norms.tolist()} (C = {CLIP}); noise off, errors over the largest entry: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tol 1e-12 in float64, 1e-4 in float32); shared update with "
          f"noise: |noise| max {(noisy - card).abs().max().item():.3e}", flush=True)
    require(bool((norms <= CLIP * (1 + 1e-5)).all()), f"slice 6a: a clipped norm exceeds C: {norms.tolist()}")
    require(errs["float64 card-CPU"] <= 1e-12 and errs["float32 card-float64"] <= 1e-4
            and errs["float32 card-CPU"] <= 1e-4, f"slice 6a: the clipped gradient on the card is off: {errs}")
    launches, *_ = attack_path(breaching, ops, "slice 6a local DP", cfg, setup, server, shared, payloads, true,
                               SLICE6_STEPS)
    return launches


def orthogonality_error(parameters):
    """The largest |W^T W - I| (or |W W^T - I| where the flat kernel has fewer rows than
    columns) over every convolution and dense kernel, flattened to (-1, out) on the JAX
    package's axes, in float32 on the card."""
    worst = 0.0
    for name, value in parameters.items():
        if not name.endswith("weight") or value.dim() not in (2, 4):
            continue
        flat = value.permute(2, 3, 1, 0).reshape(-1, value.shape[0]) if value.dim() == 4 else value.T
        gram = flat.T @ flat if flat.shape[0] >= flat.shape[1] else flat @ flat.T
        worst = max(worst, (gram - torch.eye(gram.shape[0], device=gram.device)).abs().max().item())
    return worst


def run_model_states(breaching, ops):
    """6b: the same model and images with each server model state, 50 steps each."""
    paths = {}
    for state in ("linearized", "orthogonal", "untrained"):
        path = f"slice 6b model_state={state}"
        cfg, setup, user, server, model = build(breaching, SLICE6 + resnet_weights()[0] + [
            f"case.server.model_state={state}", f"attack.optim.max_iterations={STATE_STEPS}",
            f"attack.optim.callback={STATE_STEPS}"])
        shared, payloads, true = server.run_protocol(user)
        if state == "orthogonal":
            err = orthogonality_error(payloads[0]["parameters"])
            print(f"{path}: every kernel orthonormal on the JAX package's axes to {err:.2e} on the card (tol 1e-4)",
                  flush=True)
            require(err <= 1e-4, f"{path}: a kernel is {err:.2e} off orthonormal")
        paths[path], *_ = attack_path(breaching, ops, path, cfg, setup, server, shared, payloads, true, STATE_STEPS)
    return paths


def run_wainakh(breaching, ops):
    """6d: ``wainakh-whitebox`` labels on ConvNet-64, CIFAR-10, 4 images: the labels the
    attack recovers on the card equal the CPU's, from the same fake draws (a CPU generator
    seeded from the setup's, in the same state on both); 50 steps of the attack."""
    overrides = WAINAKH + ["attack.optim.max_iterations=50", "attack.optim.callback=50"]
    cfg, setup, user, server, model = build(breaching, overrides, "cpu")
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    cpu_labels = attacker.prepare_attack(payloads, shared)[1].cpu()
    cfg, setup, user, server, model = build(breaching, overrides)
    shared, payloads, true = server.run_protocol(user)
    launches, result, *_ = attack_path(breaching, ops, "slice 6d wainakh-whitebox", cfg, setup, server, shared,
                                       payloads, true, 50)
    print(f"slice 6d wainakh-whitebox: labels on the card {result['labels'].tolist()}, on the CPU "
          f"{cpu_labels.tolist()}, true {true['labels'].tolist()}", flush=True)
    require(torch.equal(result["labels"].cpu(), cpu_labels), "slice 6d: the card's labels differ from the CPU's")
    return launches


def run_resume(breaching, ops, tmp):
    """6e: 6a's setup with the noise off. Attacker A takes 101 steps, read back every 50 and
    checkpointed after every chunk (steps 50, 100, 101); a fresh attacker B resumes from
    A's file of step 100. B's restored state equals that file bit for bit; B's loss at
    step 100 equals A's to 1e-6, and B's state after its one step equals A's after step
    101 to 1e-6 of each tensor's largest entry, in all but 1e-4 of the entries: cuDNN's
    backward need not repeat its bits (phase 4), and the hard sign turns a last-bit
    difference of a gradient entry near 0 into a step the other way. Returns the launch
    counts of A and of B."""
    from breaching_tpu_torch import utils_checkpoint
    from breaching_tpu_torch.attacks import optimization_based_attack as attack_module

    path, at_100 = os.path.join(tmp, "state.npz"), os.path.join(tmp, "state_at_100.npz")
    saved, restored = {}, []
    save, restore = utils_checkpoint.save_attack_state, attack_module._RunState.restore

    def save_and_keep(target, arrays, iteration):
        save(target, arrays, iteration)
        saved[(target, iteration)] = {k: v.copy() for k, v in arrays.items()}
        if target == path and iteration == RESUME_STEPS:
            shutil.copy(path, at_100)

    def restore_and_compare(run_state, arrays):
        restore(run_state, arrays)
        now = run_state.arrays()
        restored.append(all(now[k].tobytes() == arrays[k].tobytes() for k in arrays) and now.keys() == arrays.keys())

    utils_checkpoint.save_attack_state, attack_module._RunState.restore = save_and_keep, restore_and_compare
    try:
        knobs = SLICE6 + [f"{LDP}.per_example_clipping={CLIP}", "attack.impl.checkpoint_every=1",
                          f"attack.optim.max_iterations={RESUME_STEPS + 1}", f"attack.optim.callback={RESUME_STEPS // 2}"]
        knobs += resnet_weights()[0]
        cfg, setup, user, server, model = build(breaching, knobs + [f"attack.impl.checkpoint_path={path}"])
        shared, payloads, true = server.run_protocol(user)
        first, _, _, losses = attack_path(breaching, ops, "slice 6e checkpointed run", cfg, setup, server, shared,
                                          payloads, true, RESUME_STEPS + 1)
        cfg.attack.impl.checkpoint_path = at_100
        second, _, stats, resumed_losses = attack_path(breaching, ops, "slice 6e resumed run", cfg, setup, server,
                                                       shared, payloads, true, 1, require_fall=False)
    finally:
        utils_checkpoint.save_attack_state, attack_module._RunState.restore = save, restore
    require(stats.get("resumed_at") == RESUME_STEPS and restored == [True],
            f"slice 6e: resumed at {stats.get('resumed_at')}, restored state equal to the file: {restored}")
    a, b = saved[(path, RESUME_STEPS + 1)], saved[(at_100, RESUME_STEPS + 1)]
    loss_err = abs(resumed_losses[0] - losses[RESUME_STEPS]) / abs(losses[RESUME_STEPS])
    errors, off = {}, {}
    for k in a:
        if a[k].dtype == np.float32:
            diff, scale = np.abs(a[k].astype(np.float64) - b[k]), max(np.abs(a[k]).max(), 1e-30)
            errors[k], off[k] = float(diff.max() / scale), float((diff > 1e-6 * scale).mean())
    print(f"slice 6e resume: {len(a)} state entries; the restored state equals the file of step {RESUME_STEPS} bit "
          f"for bit; the loss at step {RESUME_STEPS} {resumed_losses[0]:.9f} against {losses[RESUME_STEPS]:.9f} "
          f"(relative {loss_err:.2e}, tol 1e-6); after one step, against the uninterrupted step "
          f"{RESUME_STEPS + 1}: largest error over the largest entry {errors}, share of entries beyond 1e-6 of it "
          f"{off} (tol 1e-4)", flush=True)
    require(loss_err <= 1e-6 and max(off.values()) <= 1e-4
            and all(np.array_equal(a[k], b[k]) for k in a if a[k].dtype != np.float32),
            f"slice 6e: the resumed step differs: {errors}, {off}")
    return first, second


def run_trace(breaching, ops, tmp):
    """6f: ``trace_dir`` on slice 1's path (10 steps read back every 5): one chunk's
    Chrome trace names the port's kernels of the path."""
    trace_dir = os.path.join(tmp, "trace")
    cfg, setup, user, server, model = build(breaching, SLICE + [
        "attack.optim.max_iterations=10", "attack.optim.callback=5", f"attack.impl.trace_dir={trace_dir}", "seed=0"])
    shared, payloads, true = server.run_protocol(user)
    launches, _, stats, _ = attack_path(breaching, ops, "slice 6f trace_dir", cfg, setup, server, shared, payloads,
                                        true, 10, needs=dict.fromkeys(SLICE_KERNELS, 1))
    with open(stats["trace_file"]) as fh:
        names = {event.get("name", "") for event in json.load(fh)["traceEvents"]}
    kernels = ("matching_partials", "cosine_backward_kernel", "tv_value_and_grad_kernel", "adam_box_step_kernel")
    named = {k: any(k in name for name in names) for k in kernels}
    print(f"slice 6f: {os.path.basename(stats['trace_file'])}, {os.path.getsize(stats['trace_file'])} bytes, "
          f"{len(names)} event names; the port's kernels named: {named}", flush=True)
    require(all(named.values()), f"slice 6f: the trace does not name every kernel of the path: {named}")
    return launches


def imprint_exchange(breaching, device):
    """7a's exchange on ``device``: (the user's gradient by name on the CPU, the readout's
    images and the bins it read them from)."""
    cfg, setup, user, server, model = build(breaching, RTF, device)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    attacker.prepare_attack(payloads, shared)
    images, bins = attacker.readout(payloads, attacker._shared_data_cache, server.secrets)
    return {k: g.cpu() for k, g in shared[0]["gradients"].items()}, images.cpu(), bins.cpu()


def check_imprint_reference(breaching):
    """Phase 4, 7a: the user's gradient through the imprinted ResNet-18 at 224 on the card
    against the CPU, float32 on both, to 1e-4 of its largest entry; where the readout picks
    the same bins on both, its images to 1e-4 of their largest entry, else both selections
    printed (rounding can make a nearly empty bin's bias gradient nonzero)."""
    start = time.perf_counter()
    (grads, images, bins), (cpu_grads, cpu_images, cpu_bins) = (imprint_exchange(breaching, DEVICE),
                                                                imprint_exchange(breaching, "cpu"))
    flat, cpu_flat = (torch.cat([g[k].reshape(-1) for k in cpu_grads]) for g in (grads, cpu_grads))
    err = ((flat - cpu_flat).abs().max() / cpu_flat.abs().max()).item()
    block_err = max(((grads[k] - cpu_grads[k]).abs().max() / cpu_grads[k].abs().max()).item()
                    for k in cpu_grads if k.startswith("block.linear0"))
    same = torch.equal(bins, cpu_bins)
    image_err = ((images - cpu_images).abs().max() / cpu_images.abs().max()).item() if same else math.nan
    print(f"reference slice 7a: user gradient ({flat.numel()} entries) card against CPU {err:.2e} of the largest "
          f"entry (tol 1e-4; the block's first layer {block_err:.2e}); readout bins card {bins.tolist()} CPU "
          f"{cpu_bins.tolist()}{f', images {image_err:.2e} of the largest entry (tol 1e-4)' if same else ''} "
          f"({time.perf_counter() - start:.1f} s)", flush=True)
    require(err <= 1e-4, f"slice 7a: the user gradient on the card is {err:.2e} off the CPU's")
    require(not same or image_err <= 1e-4, f"slice 7a: the readout's images on the card are {image_err:.2e} off")


def fishing_exchange(breaching, device):
    """7c's class attack on ``device``: the labels from the first query, then the user's
    gradient through the head poisoned for the first label's class and that class's
    feature (``reconstruct_feature``): (labels, the gradient by name on the CPU, the
    feature on the CPU)."""
    from breaching_tpu_torch.cases.malicious.classattack_utils import reconstruct_feature

    cfg, setup, user, server, model = build(breaching, FISHING, device)
    shared, _ = user.compute_local_updates(server.distribute_payload())
    labels = shared["metadata"]["labels"].cpu()
    server.reconfigure_for_class_attack(target_classes=int(labels.unique()[0]))
    shared, _ = user.compute_local_updates(server.distribute_payload())
    feature = reconstruct_feature(shared, int(labels.unique()[0]), server.model)
    server.reset_model()
    return labels, {k: g.cpu() for k, g in shared["gradients"].items()}, feature.cpu()


def check_fishing_reference(breaching):
    """Phase 4, 7c: the gradient of 8 images through ResNet-50's class-poisoned head on the
    card against the CPU, float32 on both, to 1e-4 of its largest entry, and the class's
    feature (row over bias of the head's gradient, a quotient of two entries each within
    that) to 1e-3 of its largest entry."""
    start = time.perf_counter()
    (labels, grads, feature), (cpu_labels, cpu_grads, cpu_feature) = (fishing_exchange(breaching, DEVICE),
                                                                      fishing_exchange(breaching, "cpu"))
    flat, cpu_flat = (torch.cat([g[k].reshape(-1) for k in cpu_grads]) for g in (grads, cpu_grads))
    err = ((flat - cpu_flat).abs().max() / cpu_flat.abs().max()).item()
    feature_err = ((feature - cpu_feature).abs().max() / cpu_feature.abs().max()).item()
    print(f"reference slice 7c: labels {labels.tolist()}; gradient through the poisoned head card against CPU "
          f"{err:.2e} of the largest entry (tol 1e-4); feature of class {int(labels.unique()[0])} {feature_err:.2e} "
          f"(tol 1e-3) ({time.perf_counter() - start:.1f} s)", flush=True)
    require(torch.equal(labels, cpu_labels), "slice 7c: the labels differ between the card and the CPU")
    require(err <= 1e-4 and feature_err <= 1e-3, f"slice 7c: the card is off the CPU: {err:.2e}, {feature_err:.2e}")


@contextlib.contextmanager
def feature_queries():
    """Records each cutoff query of the fishing server made inside the block: (cutoff,
    response, the images behind its gradient). The user's gradient is the mean over its
    batch and each image of the class below the cutoff adds -1 to the class's head bias
    gradient, so the images behind it are that entry times minus the batch size."""
    from breaching_tpu_torch.cases.malicious.servers import MaliciousClassParameterServer
    from breaching_tpu_torch.cases.models.model_preparation import head_grads

    query, record = MaliciousClassParameterServer._query_feature, []

    def recorded(self, user, cls_to_obtain, cutoff, feature_loc):
        shared, response = query(self, user, cls_to_obtain, cutoff, feature_loc)
        bias = head_grads(shared["gradients"], self.model)[1]
        record.append((cutoff, response, -float(bias[cls_to_obtain]) * user.num_data_points))
        return shared, response

    MaliciousClassParameterServer._query_feature = recorded
    try:
        yield record
    finally:
        MaliciousClassParameterServer._query_feature = query


def describe_queries(record):
    return ", ".join(f"{cutoff:.6f} -> {response:.6f} ({images:.3f} images)" for cutoff, response, images in record)


def run_sharp_binary_attack(breaching):
    """Phase 5, 7d'': 7d's case and one-shot search, the protocol alone, at ``SHARP``'s
    feature multiplier. Fails unless the search takes at least two cutoff queries and
    shrinks the images behind the final gradient below the user's 50."""
    start = time.perf_counter()
    cfg, setup, user, server, model = build(breaching, FISHING_UNIQUE + SHARP)
    require_checkpoint(server.model, CHECKPOINT)
    with feature_queries() as record:
        server.run_protocol(user)
    images = record[-1][2] if record else math.nan
    print(f"slice 7d'' the one-shot search with feat_multiplier 30000: {len(record)} cutoff "
          f"queries (cutoff -> response): {describe_queries(record)}; the final gradient is the mean of "
          f"{images:.3f} of the {user.num_data_points} images ({time.perf_counter() - start:.1f} s)", flush=True)
    require(len(record) >= 2 and images < user.num_data_points - 0.5,
            f"slice 7d'': the one-shot search did not shrink the images behind the gradient ({len(record)} "
            f"cutoff queries, {images:.3f} images)")


def run_slice7(breaching, ops, path, overrides, steps, needs):
    """Phase 5, slice 7: a preset through ``main_process`` on the card, the launch counts
    set to 0 just before it and read just after; each kernel of ``needs`` launched that
    many times per attack step and no other. Returns (the launch counts, the metrics,
    what ``main_process`` put out, the reconstruction's MSE against the truth in
    normalized space)."""
    from breaching_tpu_torch.simulate_breach import main_process

    cfg = breaching.get_config(overrides + ([f"attack.optim.max_iterations={steps}", "attack.optim.callback=100"]
                                            if steps else []))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start, out = time.perf_counter(), {}
    metrics = main_process(cfg, device=DEVICE, outputs=out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    data, true = out["reconstruction"]["data"], out["true"]["data"]
    mse = torch.mean((data - true) ** 2).item() if data.shape == true.shape else math.nan
    losses = out["stats"].get("Trial_0_Val", [])
    model = out["server"].model
    print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters, "
          f"{out['server'].__class__.__name__}, {out['user'].num_data_points} image(s) of "
          f"{tuple(cfg.case.data.shape)}; {out['user'].counted_queries} user queries; {seconds:.2f} s wall"
          + (f" ({steps} attack steps, loss first={losses[0]:.6f} lowest={min(losses):.6f} last={losses[-1]:.6f})"
             if losses else "")
          + f"; MSE {mse:.3e} (normalized), PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches { {k: v for k, v in launches.items() if v} }", flush=True)
    require(tuple(data.shape) == tuple(true.shape) and bool(torch.isfinite(data).all()),
            f"{path}: the reconstruction is not a finite {tuple(true.shape)} tensor: {tuple(data.shape)}")
    want = {name: n * steps for name, n in needs.items()}
    require({k: v for k, v in launches.items() if v} == want, f"{path}: launches {launches}, the path needs {want}")
    if steps:
        require(len(losses) == steps and all(map(math.isfinite, losses)) and min(losses) < losses[0],
                f"{path}: the attack's loss did not fall, or is not finite")
    return launches, metrics, out, mse


def run_slice7_paths(breaching, ops):
    """Phase 5, slice 7: 7a-7e, and the checks of each. Returns the launch counts by path."""
    from breaching_tpu_torch.analysis import imprint_guarantee
    from breaching_tpu_torch.cases.malicious.servers import ImprintedModel

    paths, results, queries = {}, {}, {}
    for path, (overrides, steps, needs) in SLICE7.items():
        with feature_queries() as queries[path]:
            paths[path], *results[path] = run_slice7(breaching, ops, path, overrides, steps, needs)
    metrics, out, mse = results["slice 7a robbing_the_fed"]
    require(isinstance(out["server"].model, ImprintedModel), "slice 7a: no imprint block in the model")
    require_checkpoint(out["server"].model.victim, CHECKPOINT)
    require(mse < 5e-2 and metrics["psnr"] > 25, f"slice 7a: MSE {mse:.3e}, PSNR {metrics['psnr']:.3f}: the image "
            f"was not recovered (the JAX package's bar: MSE < 5e-2, PSNR > 25 dB)")
    metrics, out, _ = results["slice 7a' robbing_the_fed 16 images"]
    data, true = out["reconstruction"]["data"], out["true"]["data"]
    data = data[torch.as_tensor(metrics["order"], device=data.device)]
    dm, ds = (torch.as_tensor(v, device=data.device).reshape(1, -1, 1, 1) for v in
              (out["server"].cfg_data.mean, out["server"].cfg_data.std))
    per_image = torch.mean((torch.clamp(data * ds + dm, 0, 1) - torch.clamp(true * ds + dm, 0, 1)) ** 2, dim=(1, 2, 3))
    recovered = int((10 * torch.log10(1 / per_image) > RECOVERED_PSNR).sum())
    expected = imprint_guarantee.expected_number_of_recovered_points(16, 64)
    # the bin of each image: its measurement (the block's shared row) against the bin edges
    block = out["server"].model.block
    with torch.no_grad():
        measured = block.linear0(true.permute(0, 2, 3, 1).reshape(len(true), -1))[:, 0] - block.linear0.bias[0]
    bins = torch.searchsorted(-block.linear0.bias.detach(), measured, right=True) - 1
    occupied, counts = bins.unique(return_counts=True)
    print(f"slice 7a' robbing_the_fed 16 images: {recovered} of 16 images recovered (PSNR > {RECOVERED_PSNR} dB); "
          f"imprint_guarantee expects {expected:.3f} (16 images in 64 bins of the measurement's assumed Laplace "
          f"law); the images' measurements (std {measured.std().item():.4f}) fall in {len(occupied)} bins, "
          f"{int((counts == 1).sum())} of them alone", flush=True)
    for path, checkpoint in (("slice 7c fishing", CHECKPOINT50), ("slice 7d fishing_optimization_unique", CHECKPOINT)):
        metrics, out, _ = results[path]
        require_checkpoint(out["server"].model, checkpoint)
        info = out["server"].secrets["ClassAttack"]
        classes, counts = info["all_labels"].unique(return_counts=True)
        print(f"{path}: the attack's target is image {info['target_indx'].tolist()} of {info['true_num_data']} "
              f"(classes {classes.tolist()}, {counts.tolist()} images each), {out['user'].counted_queries} user "
              f"queries", flush=True)
    path = "slice 7d fishing_optimization_unique"
    out, record = results[path][1], queries[path]
    labels = out["server"].secrets["ClassAttack"]["all_labels"]
    require(len(labels) == 50 and bool((labels == labels[0]).all()) and out["user"].counted_queries > 2
            and record, f"slice 7d: the binary attack did not run ({out['user'].counted_queries} queries)")
    images = record[-1][2]
    print(f"{path}: {len(record)} cutoff queries (cutoff -> response): {describe_queries(record)}; the final "
          f"gradient is the mean of {images:.3f} of the 50 images"
          + (" (the search kept every image)" if images > 49.5 else ""), flush=True)
    require(0 < images <= 50 * (1 + 1e-4), f"{path}: {images:.3f} images behind the final gradient")
    run_sharp_binary_attack(breaching)
    mse = results["slice 7e sanity_check"][2]
    require(mse < 1e-6, f"slice 7e: the FC inversion is {mse:.3e} off the image (the JAX package's bar: 1e-6)")
    return paths


@contextlib.contextmanager
def timed_report_parts(breaching):
    """The seconds of every report and of its registered PSNR, DTCWT CW-SSIM, LPIPS
    distance and IIP (the last with its LPIPS and model features), each call between two
    synchronizations of the card: label -> list of seconds."""
    from breaching_tpu_torch.analysis import analysis, lpips

    seconds = {}
    targets = [(breaching.analysis, "report", "report"), (analysis.M, "registered_psnr", "registered PSNR"),
               (analysis, "dtcwt_cw_ssim", "DTCWT CW-SSIM"), (lpips.LPIPS, "__call__", "LPIPS"),
               (analysis, "_compute_iip", "IIP")]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for (owner, name, label), (_, _, real) in zip(targets, originals):
        def timed(*args, _real=real, _label=label, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = _real(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.setdefault(_label, []).append(time.perf_counter() - start)
            return out

        setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        for owner, name, real in originals:
            setattr(owner, name, real)


def read_png(path):
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG whose rows carry no filter, as
    ``utils.write_png`` writes them (the machine with the card has no PIL)."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        blob = fh.read()
    require(blob[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        length, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        require(zlib.crc32(tag + body) == struct.unpack(">I", blob[pos + 8 + length:pos + 12 + length])[0],
                f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    width, height, depth, color = header[:4]
    require(depth == 8 and color == 2, f"{path}: not 8-bit RGB: {header}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + 3 * width)
    require(not rows[:, 0].any(), f"{path}: filtered rows")
    return rows[:, 1:].reshape(height, width, 3)


def saved_pixels(data, metadata):
    """The 8-bit pixels a reconstruction's images should be saved as: denormalized,
    clipped and truncated as ``(img * 255).astype(np.uint8)`` truncates."""
    rec = np.transpose(data.detach().cpu().numpy().astype(np.float32), (0, 2, 3, 1))
    rec = np.clip(rec * np.asarray(metadata.std) + np.asarray(metadata.mean), 0, 1)
    return (rec * 255).astype(np.uint8)


def read_table(path):
    require(os.path.exists(path), f"{path} was not written")
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def check_report_on_cpu(breaching, cfg, model, reported):
    """One user's report on the card against the report of the same tensors on the CPU
    (``compute_full_iip=True``, the same LPIPS weights)."""
    import copy

    user_idx, card, _, rec, true, payloads = reported

    def cpu(tree):
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    payload = dict(payloads[0], parameters=cpu(payloads[0]["parameters"]),
                   buffers=None if payloads[0]["buffers"] is None else cpu(payloads[0]["buffers"]))
    start = time.perf_counter()
    on_cpu = breaching.analysis.report(cpu(rec), cpu(true), [payload], copy.deepcopy(model).cpu(), order_batch=True,
                                       compute_full_iip=True, cfg_case=cfg.case)
    seconds = time.perf_counter() - start
    failed = []
    for key in REPORT_KEYS:
        a, b = card[key], on_cpu[key]
        if key in REPORT_RELATIVE:
            ok = a == b or abs(a - b) <= REPORT_RELATIVE[key] * abs(b)
        elif key in REPORT_ABSOLUTE:
            ok = abs(a - b) <= REPORT_ABSOLUTE[key]
        elif key == "rpsnr":
            ok = abs(a - b) <= RPSNR_TOLERANCE
        elif key == "order":
            ok = (a is None and b is None) or np.array_equal(a, b)
        else:
            ok = a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
        if not ok:
            failed.append(key)
        print(f"slice 10 report user {user_idx} card against CPU: {key} card={a} cpu={b}"
              f"{'' if ok else ' FAILED'}", flush=True)
    print(f"slice 10 report user {user_idx}: registered PSNR card={card['rpsnr']:.6f} cpu={on_cpu['rpsnr']:.6f} "
          f"(|difference| {abs(card['rpsnr'] - on_cpu['rpsnr']):.3e} dB, tolerance {RPSNR_TOLERANCE:.0e}); the CPU's "
          f"report took {seconds:.1f} s", flush=True)
    require(not failed, f"slice 10: user {user_idx}'s report on the card disagrees with the CPU in {failed}")


def check_rpsnr_of_every_user(reports):
    """Registered PSNR of every benchmark user on the same tensors: the card's report,
    the card once more, the CPU in float32 and the CPU in float64. Each user's card
    figure is held to the CPU's float32 within ``RPSNR_TOLERANCE``; the gaps to float64
    say whether the card's registration drifts further than the CPU's."""
    from breaching_tpu_torch.analysis import metrics as M

    def den(x, metadata, device, dtype):
        dm, ds = (torch.as_tensor(v, dtype=dtype, device=device).reshape(1, -1, 1, 1)
                  for v in (metadata.mean, metadata.std))
        return torch.clamp(x["data"].detach().to(device, dtype) * ds + dm, 0, 1)

    gaps, start = [], time.perf_counter()
    for user_idx, metrics, _, rec, true, payloads in reports:
        metadata = payloads[0]["metadata"]
        again = float(M.registered_psnr(den(rec, metadata, DEVICE, torch.float32),
                                        den(true, metadata, DEVICE, torch.float32)))
        cpu32, cpu64 = (float(M.registered_psnr(den(rec, metadata, "cpu", dtype), den(true, metadata, "cpu", dtype)))
                        for dtype in (torch.float32, torch.float64))
        card = metrics["rpsnr"]
        gaps.append((abs(card - cpu32), abs(card - cpu64), abs(cpu32 - cpu64), abs(card - again)))
        print(f"slice 10 registered PSNR user {user_idx}: card={card:.6f} card again={again:.6f} "
              f"cpu float32={cpu32:.6f} cpu float64={cpu64:.6f}; |card - cpu| {gaps[-1][0]:.3e} dB, from float64 "
              f"the card {gaps[-1][1]:.3e} and the CPU {gaps[-1][2]:.3e}", flush=True)
    card_cpu, card_64, cpu_64, rerun = (np.asarray(g) for g in zip(*gaps))
    print(f"slice 10 registered PSNR of {len(gaps)} users: |card - cpu| max {card_cpu.max():.3e} mean "
          f"{card_cpu.mean():.3e} dB (tolerance {RPSNR_TOLERANCE:.0e}); from float64 the card max {card_64.max():.3e} "
          f"mean {card_64.mean():.3e}, the CPU max {cpu_64.max():.3e} mean {cpu_64.mean():.3e}; the card's second "
          f"registration off its report's by at most {rerun.max():.3e} dB; {time.perf_counter() - start:.1f} s",
          flush=True)
    require(card_cpu.max() <= RPSNR_TOLERANCE, f"slice 10: registered PSNR on the card is {card_cpu.max():.3e} dB "
            f"from the CPU's, past {RPSNR_TOLERANCE}")


def run_benchmark(breaching, ops, tmp):
    """Phase 5, slice 10: the port's ``benchmark_breaches.main_process`` on ``BENCHMARK``,
    the launch counts set to 0 just before it and read just after. Requires a report of
    every key for each of the 8 users (no user's failure swallowed), registered PSNR at
    least the PSNR, the benchmark table (a header and 8 rows) and the averaged row, 8 PNGs
    of 224x224x3 with the reconstructions' pixels, and the fused path's launches: B1 once
    a step for every user, the cosine backward, the fused TV kernel and the Adam step once
    a step for all 8. Returns the launch counts."""
    from breaching_tpu_torch import benchmark_breaches

    weight_overrides, weights = resnet_weights()
    run_dir = os.path.join(tmp, "benchmark")
    cfg = breaching.get_config(BENCHMARK + weight_overrides + [f"base_dir={run_dir}"])
    outputs = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    start = time.perf_counter()
    with timed_report_parts(breaching) as seconds:
        average = benchmark_breaches.main_process(cfg, device=DEVICE, outputs=outputs)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    launches = ops.launch_counts()
    reports = outputs["reports"]
    print(f"slice 10 benchmark: ResNet-18 on {weights}, {BENCHMARK_USERS} users of 1 image of "
          f"{tuple(cfg.case.data.shape)} in one wave, {BENCHMARK_STEPS} fused-cosine steps; {total:.2f} s in all; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }; failures "
          f"{[(users, repr(e)) for users, e in outputs['failures']]}", flush=True)
    require(not outputs["failures"], f"slice 10: users failed in the benchmark: {outputs['failures']}")
    require([r[0] for r in reports] == list(range(BENCHMARK_USERS)), f"slice 10: users reported "
            f"{[r[0] for r in reports]}")
    for user_idx, metrics, stats, rec, true, payloads in reports:
        losses = stats["Trial_0_Val"]
        print(f"slice 10 user {user_idx}: loss first={losses[0]:.6f} last={losses[-1]:.6f}; " + ", ".join(
            f"{k}={metrics[k]:.6g}" if isinstance(metrics[k], float) else f"{k}={metrics[k]}" for k in REPORT_KEYS),
            flush=True)
        missing = [k for k in REPORT_KEYS if k not in metrics]
        require(not missing, f"slice 10: user {user_idx}'s report lacks {missing}")
        require(math.isfinite(metrics["lpips"]), f"slice 10: user {user_idx}'s LPIPS is not finite")
        require(metrics["rpsnr"] >= metrics["psnr"], f"slice 10: user {user_idx}'s registered PSNR "
                f"{metrics['rpsnr']} is below its PSNR {metrics['psnr']}")
        require(len(losses) == BENCHMARK_STEPS and all(map(math.isfinite, losses)) and min(losses) < losses[0],
                f"slice 10: user {user_idx}'s loss did not fall, or is not finite")
        pixels = read_png(os.path.join(run_dir, "reconstructions", f"{cfg.name}_user{user_idx}_rec_0.png"))
        require(pixels.shape == (*cfg.case.data.shape[1:], 3) and np.array_equal(pixels, saved_pixels(
            rec["data"], payloads[0]["metadata"])[0]), f"slice 10: user {user_idx}'s PNG is not its reconstruction")
    rows = read_table(os.path.join(run_dir, "tables", f"table_benchmark_{cfg.case.name}.csv"))
    require(len(rows) == 1 + BENCHMARK_USERS and all(k in rows[0] for k in REPORT_KEYS),
            f"slice 10: the benchmark table has {len(rows)} lines, header {rows[0]}")
    bench = read_table(os.path.join(tmp, "outputs", "tables",
                                    f"BENCHMARK_breach_{cfg.case.name}_{cfg.attack.type}.csv"))
    require(len(bench) == 2 and bench[0] == list(average), f"slice 10: the averaged table holds {bench}")
    want = dict(b1_matching_sums=BENCHMARK_USERS * BENCHMARK_STEPS, b2_cosine_backward=BENCHMARK_STEPS,
                b3_tv_value_and_grad=BENCHMARK_STEPS, b4_adam_box_step=BENCHMARK_STEPS)
    require({k: v for k, v in launches.items() if v} == want, f"slice 10: launches {launches}, the path needs {want}")
    per_user = {label: sum(times) / BENCHMARK_USERS for label, times in seconds.items()}
    shape = "x".join(map(str, (1, *cfg.case.data.shape)))
    print(f"slice 10 report seconds per user (mean of {BENCHMARK_USERS}, {shape}, IIP pool of "
          f"{cfg.case.impl.get('iip_pool_cap', 256)}): " + ", ".join(f"{k} {v:.3f}" for k, v in per_user.items())
          + f"; report calls {[round(t, 3) for t in seconds['report']]}", flush=True)
    print(f"slice 10 average row: {average}", flush=True)
    check_report_on_cpu(breaching, cfg, outputs["model"], reports[-1])
    check_rpsnr_of_every_user(reports)
    return launches


def run_simulate_records(breaching, ops, tmp):
    """Phase 5, slice 10: ``simulate_breach.main_process`` on slice 1 (fused cosine,
    ``RECORDS_STEPS`` steps) with ``save_reconstruction=True``: its table row, its
    metrics' YAML (read back by ``config.loader.parse_yaml`` to the metrics themselves)
    and its PNG (the reconstruction's pixels). Returns the launch counts."""
    from breaching_tpu_torch.config.loader import parse_yaml
    from breaching_tpu_torch.simulate_breach import main_process

    run_dir = os.path.join(tmp, "simulate")
    cfg = breaching.get_config(SLICE + [f"attack.optim.max_iterations={RECORDS_STEPS}", "attack.optim.callback=50",
                                        "save_reconstruction=True", "seed=0", "name=records", f"base_dir={run_dir}"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outputs = {}
    metrics = main_process(cfg, device=DEVICE, outputs=outputs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    rows = read_table(os.path.join(run_dir, "tables", f"table_breach_{cfg.case.name}.csv"))
    with open(os.path.join(run_dir, f"metrics_{cfg.name}.yaml")) as fh:
        loaded = parse_yaml(fh.read())
    pixels = read_png(os.path.join(run_dir, "reconstructions", f"{cfg.name}_rec_0.png"))
    print(f"slice 10 simulate_breach records: table of {len(rows)} lines ({len(rows[0])} columns), metrics YAML of "
          f"{len(loaded)} keys, PNG of {pixels.shape}; PSNR={metrics['psnr']:.3f} R-PSNR={metrics['rpsnr']:.3f}; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    require(len(rows) == 2 and all(k in rows[0] for k in REPORT_KEYS if not k.startswith("IIP")),
            f"slice 10: simulate_breach's table holds {rows}")
    same = sorted(loaded) == sorted(metrics) and all(loaded[k] == v or (
        isinstance(v, float) and math.isnan(v) and math.isnan(loaded[k])) for k, v in metrics.items())
    require(same, f"slice 10: the metrics' YAML reads back as {loaded}, not {metrics}")
    require(pixels.shape == (*cfg.case.data.shape[1:], 3) and np.array_equal(pixels, saved_pixels(
        outputs["reconstruction"]["data"], cfg.case.data)[0]),
        "slice 10: simulate_breach's PNG is not its reconstruction")
    want = {name: RECORDS_STEPS for name in SLICE_KERNELS}
    require({k: v for k, v in launches.items() if v} == want, f"slice 10: launches {launches}, the path needs {want}")
    return launches


def run_records(breaching, ops):
    """Phase 5, slice 10, in a temporary directory that is also the working directory
    (the averaged benchmark row goes to ``outputs/tables`` there), with LPIPS weights that
    ``LPIPS.random_init`` draws from a seeded generator. Returns the launch counts by path."""
    from breaching_tpu_torch.analysis.lpips import LPIPS

    previous = os.environ.get("BREACHING_LPIPS_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        weights = os.path.join(tmp, "lpips_alex.npz")
        LPIPS.random_init("alex", generator=torch.Generator().manual_seed(0)).save_npz(weights)
        os.environ["BREACHING_LPIPS_WEIGHTS"] = weights
        try:
            return {"slice 10 benchmark fleet": run_benchmark(breaching, ops, tmp),
                    "slice 10 simulate_breach records": run_simulate_records(breaching, ops, tmp)}
        finally:
            if previous is None:
                os.environ.pop("BREACHING_LPIPS_WEIGHTS", None)
            else:
                os.environ["BREACHING_LPIPS_WEIGHTS"] = previous


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_in_turns(kernel, library, iters):
    """``timing.time_ms`` of a kernel and its library call taken in turns (kernel,
    library, library, kernel) over ``TURNS`` rounds, and the median of each figure: the
    host's speed drifts within a call by more than the two differ."""
    from breaching_tpu_torch.timing import time_ms

    runs = ([], [])
    for _ in range(TURNS):
        for which in (0, 1, 1, 0):
            runs[which].append(time_ms((kernel, library)[which], iters))
    return [tuple(float(np.median([run[i] for run in timed])) for i in range(4)) for timed in runs]


def time_kernels(ops, n, image_shape, names=None, iters=200):
    """Phase 6: times at a slice's shapes, of every kernel or of ``names``, over ``iters``
    calls (``timing.time_ms``: device times with the operands cold, as the attack step
    finds them after a double backward through the model, and warm in L2)."""
    from breaching_tpu_torch.ops import image, matching
    from breaching_tpu_torch.timing import time_ms

    gen = torch.Generator().manual_seed(99)
    dev = torch.device(DEVICE)
    r, d = torch.randn(n, generator=gen).to(dev), torch.randn(n, generator=gen).to(dev)
    a, b = torch.tensor([-0.7], device=dev), torch.tensor([1.3], device=dev)
    ar = a * r
    sums, upstream = ops.matching_sums(r, d), torch.tensor(0.37, device=dev)
    x = torch.randn(*image_shape, generator=gen).to(dev)
    g = torch.tensor([0.37], device=dev)
    lo = torch.tensor([-1.9, -2.0, -1.7], device=dev)
    hi = torch.tensor([2.1, 2.1, 2.0], device=dev)
    lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
    xi = x.clone()
    m = x.numel()
    grad = torch.randn(*image_shape, generator=gen).to(dev)
    mu, nu, best = torch.zeros_like(x), torch.zeros_like(x), x.clone()
    value = torch.tensor(0.5, device=dev)
    # best_val stays inf: every call improves and writes best, the most bytes a step moves
    vals = (torch.tensor(float("inf"), device=dev), torch.empty((), device=dev))
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    soft = ops.soft_sign_scalars(3, 10)
    step_args = (x, grad, mu, nu, best, lo, hi, value, *vals, step)
    cases = {
        # name: (kernel, plain, (library call, its name) or None, bytes, flops)
        "b1_matching_sums": (lambda: ops.matching_sums(r, d), lambda: matching.matching_sums_plain(r, d),
                             (lambda: (torch.dot(r, d), torch.linalg.vector_norm(r),
                                       torch.linalg.vector_norm(d)), "torch.dot + 2 vector_norm"),
                             8 * n + 12, 6 * n),
        "b2_axpby": (lambda: ops.axpby(a, r, b, d), lambda: matching.axpby_plain(a, r, b, d),
                     (lambda: torch.add(ar, d, alpha=1.3), "torch.add(alpha=)"), 12 * n + 8, 3 * n),
        # reads rec, data, the sums and g; writes one vector
        "b2_cosine_backward": (lambda: ops.cosine_backward(sums, upstream, r, d),
                               lambda: matching.cosine_backward_plain(sums, upstream, r, d),
                               None, 12 * n + 16, 3 * n),
        "b3_tv_forward": (lambda: ops.tv_forward(x), lambda: image.tv_forward_plain(x), None,
                          4 * m + 4, 8 * m),
        # reads x and the scale, writes the value and the gradient; about 20 operations
        # per element at p = q = 1
        "b3_tv_value_and_grad": (lambda: ops.tv_value_and_grad(x, g), lambda: image.tv_value_and_grad_plain(x, g),
                                 None, 8 * m + 8, 20 * m),
        "b4_box_project": (lambda: ops.box_project(x, lo, hi), lambda: image.box_project_plain(x, lo, hi),
                           (lambda: torch.clamp(x, lo4, hi4), "torch.clamp"), 8 * m + 24, 2 * m),
        # the form the path takes (slice 4b-c): in place on the step's own result
        "b4_box_project in place": (lambda: ops.box_project(xi, lo, hi, out=xi),
                                    lambda: image.box_project_plain(xi, lo, hi, out=xi),
                                    (lambda: torch.clamp(xi, lo4, hi4, out=xi), "torch.clamp(out=)"), 8 * m + 24,
                                    2 * m),
        # reads x, g, mu, nu, value, best_val, lo, hi; writes x, mu, nu, best (improved) and
        # the new best value; about 15 operations per element
        "b4_adam_box_step": (lambda: ops.adam_box_step(*step_args), lambda: image.adam_box_step_plain(*step_args),
                             None, 32 * m + 36, 15 * m),
        # the soft sign (slice 4d-e): tanh and a division more per element, about 35 operations
        "b4_adam_box_step soft": (lambda: ops.adam_box_step(*step_args, signed="soft", soft_scale=soft),
                                  lambda: image.adam_box_step_plain(*step_args, signed="soft", soft_scale=soft),
                                  None, 32 * m + 36, 35 * m),
        # p = 2, q = 0.5 (slice 4d-e, on the double opponents): a square root and its
        # reciprocal power more per element, about 30 operations
        "b3_tv_value_and_grad q=0.5": (lambda: ops.tv_value_and_grad(x, g, 2.0, 0.5),
                                       lambda: image.tv_value_and_grad_plain(x, g, 2.0, 0.5), None,
                                       8 * m + 8, 30 * m),
        "b3_tv_forward q=0.5": (lambda: ops.tv_forward(x, 2.0, 0.5), lambda: image.tv_forward_plain(x, 2.0, 0.5),
                                None, 4 * m + 4, 12 * m),
    }
    # the fused TV kernel and B3 forward also at the shape slice 2 (ResNet-18, ImageNet)
    # gives them
    big = torch.randn(*BIG, generator=gen).to(dev)
    cases[f"b3_tv_value_and_grad {BIG}"] = (
        lambda: ops.tv_value_and_grad(big, g), lambda: image.tv_value_and_grad_plain(big, g),
        None, 8 * big.numel() + 8, 20 * big.numel())
    cases[f"b3_tv_forward {BIG}"] = (
        lambda: ops.tv_forward(big), lambda: image.tv_forward_plain(big), None,
        4 * big.numel() + 4, 8 * big.numel())
    # each fused kernel's second yardstick: the library call of the kernel it grew from;
    # for the fused TV kernel, B3 forward alone, the half of the pair it replaced that the
    # tree keeps (the whole pair, from the parent commit: python3 -m breaching_tpu_torch.timing)
    seconds = {"b2_cosine_backward": (*cases["b2_axpby"][2], "grew_from_library"),
               "b4_adam_box_step": (*cases["b4_box_project"][2], "grew_from_library"),
               "b4_adam_box_step soft": (*cases["b4_box_project"][2], "grew_from_library"),
               "b3_tv_value_and_grad q=0.5": (cases["b3_tv_forward q=0.5"][0], "b3_tv_forward alone",
                                              "replaced_half")}
    for at in ("", f" {BIG}"):
        seconds["b3_tv_value_and_grad" + at] = (cases["b3_tv_forward" + at][0], "b3_tv_forward alone",
                                                "replaced_half")
    timings = {}
    for name, (kernel, plain, library, nbytes, flops) in cases.items():
        if (names is None and name.endswith(("soft", "q=0.5"))) or (names is not None and name not in names):
            continue  # slice 4's variants run only when named
        bound_ms, bound_by = bound(nbytes, flops)
        yardstick = seconds.get(name, None if library is None else (*library, "library"))
        turns = name in IN_TURNS
        if turns:  # the kernel and its library call in turns, medians
            (ms, device_ms, host_ms, device_warm_ms), (lib_ms, lib_device_ms, lib_host_ms, lib_device_warm_ms) = \
                time_in_turns(kernel, yardstick[0], iters)
        else:
            ms, device_ms, host_ms, device_warm_ms = time_ms(kernel, iters)
        plain_ms, plain_device_ms, plain_host_ms, plain_device_warm_ms = time_ms(plain, iters)
        row = dict(ms=ms, device_ms=device_ms, host_ms=host_ms, device_warm_ms=device_warm_ms, plain_ms=plain_ms,
                   plain_device_ms=plain_device_ms, plain_host_ms=plain_host_ms,
                   plain_device_warm_ms=plain_device_warm_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        if yardstick is not None:
            if not turns:
                lib_ms, lib_device_ms, lib_host_ms, lib_device_warm_ms = time_ms(yardstick[0], iters)
            prefix = yardstick[2]
            row.update({f"{prefix}_call": yardstick[1], f"{prefix}_ms": lib_ms,
                        f"{prefix}_device_ms": lib_device_ms, f"{prefix}_host_ms": lib_host_ms,
                        f"{prefix}_device_warm_ms": lib_device_warm_ms})
        timings[name] = row
        line = (f"time {name}: kernel {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device cold "
                f"({device_warm_ms * 1e3:.2f} warm), {host_ms * 1e3:.2f} us host; plain {plain_ms * 1e3:.2f} / "
                f"{plain_device_ms * 1e3:.2f} ({plain_device_warm_ms * 1e3:.2f}) / {plain_host_ms * 1e3:.2f} us")
        if yardstick is not None:
            line += (f"; {yardstick[1]} {lib_ms * 1e3:.2f} / {lib_device_ms * 1e3:.2f} "
                     f"({lib_device_warm_ms * 1e3:.2f}) / {lib_host_ms * 1e3:.2f} us")
        print(f"{line}; bound {bound_ms * 1e3:.3f} us ({bound_by}); n={n} images {image_shape}"
              f"{f' (kernel and library call: medians of {2 * TURNS} in turns)' if turns else ''}", flush=True)
        if name == "b4_adam_box_step":
            row["fused_adam"] = time_fused_adam(image_shape, iters)
    return timings


def time_fused_adam(shape, iters):
    """The fused Adam step's second yardstick: ``torch._fused_adam_`` (PyTorch's own
    fused Adam, without the sign, box, guard and best iterate) on one tensor of the
    candidate's shape, where the installed torch has it."""
    from breaching_tpu_torch.timing import time_ms

    if not hasattr(torch, "_fused_adam_"):
        print(f"time torch._fused_adam_ {shape}: not in torch {torch.__version__}", flush=True)
        return None
    gen = torch.Generator().manual_seed(96)
    p, g = (torch.randn(*shape, generator=gen).to(DEVICE) for _ in range(2))
    m, v, step = torch.zeros_like(p), torch.zeros_like(p), torch.ones((), device=DEVICE)

    def call():
        torch._fused_adam_([p], [g], [m], [v], [], [step], lr=0.1, beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    try:
        ms, device_ms, host_ms, device_warm_ms = time_ms(call, iters)
    except RuntimeError as err:  # not capturable in a CUDA graph on this torch
        print(f"time torch._fused_adam_ {shape}: {err}", flush=True)
        return None
    print(f"time torch._fused_adam_ {shape}: {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device cold "
          f"({device_warm_ms * 1e3:.2f} warm), {host_ms * 1e3:.2f} us host", flush=True)
    return dict(ms=ms, device_ms=device_ms, host_ms=host_ms, device_warm_ms=device_warm_ms)


def time_trials(ops, n_params, iters=100):
    """Phase 6: each trials form in one launch beside its T single calls and the plain
    version per trial: the fused TV kernel and the fused Adam step on the fleet's
    (8, 1, 3, 224, 224) stack, the fused cosine backward on the restarts' 4 rows of
    ConvNet-64's gradient."""
    from breaching_tpu_torch.ops import image, matching
    from breaching_tpu_torch.timing import time_ms

    gen = torch.Generator().manual_seed(98)
    shape = (FLEET, *BIG)
    stack = torch.randn(*shape, generator=gen).to(DEVICE)
    g = torch.tensor([0.37], device=DEVICE)
    m = stack.numel()
    lo = torch.tensor([-1.9, -2.0, -1.7], device=DEVICE)
    hi = torch.tensor([2.1, 2.1, 2.0], device=DEVICE)
    adam = [stack.clone(), torch.randn(*shape, generator=gen).to(DEVICE), torch.zeros_like(stack),
            torch.zeros_like(stack), stack.clone(), lo, hi, torch.full((FLEET,), 0.5, device=DEVICE),
            torch.full((FLEET,), float("inf"), device=DEVICE), torch.empty(FLEET, device=DEVICE),
            ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)]

    def adam_singles():
        for t in range(FLEET):
            ops.adam_box_step(*(a[t] for a in adam[:5]), lo, hi, *(a[t] for a in adam[7:10]), adam[10])

    rec, data = (torch.randn(RESTARTS, n_params, generator=gen).to(DEVICE) for _ in range(2))
    sums = torch.stack([ops.matching_sums(r, d) for r, d in zip(rec, data)])
    upstream = torch.linspace(0.2, 0.9, RESTARTS, device=DEVICE)
    forms = {  # name: (shape, one launch, T single calls, plain per trial, bytes, flops)
        "b3_tv_value_and_grad": (shape, lambda: ops.tv_value_and_grad_trials(stack, g),
                                 lambda: [ops.tv_value_and_grad(trial, g) for trial in stack],
                                 lambda: image.tv_value_and_grad_trials_plain(stack, g), 8 * m + 4 * FLEET + 4, 20 * m),
        # every trial improves (best value inf): the most bytes a step moves
        "b4_adam_box_step": (shape, lambda: ops.adam_box_step_trials(*adam), adam_singles,
                             lambda: image.adam_box_step_trials_plain(*adam), 32 * m + 12 * FLEET + 24, 15 * m),
        "b2_cosine_backward": ((RESTARTS, n_params), lambda: ops.cosine_backward(sums, upstream, rec, data),
                               lambda: [ops.cosine_backward(sums[t], upstream[t], rec[t], data[t])
                                        for t in range(RESTARTS)],
                               lambda: matching.cosine_backward_plain(sums, upstream, rec, data),
                               12 * RESTARTS * n_params + 16 * RESTARTS, 3 * RESTARTS * n_params),
    }
    out = {}
    for name, (at, one, single, plain, nbytes, flops) in forms.items():
        bound_ms, bound_by = bound(nbytes, flops)
        ms, device_ms, host_ms, device_warm_ms = time_ms(one, iters)
        singles = time_ms(single, iters)
        plain_t = time_ms(plain, iters)
        print(f"time {name} trials {at}: one launch {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device "
              f"cold ({device_warm_ms * 1e3:.2f} warm), {host_ms * 1e3:.2f} us host; {at[0]} single calls "
              f"{singles[0] * 1e3:.2f} / {singles[1] * 1e3:.2f} ({singles[3] * 1e3:.2f}) / {singles[2] * 1e3:.2f} us; "
              f"plain per trial {plain_t[0] * 1e3:.2f} / {plain_t[1] * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
              f"({bound_by})", flush=True)
        out[name] = dict(shape=at, launches_per_call=1, ms=ms, device_ms=device_ms, host_ms=host_ms,
                         device_warm_ms=device_warm_ms, single_calls_ms=singles[0], single_calls_device_ms=singles[1],
                         single_calls_host_ms=singles[2], single_calls_device_warm_ms=singles[3], plain_ms=plain_t[0],
                         plain_device_ms=plain_t[1], bound_ms=bound_ms, bound_by=bound_by)
    return out


def launch_configs(n_params, image_shape):
    """Phase 6: the launch of each kernel redesigned for the dispatcher binding (``b2_axpby``,
    the fused cosine backward, the fused TV kernel, the fused Adam step), as the binding's
    ``launch_config`` reads it on this card: threads per block, registers per thread,
    static shared bytes, blocks resident per SM and the grid, at each shape the paths give
    it."""
    from breaching_tpu_torch.ops import _build

    launch_config = _build.load_ops().launch_config.default
    keys = ("threads", "registers", "shared_bytes", "local_bytes", "blocks_per_sm", "grid")
    configs = {"b2_axpby": [dict(n=n_params, **dict(zip(keys, launch_config("b2_axpby", n_params, 0, 0, 1))))]}
    tv = []
    for shape, segments, form in ((image_shape, 1, "p=q=1"), (BIG, 1, "p=q=1"), (BATCH, 1, "p=q=1"),
                                  (OPPONENTS, 1, "general"), (LARGE, 1, "p=q=1"), (STAGE, 1, "p=q=1"),
                                  (STAGE2, 1, "p=q=1"), ((FLEET, *BIG), FLEET, "p=q=1")):
        kernel = "b3_tv_value_and_grad" + (" p=q=1" if form == "p=q=1" else "")
        tv.append(dict(shape=shape, segments=segments, form=form, **dict(zip(
            keys, launch_config(kernel, math.prod(shape), shape[-2], shape[-1], segments)))))
    configs["b3_tv_value_and_grad"] = tv
    configs["b4_adam_box_step"] = [
        dict(shape=shape, trials=trials, **dict(zip(keys, launch_config(
            "b4_adam_box_step", math.prod(shape), shape[-2], shape[-1], trials))))
        for shape, trials in ((image_shape, 1), (BIG, 1), (BATCH, 1), (LARGE, 1), (STAGE, 1),
                              ((RESTARTS, *image_shape), RESTARTS), ((FLEET, *BIG), FLEET))]
    configs["b2_cosine_backward"] = [
        dict(n=n, rows=rows, **dict(zip(keys, launch_config("b2_cosine_backward", n * rows, 0, 0, rows))))
        for n, rows in ((n_params, 1), (N2, 1), (n_params, RESTARTS))]
    for name, rows in configs.items():
        for row in rows:
            where = row.get("shape", f"n={row.get('n')}" + (f" x {row['rows']} rows" if "rows" in row else ""))
            print(f"launch {name} {where}{' ' + row['form'] if 'form' in row else ''}: {row['threads']} threads, "
                  f"{row['registers']} registers a thread, {row['shared_bytes']} shared bytes, "
                  f"{row['local_bytes']} local bytes a thread, "
                  f"{row['blocks_per_sm']} blocks per SM, grid {row['grid']}", flush=True)
    return configs


def host_breakdown(ops, n_params, image_shape, iters=200):
    """Phase 6: each wrapper's host time per call at slice 1's shapes, split into the
    Python wrapper and the dispatcher op it calls (the op called directly), in turns
    (medians)."""
    from breaching_tpu_torch.ops import _build, image

    gen = torch.Generator().manual_seed(97)
    r, d = torch.randn(n_params, generator=gen).to(DEVICE), torch.randn(n_params, generator=gen).to(DEVICE)
    a, b = torch.tensor([-0.7], device=DEVICE), torch.tensor([1.3], device=DEVICE)
    x, g = torch.randn(*image_shape, generator=gen).to(DEVICE), torch.tensor([0.37], device=DEVICE)
    lo = torch.tensor([-1.9, -2.0, -1.7], device=DEVICE)
    hi = torch.tensor([2.1, 2.1, 2.0], device=DEVICE)
    sums, upstream = ops.matching_sums(r, d), torch.tensor(0.37, device=DEVICE)
    workspace = image._tv_workspace(x.get_device())
    adam = (x.clone(), torch.randn(*image_shape, generator=gen).to(DEVICE), torch.zeros_like(x), torch.zeros_like(x),
            x.clone(), lo, hi, torch.tensor(0.5, device=DEVICE), torch.tensor(float("inf"), device=DEVICE),
            torch.empty((), device=DEVICE))
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    op = _build.op
    op_calls = {
        "b1_matching_sums": (lambda: ops.matching_sums(r, d), lambda: op("matching_sums")(r, d)),
        "b2_axpby": (lambda: ops.axpby(a, r, b, d), lambda: op("axpby")(a, r, b, d)),
        "b2_cosine_backward": (lambda: ops.cosine_backward(sums, upstream, r, d),
                               lambda: op("cosine_backward")(sums, upstream, r, d, False)),
        "b3_tv_forward": (lambda: ops.tv_forward(x), lambda: op("tv_forward")(x, 1.0, 1.0, 1e-8)),
        "b3_tv_value_and_grad": (lambda: ops.tv_value_and_grad(x, g),
                                 lambda: op("tv_value_and_grad")(x, g, 1.0, 1.0, 1e-8, 0, workspace)),
        "b4_box_project": (lambda: ops.box_project(x, lo, hi), lambda: op("box_project")(x, lo, hi)),
        "b4_adam_box_step": (lambda: ops.adam_box_step(*adam, step),
                             lambda: op("adam_box_step")(*adam, *step, 1.0, 1.0, 3)),
    }
    out = {}
    for name, (wrapper, direct) in op_calls.items():
        (w_ms, _, w_host, _), (o_ms, _, o_host, _) = time_in_turns(wrapper, direct, iters)
        out[name] = dict(wrapper_host_ms=w_host, op_host_ms=o_host, python_host_ms=w_host - o_host,
                         wrapper_ms=w_ms, op_ms=o_ms)
        print(f"host {name}: {w_host * 1e3:.2f} us per call through the wrapper, {o_host * 1e3:.2f} us through "
              f"the op alone, so {(w_host - o_host) * 1e3:.2f} us in Python (medians of {2 * TURNS} in turns)",
              flush=True)
    return out


def under_bound(rows):
    """(kernel, where, shape) of every timing whose cold device time is under its bound:
    a measurement that does not see what the kernel must move."""
    found = []
    for row in rows:
        timed = [("at slice 1", row)] + [(key, at) for key, value in row.items() if key.startswith("at_")
                                         for at in (value if isinstance(value, list) else [value])]
        found += [(row["name"], key, at.get("shape")) for key, at in timed if at["device_ms"] < at["bound_ms"]]
    return found


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available.", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import breaching_tpu_torch as breaching
    from breaching_tpu_torch import ops
    from breaching_tpu_torch.ops import _build

    print(card_line(), flush=True)

    start = began = time.perf_counter()
    _build.load_ops()
    print(f"build: {os.path.relpath(_build.library_path(), REPO)} ready in "
          f"{time.perf_counter() - start:.1f} s (nvcc {_build.build_seconds or 0.0:.1f} s)", flush=True)

    cfg = breaching.get_config(SLICE)
    n_params = sum(p.numel() for p in breaching.cases.construct_model(cfg.case.model, cfg.case.data)[0]
                   .parameters())
    image_shape = (int(cfg.case.user.num_data_points), *cfg.case.data.shape)
    errors = check_kernels(ops, n_params, image_shape)
    print(f"chip_smoke: phase 3 done at {time.perf_counter() - began:.1f} s", flush=True)
    check_reference(breaching, "slice 1", SLICE + ["seed=7"], (1, 3, 32, 32))
    check_reference(breaching, "slice 2", SLICE2 + resnet_weights()[0], BIG)
    fused = ["attack.objective.type=fused-cosine-similarity"]
    check_reference(breaching, "slice 3", SLICE3 + resnet_weights()[0], BATCH)
    check_reference(breaching, "slice 3 fused", SLICE3 + fused + resnet_weights()[0], BATCH)
    check_reference(breaching, "slice 4a deep_leakage", SLICE4["slice 4a deep_leakage"][0], (1, 3, 32, 32),
                    classes=10)
    check_reference(breaching, "slice 4b wei_framework", SLICE4["slice 4b wei_framework"][0], (1, 3, 32, 32))
    check_reference(breaching, "slice 4d modern_hyperparams",
                    SLICE4["slice 4d modern_hyperparams"][0] + resnet_weights()[0], BIG)
    check_reference(breaching, "slice 5a multiscale at a 96x96 stage", MULTISCALE + resnet_weights()[0], STAGE)
    check_large_batch(breaching, LARGE)
    check_reference(breaching, "slice 5c see_through_gradients", SEE_THROUGH, BIG)
    check_imprint_reference(breaching)
    check_fishing_reference(breaching)
    print(f"chip_smoke: phase 4 done at {time.perf_counter() - began:.1f} s", flush=True)

    paths = {"slice 1": run_slice(breaching, ops), "slice 1 restarts": run_restarts(breaching, ops)}
    all_kernels = dict(b1_matching_sums=1, b2_cosine_backward=1, **IMAGE_KERNELS)
    # the image kernels once per attack step, not once per local step of the fedAVG user
    for path, case, overrides, steps, experiments, per_step in (
            ("slice 2 preset", SLICE2, [], SLICE2_STEPS, 1, IMAGE_KERNELS),
            ("slice 2 fused", SLICE2, fused, SLICE2_FUSED_STEPS, 1, all_kernels),
            ("slice 2 fleet", SLICE2, [], FLEET_STEPS, FLEET,
             dict(b3_tv_value_and_grad=1, b4_adam_box_step=1)),
            ("slice 3 preset", SLICE3, [], SLICE3_STEPS, 1, IMAGE_KERNELS),
            ("slice 3 fused", SLICE3, fused, SLICE3_FUSED_STEPS, 1, all_kernels)):
        launches = run_resnet(breaching, ops, path, case, overrides, steps, experiments)
        want = {name: n * steps for name, n in per_step.items()}
        require({k: v for k, v in launches.items() if v} == want,
                f"{path}: launches {launches}, the path needs {want}")
        paths[path] = launches
    for path, (overrides, steps, needs) in SLICE4.items():
        paths[path] = run_slice4(breaching, ops, path, overrides, steps, needs)
    peaks = {}
    for path, (overrides, steps, needs) in SLICE5.items():
        paths[path], peaks[path] = run_slice5(breaching, ops, path, overrides, steps, needs)
    accum10, accum1 = peaks["slice 5b inverting_large_batch_cifar"], peaks["slice 5b' grad_accum=1"]
    print(f"slice 5b: peak memory {accum10 / 2**30:.3f} GiB with grad_accum=10, {accum1 / 2**30:.3f} GiB with "
          f"grad_accum=1 ({accum1 / accum10:.2f}x)", flush=True)
    require(accum10 < accum1, "slice 5b: grad_accum=10 does not lower the peak memory")
    paths["slice 6a local DP"] = run_dp(breaching, ops)
    paths.update(run_model_states(breaching, ops))
    paths["slice 6c fedavg local DP"] = run_resnet(breaching, ops, "slice 6c fedavg local DP", SLICE3, DP[:2], 50)
    require({k: v for k, v in paths["slice 6c fedavg local DP"].items() if v} == {k: 50 for k in IMAGE_KERNELS},
            f"slice 6c: launches {paths['slice 6c fedavg local DP']}")
    paths["slice 6d wainakh-whitebox"] = run_wainakh(breaching, ops)
    with tempfile.TemporaryDirectory() as tmp:
        paths["slice 6e checkpointed run"], paths["slice 6e resumed run"] = run_resume(breaching, ops, tmp)
        paths["slice 6f trace_dir"] = run_trace(breaching, ops, tmp)
    paths.update(run_slice7_paths(breaching, ops))
    print(f"chip_smoke: slice 7 done at {time.perf_counter() - began:.1f} s", flush=True)
    paths.update(run_records(breaching, ops))

    print(f"chip_smoke: phase 5 done at {time.perf_counter() - began:.1f} s", flush=True)
    timings = time_kernels(ops, n_params, image_shape)
    slice2 = ("b1_matching_sums", "b2_cosine_backward", "b4_adam_box_step")
    timings2 = time_kernels(ops, N2, BIG, names=slice2, iters=100)
    slice3 = ("b3_tv_value_and_grad", "b4_adam_box_step")
    timings3 = time_kernels(ops, N2, BATCH, names=slice3, iters=100)
    timings4 = {**time_kernels(ops, N2, BIG, names=("b4_adam_box_step soft",), iters=100),
                **time_kernels(ops, N2, OPPONENTS, names=("b3_tv_value_and_grad q=0.5",), iters=100)}
    timings5 = {shape: time_kernels(ops, n_params, shape, names=slice3 if shape != STAGE2 else slice3[:1], iters=100)
                for shape in (LARGE, STAGE, STAGE2)}
    trials = time_trials(ops, n_params)
    configs = launch_configs(n_params, image_shape)
    hosts = host_breakdown(ops, n_params, image_shape)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(counts[name] for counts in paths.values()),
                         launches_by_path={path: counts[name] for path, counts in paths.items()},
                         max_abs_err=errors[name], **timings[name]))
        if f"{name} {BIG}" in timings:
            rows[-1]["at_1x3x224x224"] = timings[f"{name} {BIG}"]
        if f"{name} in place" in timings:
            rows[-1]["at_in_place"] = dict(shape=image_shape, **timings[f"{name} in place"])
        if name in slice2:
            rows[-1]["at_slice2"] = dict(n=N2 if name != "b4_adam_box_step" else BIG,
                                         max_abs_err=errors[f"{name} slice2"], **timings2[name])
        if name in slice3:
            rows[-1]["at_slice3"] = dict(shape=BATCH, max_abs_err=errors[f"{name} slice3"], **timings3[name])
        # slice 4: b4_box_project (4b-c) and b2_axpby (4a') run at slice 1's shapes, timed above
        if name == "b4_adam_box_step":
            rows[-1]["at_slice4"] = dict(shape=BIG, signed="soft", max_abs_err=errors["b4_adam_box_step soft"],
                                         **timings4["b4_adam_box_step soft"])
        if name == "b3_tv_value_and_grad":
            rows[-1]["at_slice4"] = dict(shape=OPPONENTS, p=2.0, q=0.5,
                                         max_abs_err=errors[f"{name} slice4 {OPPONENTS} q=0.5"],
                                         **timings4["b3_tv_value_and_grad q=0.5"])
        # slice 5: 5b's 100 images, and two stages of 5a's pyramid
        rows[-1]["at_slice5"] = [dict(shape=shape, max_abs_err=errors[f"{name} slice5 {shape}"],
                                      **timings5[shape][name]) for shape in timings5 if name in timings5[shape]]
        if not rows[-1]["at_slice5"]:
            del rows[-1]["at_slice5"]
        if name in trials:  # the trials form (the fleet's and the restarts' step)
            rows[-1]["at_trials"] = dict(max_abs_err=errors[f"{name} trials"], **trials[name])
        if name in configs:  # the kernels redesigned for the dispatcher binding
            rows[-1]["launch_config"] = configs[name]
        rows[-1]["host_breakdown"] = hosts[name]
    print(f"device times (cold) under their bound: {under_bound(rows) or 'none'}", flush=True)
    print(f"chip_smoke: phases 2-6 in {time.perf_counter() - began:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
