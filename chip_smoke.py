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
     bounds; the fused Adam step also as the permutation attack calls it on its (P, P)
     matrix (one unboxed row, no sign) at P = 32 and 256; B3 forward, rebuilt as the fused
     TV kernel's value-only form, at every shape the fused kernel is checked at, one launch a
     call, to 1e-5 relative and bit for bit the fused kernel's value at scale 1, with NaN and
     infinite pixels at the boundary (the plain version's non-finite value), repeated and in
     a replayed CUDA graph; slice 16's typed forms (csrc/precision.cu): B1 and the cosine
     backward on a bfloat16 or float16 gradient beside a float32 target, a float32 gradient
     beside a bfloat16 target, and float64, ``b2_axpby`` on float32 beside bfloat16 and on
     float64, at 11,380,173 entries and at 1,000,003 four bytes off a boundary; the fused TV
     kernel (p = q = 1 and p = 2, q = 0.5, and its trials form on 2x1x3x224x224), the box clamp
     and the fused Adam step (hard, no and soft sign, single and trials) on float64 and
     bfloat16 candidates at 1x3x224x224: the sums to 1e-5 (float64 1e-12) of the sum of
     |terms|, every other output to one rounding of its type (float64 1e-12), the clamp exactly;
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
     ResNet-50's class-poisoned head (1e-4) with the class's feature (1e-3); for slice 12
     the TAG gradient on ``gpt2`` (768 x 12, the GPT-2 vocabulary) at one sentence of 32
     tokens, with respect to the embeddings and the token-label logits (1e-3 of each
     leaf's largest entry, the measured figure printed), and for slice 14 the same on
     ``hf-roberta-base`` and ``hf-distilbert``; each HuggingFace family at full width (``gpt2S``,
     ``hf-gpt2``, ``hf-bert``, ``hf-roberta-base``, ``hf-distilbert``, ``hf-bert``'s classifier):
     its parameter count, its float32 task-loss gradient against float64 on the card (1e-4 of
     the largest entry), and for GPT-2 the logits before each changed token bit for bit;
     slice 17's check of this kind (17b) runs in phase 5, after 17a, from 17a's weights;
  5. the main paths end to end through the entry points, each with the kernels'
     launch counts set to 0 just before it and read just after, and each slice's
     seconds printed; slices 11-15 and 17 run in a child process of this script on the
     same card beside slices 1-10 and 16 (most paths leave the card idle most of the time),
     and their output follows slice 16's: slice 1,
     Inverting Gradients with the fused cosine objective on ConvNet-64 /
     CIFAR-10 shapes, and the same with 4 restarts (25 steps; the batched trial step: the
     fused TV kernel, the cosine backward and the Adam step once a step for all
     four, B1 once a trial); slice 2, the bench preset on
     ResNet-18 at ImageNet shapes
     (the repo's trained checkpoint where the checkout holds it, else random
     weights, printed either way) solo, the same with the fused cosine
     objective, and as the 8-experiment fleet through ``reconstruct_fleet`` (25 steps;
     the fused TV kernel and the Adam step once a step for the 8);
     slice 3, the fedAVG user of case 4 on the same ResNet-18 (4 images of
     3x224x224, 4 local SGD steps of 2 images, the JAX package's notebook preset
     ``inverting_gradients_fedavg_imagenet``), with the preset's cosine objective
     and with the fused one; slice 4, the JAX package's other named optimization
     presets (examples/run_example.py): ``deep_leakage`` (the joint attack of data
     and label logits with L-BFGS), the same with the fused euclidean objective,
     ``wei_framework`` and ``beyond_inferring`` on ConvNet-64 (5 outer L-BFGS
     steps each), ``modern_hyperparams`` and ``legacy_hyperparams`` on ResNet-18
     (50 steps each); slice 5, the remaining vision presets: 5a ``multiscale``
     (ResNet-18 on its checkpoint at 224, seven stages 32, 64, ..., 224 of 15
     steps), 5b ``inverting_large_batch_cifar`` (ResNet32-10 on 100 images of
     CIFAR-100's shape with grad_accum=10, 5 steps) and 5b' (the same with
     grad_accum=1, 5 steps, for the peak memory, which grad_accum=10 must
     lower), 5c ``see_through_gradients`` (ResNet-50 on the checkout's
     ResNet50.npz, which it must hold, at 224, 25 steps), 5d
     ``inverting_gradients_fedavg``, ``inverting_gradients_fedavg_cifar`` and
     ``inverting_gradients_resnet18`` (25 steps each); slices 1 and 2 solo take
     150 and 50 steps, slice 3's preset 25; slice 6, the honest server's remaining configuration
     surface: 6a the fedSGD user with per-example clipping (C = 1) and Laplace
     gradient noise on ResNet-18 at 224 (the checkpoint, 4 images, 50 steps),
     where every clipped per-example norm is at most C (1 + 1e-5) and, with
     the noise off, the clipped gradient on the card equals the CPU's to
     1e-12 of its largest entry in float64 and to 1e-4 in float32; 6b the server's model states ``linearized``,
     ``orthogonal`` (every kernel orthonormal to 1e-4 on the card) and
     ``untrained``, 25 steps each; 6c case 4's fedAVG user with its batch
     gradient clipped and noised at every local step (25 steps); 6d
     ``wainakh-whitebox`` labels on ConvNet-64, CIFAR-10, 4 images, equal to
     the CPU's (50 steps); 6e a checkpointed run of 51 steps and a fresh
     attacker resumed from its file of step 50: the restored state bit for
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
     query and the images behind the final gradient printed), 25 attack steps each with
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
     report on the CPU (the CPU tests' tolerances; registered PSNR, whose end point
     rounding moves, held in float64 below), and every user's images registered again on the
     card in float64 and on the CPU in float32 and float64, the CPU's in a child process
     beside the later paths (each user's float64 gap to 0.1 dB, the mean of their float32
     gaps to 0.1 dB, every gap printed); then
     ``simulate_breach`` on
     slice 1 (100 steps) with ``save_reconstruction=True``, whose table row, metrics YAML
     (read back to the metrics) and PNG it checks; slice 11, the rest of the vision stack:
     11a ``rgap`` (cnn6 at 1x3x32x32) and 11b ``april`` (ViT-B/16 APRIL at 224, random
     weights), each attacked again on the CPU on the card's gradient (the largest
     difference printed), 11c ``fishing_optimization_cross_silo`` (ResNet-18, a silo of one
     user with 256 images, 25 steps), 11d ``fishing_analytic_cross_silo`` and
     ``fishing_feature_cross_device`` on ViT-S/16 APRIL at 224 (the image's PSNR and whether
     the fishing isolated it), 11e case 8's silo of 16 users x 8 images at 224 (its aggregate
     to 2e-6 of the users' gradients averaged in float64, then 15 steps), 11f one float32
     gradient of each new model at ImageNet width against float64 on the card (1e-4); 11a,
     11b and 11d launch no port kernel; slice 12, the honest server's text presets: 12a
     ``tag`` (case 10's transformer3, one sentence of 32 tokens of the GPT-2 vocabulary,
     50 steps, no port kernel), 12b ``permutation`` (50 steps, the fused Adam step once a
     step and no other kernel), 12c ``dlg_text`` (3 outer L-BFGS steps) and 12c' the same
     with the fused euclidean objective (B1 and ``b2_axpby`` once per evaluation), 12d case
     9's ``bert-base-uncased`` with ``attack=tag`` and 12e ``tag`` on ``gpt2`` (768 x 12, 15
     steps each, no port kernel), 12e ``permutation`` on ``gpt2`` with 8 sentences (P = 256,
     25 steps): every path's token ids of the vocabulary, its text report complete and
     finite, the permutation's tokens an order of the leaked bag; slice 13, Decepticon and the
     text imprints, no port kernel: 13a ``decepticons_transformer`` (transformer3, 8 sentences
     of 32 tokens, the server's external data, k-means on the host's assignment solver), 13b
     ``decepticons_bert`` (``bert-base-uncased`` at 768 x 12, masked LM, 1 x 512), 13c
     ``decepticons_gpt2``'s server and attack overrides on the port's ``gpt2`` (8 x 512: k-means
     on 4,096 rows), 13d ``robbing_the_fed_text`` and 13e ``curious_abandon_honesty_text`` (128 x
     32 on transformer3, 512 bins): seconds of the server (model, rewiring or block,
     calibration), the user's gradient and the readout by stage and in the solver, peak memory
     and the text report; then the readout again on the CPU from the card's exchange, whose
     tokens must equal the card's but where the card's device decision lay within 1e-5 of
     another (such slots counted and printed; the least margin over every call of a
     supplement); slice 14, the HuggingFace architectures at full width, seed 7, random
     weights, after the card's name and power limit: 14a ``decepticons_gpt2`` on ``gpt2S``
     (GPT-2 with ReLU and its causal mask, 8 x 512), 14b ``decepticons_hf_gpt2`` (``hf-gpt2``)
     and 14c ``decepticons_hf_bert`` (``hf-bert``, 1 x 512, the exact-reference stack), each as
     slice 13's paths with the CPU's readout of the card's exchange; 14d ``tag`` on
     ``hf-roberta-base`` (case 10 as a masked LM) and ``hf-distilbert`` (case 9), 1 x 32, and 14e
     on ``hf-bert``'s classification head (cola, 2 sentences), 15 steps each, no port kernel; 14f
     ``permutation`` on ``hf-gpt2`` (8 x 32, P = 256, 25 steps: the fused Adam step once a
     step, the loss falling); slice 15, seed 7, no port kernel: 15a ``robbing_the_fed`` with
     ``handle_preceding_layers=VAE`` and the server's external data (a VAE of 3x224x224
     trained 200 steps at batch 32, the readout's rows decoded by it) and 15b the same at
     ``position=2`` with 64 bins (a FeatureDecoder of ResNet-18's unmodified 28 x 28 x 128
     prefix, 800 steps at batch 16), each with its training loss (which must fall), seconds,
     peak memory, PSNR and the CPU's decode of the card's rows against the card's (1e-4 of
     the largest entry); ``tag`` on case 10 (transformer3) under 15c the fedAVG user (4
     sentences, 4 local steps of 1, 30 steps, the loss falling; its objective and gradient
     through the unrolled steps on one exchange, card against CPU within 1e-3 of the largest
     entry in float32 and 1e-9 in float64; its idle share from 5 steps under the profiler), 15d the silo of 8 users x 4 sentences, single-step and
     15d' with 2 local steps of 2 (15 steps each; each aggregate within 2e-6 of its users'
     float32 updates averaged in float64), and 15e ``gpt2`` under the fedAVG user (1 x 32, 2
     local steps, 10 steps); slice 16, the attack's precision and trial knobs, ResNet-18 on
     its checkpoint at 224 unless stated, each form's launches counted by its types: 16a
     ``attack.impl.dtype=bfloat16`` with the fused cosine (50 steps; B1 and the cosine
     backward in their bf16-f32 forms once a step), its it/s, idle share and peak memory beside
     slice 2 fused in float32 (3 steps each timed and under the profiler), 16a'' the same
     in float16 (5 steps), 16a' ``case.impl.dtype=bfloat16`` (a bfloat16 candidate and
     targets: every kernel's bfloat16 form, 10 steps), 16a''' its first-order path on ConvNet-64
     (gd, fused euclidean: ``b2_axpby`` and the box clamp, 5 steps), 16b
     ``case.impl.dtype=float64`` (every kernel's float64 form, 10 steps) with its attack
     gradient at one candidate on the card against the CPU's float64 (1e-12 relative on the
     loss, 1e-11 of the largest entry), 16b' ``deep_leakage`` fused on ConvNet-64 in float64
     (L-BFGS, 2 outer steps) and 16b'' 16a''' in float64, 16c ``attack.impl.mixed_precision``
     (25 steps) and its gradient's distance from float32's at one candidate (printed); 16d the batched trial step, 2 trials
     of 10 steps, on the multiscale preset's augmentation, BatchNorm in train mode with
     DeepInversion, case 4's fedAVG user as restarts and as a fleet of 2 users, and
     ``grad_accum=2`` on 2 images (one evaluation per trial a step, TV and Adam once a step);
     16e a run resumed from its checkpoint of L-BFGS (4a, after 2 of 4 outer steps), of 2 gd
     trials one after the other (at the second's step 4 of 8) and of the multiscale attack
     (2 stages of 2 steps, at stage 0's step 1), on cuDNN's deterministic algorithms, each ending as the
     uninterrupted run: the same losses after the resume, best value and reconstruction;
     slice 17, the in-repo trainer (``train_model.train``) after the card's name and power
     limit: 17a case 1's ConvNet-64 at 3x32x32 on the synthetic training split, materialized on
     the card (4,096 images, batches of 128, the device augmentation, 2 epochs, 2 validation
     batches): each epoch's mean loss (the second's below the first's), seconds, images/s and
     validation accuracy, the peak memory, no port kernel launched; its checkpoint reloaded
     through ``construct_model(pretrained=True)``, every tensor equal; 17b two SGD steps from
     that checkpoint on the first 2 materialized batches of 128, on the card and on the CPU:
     the float32 parameters within 1e-4 of each leaf's largest entry (the recalibrated
     statistics' figure and each side's float32 distance from its float64 printed), every leaf
     in float64 within 1e-12, and from a fresh initialization float32's distance from float64
     on the card printed (BatchNorm's batch variance on the smooth synthetic images makes the
     fresh model's float32 steps ill-conditioned on either platform); then slice 1's attack on
     that checkpoint through ``simulate_breach.main_process`` (25 steps, the server's model the
     checkpoint's, B1-B4 once a step, the loss falling); 17c case 10's transformer3 through the
     loader (2 epochs of 10 steps of 8 sentences, the loss falling), its checkpoint reloaded
     alike; slice 18, the multi-device layer, with two ranks that share the one card over gloo
     (the backend rule: NCCL where every rank of a host has a card of its own; two ranks on one
     card measure the code, not the scaling, and no multi-card run was made), in one spawn of
     2 ranks (``parallel.dryrun.run_ranks``): 18a slice 2's preset with the fused cosine
     objective (ResNet-18 on its checkpoint at 1x3x224x224) on 4 trials of unsigned Adam, 25
     steps, under ``attack.impl.sharding=restarts`` (2 x 1), 18b the same with 2 images and 1
     trial under ``batch`` (1 x 2), 18c the same under ``experimental-2d`` (each rank the trial
     whole), each after a one-step warm-up, each trial's losses held to the solo run on the
     card (the first step's to 1e-5 relative, the first three steps' to 1e-4; the 25 steps'
     gap printed beside a second solo run's, since two solo runs on the card part after a few
     steps), each rank's launches of B1-B4 (at least one a step of each on every rank), and
     18b's attack gradient on each rank at the first candidate against its slice of solo's
     (1e-4 of the largest entry); 18d slice 2's preset through
     ``torchrun --standalone --nproc-per-node=1 -m breaching_tpu_torch.simulate_breach ...
     attack.impl.sharding=restarts``, a world of one rank on NCCL; 18e case 8's silo as 11e cut
     it (16 users x 8 images) over the 2 ranks, the aggregate held to the solo silo's arithmetic
     (the same users' float32 gradients summed in their order) and to those gradients averaged in
     float64 (2e-6 of the largest entry), its gap to their float64 gradients printed; 18f the tools: ``fleet_probe`` at a fleet of 8 (25 steps),
     ``measure_asymmetry`` on slice 1 against 17a's checkpoint (25 steps) and ``decepticon_lab``
     simulate then attack on 13a's exchange, whose tokens must equal the readout of the same
     exchange uncached; for
     each optimization path: set-up
     seconds, loss at the start and end of every trial, PSNR and SSIM (of the
     batch put in the true images' order, and the order), it/s (the fleet's aggregate; with L-BFGS also the
     objective's evaluations per second), peak memory and launches per step;
  6. each kernel's time beside its bound, the plain version's time and one
     PyTorch call of the same function (for a fused kernel, the library call of
     the kernel it grew from), each as time per call (100 calls between two events),
     device time (``timing.time_ms``: the calls captured in a CUDA
     graph and replayed, each after a read of 100 MB that evicts its operands
     from the 50 MB L2, whose time is subtracted; and warm, back to back), and
     host time per call (the calls enqueued, no wait); B1, the fused
     cosine backward, the fused TV kernel and the fused Adam step also at
     slice 2's shapes (50 calls), the fused TV kernel and the fused Adam step
     at slice 3's (50 calls), the fused Adam step's soft sign at 1x3x224x224
     and the fused TV kernel at 1x6x224x224 (slice 4's double opponents), the
     fused TV kernel and the fused Adam step at slice 5's 100x3x32x32 and
     1x3x96x96, TV at 1x3x192x192 (50 calls); the box clamp also in place (the
     form slices 4b-c call) beside ``torch.clamp(out=)``; each form of the box clamp
     and ``b2_axpby`` (beside ``torch.add(alpha=)``, at 2,904,970 entries), the
     fused Adam step (beside ``torch.clamp``) and the fused cosine backward (beside
     ``torch.add(alpha=)``) timed in turns with its library call over five rounds
     (medians); the fused Adam step also beside ``torch._fused_adam_`` on one tensor
     of the candidate's shape, where the installed torch has it; the trials forms
     of the fused TV kernel and the fused Adam step at 8x1x3x224x224 and of the
     fused cosine backward at 4 rows of 2,904,970, each beside its T single calls; the
     fused Adam step at the permutation attack's (P, P) matrix, P = 32 and 256, beside
     ``torch._fused_adam_`` on that matrix;
     the launch of ``b2_axpby``, the fused cosine backward, the fused TV kernel and
     the fused Adam step at the paths' shapes (registers, blocks resident per SM,
     grid) and the host time of every kernel's wrapper split into its Python
     wrapper and its dispatcher op; and which device times, if any, come in under
     their bound; slice 16's typed forms at their paths' shapes (B1 and B2 at 11,380,173
     entries, B3 and B4 at 1x3x224x224) beside their plain versions and a library call on
     upcast copies where one computes the same function (for the fused cosine backward
     ``torch.add(alpha=)``, for the fused Adam step ``torch.clamp`` and ``torch._fused_adam_``
     on its type; 50 calls).
Then one JSON line with the kernels (each typed form a row of its own, with its launches
on slice 16's paths), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, without that line, when no CUDA device is present, a kernel does
not build, launch or agree, a kernel of a path was not launched as often as the
path needs (on slice 4's L-BFGS paths: B1 and ``b2_axpby`` once per evaluation of
the objective, TV once per evaluation, ``b4_box_project`` once per outer step; on the
fleet and the restarts, TV and the Adam step once a step for every trial, and on the
restarts the cosine backward too), an
attack's loss does not fall (on slice 4: its best value stays at its first, or a
loss is not finite; on slice 5a: a stage's), an experiment of the fleet does not
keep its own labels, a batch's order is not a permutation, or a check of slice 6,
slice 10 or slice 11 fails. A loss that turns non-finite fails every path but the fedAVG users' (slices
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
ITERATIONS = 150
DEVICE = "cuda"
SLICE = ["case=1_single_image_small", "attack=invertinggradients",
         "attack.objective.type=fused-cosine-similarity"]
# slice 2: the JAX package's bench.py preset (ResNet-18, ImageNetAnimals shapes)
SLICE2 = ["case=2_single_imagenet", "attack=invertinggradients", "attack.restarts.num_trials=1",
          "case.user.provide_labels=True", "seed=7"]
SLICE2_STEPS, SLICE2_FUSED_STEPS, FLEET, FLEET_STEPS = 50, 50, 8, 25
RESTARTS, RESTART_STEPS = 4, 25  # slice 1's restarts: the batched trial step on ConvNet-64
# slice 3: the fedAVG user of case 4 on ResNet-18, the JAX package's notebook preset
# inverting_gradients_fedavg_imagenet (examples/run_example.py)
SLICE3 = ["case=4_fedavg_small_scale", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.num_local_updates=4", "case.user.num_data_per_local_update_step=2",
          "case.user.provide_labels=True", "case.user.user_idx=1", "seed=7"]
SLICE3_STEPS, SLICE3_FUSED_STEPS = 25, 25
# slice 4: the JAX package's other named optimization presets (examples/run_example.py):
# path -> (overrides, steps, the launches per step or per objective evaluation it needs)
CASE1 = ["case=1_single_image_small", "seed=7"]
SLICE4 = {
    "slice 4a deep_leakage": (CASE1 + ["attack=deepleakage", "case.user.provide_labels=False"], 5, {}),
    "slice 4a' deep_leakage fused": (CASE1 + ["attack=deepleakage", "case.user.provide_labels=False",
                                              "attack.objective.type=fused-euclidean"], 5,
                                     dict(b1_matching_sums="evaluation", b2_axpby="evaluation")),
    "slice 4b wei_framework": (CASE1 + ["attack=wei"], 5, dict(b4_box_project="step")),
    "slice 4c beyond_inferring": (CASE1 + ["attack=beyondinfering", "case.data.partition=unique-class",
                                           "case.user.user_idx=1",
                                           "attack.regularization.total_variation.scale=1e-4"], 5,
                                  dict(b3_tv_value_and_grad="evaluation", b4_box_project="step")),
    "slice 4d modern_hyperparams": (["case=2_single_imagenet", "attack=modern", "seed=7"], 50,
                                    dict(b3_tv_value_and_grad="step", b4_adam_box_step="step")),
    "slice 4e legacy_hyperparams": (["case=2_single_imagenet", "attack=legacy", "seed=7"], 50,
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
    "slice 5a multiscale": (MULTISCALE, 15, IMAGE_KERNELS),
    "slice 5b inverting_large_batch_cifar": (LARGE_BATCH + ["attack.impl.grad_accum=10"], 5, IMAGE_KERNELS),
    "slice 5b' grad_accum=1": (LARGE_BATCH + ["attack.impl.grad_accum=1"], 5, IMAGE_KERNELS),
    "slice 5c see_through_gradients": (SEE_THROUGH, 25, IMAGE_KERNELS),
    "slice 5d inverting_gradients_fedavg": (FEDAVG + [
        "case/data=CIFAR10", "case.data.partition=random", "case.model=ResNet18", "case.server.pretrained=False",
        "case.user.user_idx=1", "attack.regularization.total_variation.scale=1e-3"], 25, IMAGE_KERNELS),
    "slice 5d inverting_gradients_fedavg_cifar": (FEDAVG + ["case/data=CIFAR10", "case.model=ConvNet"], 25,
                                                  IMAGE_KERNELS),
    "slice 5d inverting_gradients_resnet18": (["case=2_single_imagenet", "attack=invertinggradients", "seed=7"], 25,
                                              IMAGE_KERNELS),
}
# slice 6: the honest server's remaining configuration surface, ResNet-18 at 224 on its
# checkpoint, 4 images with their labels (6a-6c, 6e), ConvNet-64 for the labels (6d)
LDP = "case.user.local_diff_privacy"
SLICE6 = ["case=2_single_imagenet", "attack=invertinggradients", "case.user.num_data_points=4",
          "case.user.provide_labels=True", "seed=7"]
CLIP = 1.0
DP = [f"{LDP}.per_example_clipping={CLIP}", f"{LDP}.gradient_noise=1e-3", f"{LDP}.distribution=laplacian"]
SLICE6_STEPS, STATE_STEPS, RESUME_STEPS = 50, 25, 50
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
SLICE7_STEPS = 25  # 7c, 7d and 11c
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
# Registered PSNR runs 500 Adam steps of registration on each side, and rounding moves where
# they end: on the H100's runs the same tensors' float32 and float64 registrations lay up to
# 0.468 dB apart on the card and 0.455 dB on the CPU, the card's float64 one 0.057 dB from the
# CPU's float64 one, and the card's float32 figure up to 0.107 dB from the CPU's (user 0 of
# BENCHMARK; 0.028 dB at most in eleven readings before), the mean over the 8 users 0.007-0.025
# dB; one card float32 figure lay 0.5204 dB from the CPU's (PR 20). So each user's float64
# figure on the card is held to the CPU's float64 one within 0.1 dB, and the mean of the users'
# float32 gaps within 0.1 dB. The CPU's registrations (about 10 s a user and precision) run in
# a child process of RPSNR_THREADS threads beside the card's later paths
REPORT_RELATIVE = dict(mse=1e-5, psnr=1e-5, max_mse=1e-5, lpips=1e-5, feat_mse=1e-4)
REPORT_ABSOLUTE = dict(ssim=1e-5, cw_ssim=1e-5, gabor_cw_ssim=1e-5)
RPSNR_USER64, RPSNR_MEAN, RPSNR_THREADS = 0.1, 0.1, 4
# slice 11: the rest of the vision stack, seed 7: examples/run_example.py's rgap (cnn6 at
# 1x3x32x32, labels by wainakh-simple) and april (vit_base_april at 224, random weights: the
# repo holds no ViT checkpoint); fishing_optimization_cross_silo (ResNet-18 on its checkpoint,
# a silo of one user with 256 images over 32 clients, 200 clsattack steps);
# fishing_analytic_cross_silo and fishing_feature_cross_device on vit_small_april at 224, the
# latter with 6 estimation users where the preset asks 55: the synthetic training split holds
# 50,000 images, 126 of the target class, so 7 users of 16 (the target and 6 others);
# case 8's secure-aggregation silo cut from 1,000 users x 1,000 images to 16 x 8 (1,000 x
# 1,000 at 3x224x224 is 602 GB of float32), 50 invertinggradients steps on its 128 images;
# and the new models at ImageNet width, one parameter gradient of 2 images at 224 each
RGAP = ["case=1_single_image_small", "attack=rgap", "case.model=cnn6", "case.user.provide_labels=False", "seed=7"]
APRIL = ["case=2_single_imagenet", "attack=april_analytic", "case.model=vit_base_april", "seed=7"]
CROSS_SILO = ["case=2_single_imagenet", "attack=clsattack", "case/server=malicious-fishing",
              "case/user=multiuser_aggregate", "case.user.user_range=[0,1]", "case.data.partition=random",
              "case.user.num_data_points=256", "case.data.default_clients=32", "case.user.provide_labels=True",
              "case.server.target_cls_idx=0", "seed=7"]
ANALYTIC_SILO = ["case=2_single_imagenet", "attack=april_analytic", "case/server=malicious-fishing",
                 "case.model=vit_small_april", "case.data.partition=unique-class", "case.user.num_data_points=50",
                 "case.user.user_idx=1", "case.user.provide_labels=True", "case.server.target_cls_idx=0",
                 "case.server.bias_multiplier=0", "case.server.reset_param_weights=False", "seed=7"]
FEATURE_DEVICE = ["case=2_single_imagenet", "attack=april_analytic", "case/server=malicious-fishing",
                  "case.model=vit_small_april", "case.data.partition=feat_est",
                  "case.data.examples_from_split=training",
                  "case.data.default_clients=56", "case.server.target_cls_idx=2", "case.data.target_label=2",
                  "case.user.num_data_points=16", "case.data.num_data_points=16", "case.user.provide_labels=True",
                  "case.server.feature_estimation_users=6", "seed=7"]
CASE8_USERS, CASE8_IMAGES, CASE8_STEPS = 16, 8, 15
CASE8 = ["case=8_industry_scale_fl", "attack=invertinggradients", f"case.user.user_range=[0,{CASE8_USERS}]",
         f"case.user.num_data_points={CASE8_IMAGES}", f"attack.optim.max_iterations={CASE8_STEPS}",
         "attack.optim.callback=25", "seed=7"]
ZOO = ("resnetgn18", "VGG11", "densenet121", "nfnet_f0", "vit_small", "vit_base")
# NFNet's ImageNet stem leaves odd maps at 224 (53x53), where a downsampling block's
# average-pool shortcut (26x26) and its strided convolution (27x27) disagree, in the JAX
# package as in the port; 236 is the nearest size above 224 that it takes
ZOO_SIZE = dict(nfnet_f0=236)
# slice 12: the honest server's text presets (examples/run_example.py), seed 7, on case 10
# (transformer3, one sentence of 32 tokens of the GPT-2 vocabulary of 50,257) and case 9
# (bert-base-uncased, masked LM): path -> (overrides, steps, the launches per step or per
# objective evaluation it needs, whether the loss must fall). The JAX package's preset
# sizes; 12a-12b cut to 50 steps, 12d and 12e (768 x 12) to 15, which lie inside the TAG
# optimizer's 50-step warmup, so their loss need not fall yet; nor need L-BFGS's in 12c's 3
# outer steps (over 10, from the CPU's draws at seed 7 it rose, 11.21 to 44.03; from the card's it
# fell, 13.15 to 6.10; the JAX package's L-BFGS follows the port's step for step on the linear
# model, tests/test_torch_text_presets.py); 12e's permutation takes 8 sentences
# (P = 256) from a user of the 1,000-client partition (the default's 29,337 clients leave a
# user 6 of the synthetic corpus's 200,000 sentences)
CASE10 = ["case=10_causal_lang_training", "seed=7"]
DLG_TEXT = CASE10 + ["attack=deepleakage", "case.user.provide_labels=False", "attack.optim.callback=5"]
SLICE12 = {
    "slice 12a tag": (CASE10 + ["attack=tag"], 50, {}, True),
    "slice 12b permutation": (CASE10 + ["attack=permutation"], 50, dict(b4_adam_box_step="step"), True),
    "slice 12c dlg_text": (DLG_TEXT, 3, {}, False),
    "slice 12c' dlg_text fused": (DLG_TEXT + ["attack.objective.type=fused-euclidean"], 3,
                                  dict(b1_matching_sums="evaluation", b2_axpby="evaluation"), False),
    "slice 12d bert-base-uncased tag": (["case=9_bert_training", "attack=tag", "seed=7"], 15, {}, False),
    "slice 12e gpt2 tag": (CASE10 + ["attack=tag", "case.model=gpt2"], 15, {}, False),
    "slice 12e gpt2 permutation": (CASE10 + ["attack=permutation", "case.model=gpt2", "case.user.num_data_points=8",
                                             "case.data.default_clients=1000"], 25,
                                   dict(b4_adam_box_step="step"), False),
}
# slice 13: Decepticon and the text imprints (examples/run_example.py's presets), seed 7, random
# weights, each through construct_case, run_protocol, prepare_attack, reconstruct and report:
# 13a decepticons_transformer (transformer3, case 10's vocabulary of 50,257, 8 sentences x 32
# tokens, the server's external data, k-means on the assignment solver), 13b decepticons_bert
# (bert-base-uncased at 768 x 12, masked LM, 1 x 512), 13c decepticons_gpt2's server and attack
# overrides on the port's own gpt2 (768 x 12, pre-LN, tied; the HuggingFace gpt2S stays refused),
# 8 x 512, so that k-means clusters 4,096 rows, 13d robbing_the_fed_text and 13e
# curious_abandon_honesty_text (128 x 32 on transformer3, 512 bins). No port kernel runs on them.
DECEPTICON = CASE10 + ["attack=decepticon", "case/server=malicious-transformer", "case.user.user_idx=1"]
TEXT_IMPRINT = CASE10 + ["attack=imprint", "case.user.num_data_points=128", "case.user.user_idx=1",
                         "case.data.default_clients=1000", "case.server.model_modification.num_bins=512"]
PMOD = "case.server.param_modification"
# decepticons_gpt2's (and decepticons_hf_gpt2's) overrides but the model: 8 x 512
GPT2_DECEPTICON = DECEPTICON + [
    "case.user.num_data_points=8", "case.data.shape=[512]", "case.data.batch_size=8",
    "case.data.default_clients=1000", f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e6",
    f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm", "attack.embedding_token_weight=0.25"]
SLICE13 = {
    "slice 13a decepticons_transformer": DECEPTICON + ["case.user.num_data_points=8", "case.data.batch_size=8",
                                                       "case.data.default_clients=1000"],
    "slice 13b decepticons_bert": ["case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer",
                                   "case.model=bert-base-uncased", "case.user.num_data_points=1",
                                   "case.user.user_idx=1", "case.data.shape=[512]", "seed=7"],
    "slice 13c decepticons_gpt2 on gpt2": GPT2_DECEPTICON + ["case.model=gpt2"],
    "slice 13d robbing_the_fed_text": TEXT_IMPRINT + ["case/server=malicious-model-rtf",
                                                      "case.server.model_modification.linfunc=randn"],
    "slice 13e curious_abandon_honesty_text": TEXT_IMPRINT + [
        "case/server=malicious-model-cah", "case.server.model_modification.sigma=0.5",
        "case.server.model_modification.mu=0", "case.server.model_modification.scale_factor=0.999"],
}
# slice 14: the HuggingFace architectures written without transformers (hf_models.py), seed 7, random
# weights, at full width and the presets' sizes: 14a-14c the readouts of decepticons_gpt2 (gpt2S: GPT-2
# with ReLU and its causal mask), decepticons_hf_gpt2 (hf-gpt2, GELU-new) and decepticons_hf_bert (hf-bert,
# 1 x 512, the exact-reference stack), each read again on the CPU from the card's exchange; 14d tag on
# hf-roberta-base (case 10 as a masked LM, 514 positions) and hf-distilbert (case 9), 1 x 32 tokens, and
# 14e on hf-bert's sequence-classification head (cola, 2 sentences), 15 steps each,
# inside the TAG optimizer's warmup, so that their loss need not fall yet; 14f permutation on hf-gpt2 (8 x 32, P = 256,
# the bag from the embedding's gradient norms: GPT-2's head has no decoder bias), 25 steps, the fused Adam
# step once a step, the loss falling
SLICE14_READOUT = {
    "slice 14a decepticons_gpt2": GPT2_DECEPTICON + ["case.model=gpt2S"],
    "slice 14b decepticons_hf_gpt2": GPT2_DECEPTICON + ["case.model=hf-gpt2"],
    "slice 14c decepticons_hf_bert": [
        "case=9_bert_training", "attack=decepticon", "case/server=malicious-transformer", "case.model=hf-bert",
        "case.user.num_data_points=1", "case.data.shape=[512]", "case.user.user_idx=1",
        f"{PMOD}.reset_embedding=True", f"{PMOD}.v_length=32", f"{PMOD}.eps=1e-8", f"{PMOD}.measurement_scale=1e8",
        f"{PMOD}.softmax_skew=1e8", "attack.token_strategy=embedding-norm", "attack.exact_supplement=True",
        "attack.collision_recovery=True", "attack.exact_refinement=2", "attack.embedding_token_weight=0.8", "seed=7"],
}
CASE9 = ["case=9_bert_training", "seed=7"]
COLA = CASE9 + ["case/data=cola", "case.data.task=classification", "case.data.default_clients=1000"]
SLICE14_ATTACK = {
    "slice 14d hf-roberta-base tag": (CASE10 + ["attack=tag", "case.model=hf-roberta-base",
                                                "case.data.task=masked-lm"], 15, {}, False),
    "slice 14d hf-distilbert tag": (CASE9 + ["attack=tag", "case.model=hf-distilbert"], 15, {}, False),
    "slice 14e hf-bert classification tag": (COLA + ["attack=tag", "case.model=hf-bert",
                                                     "case.user.num_data_points=2"], 15, {}, False),
    "slice 14f hf-gpt2 permutation": (CASE10 + ["attack=permutation", "case.model=hf-gpt2",
                                                "case.user.num_data_points=8", "case.data.default_clients=1000",
                                                "attack.token_strategy=embedding-norm"], 25,
                                      dict(b4_adam_box_step="step"), True),
}
# each family at full width: its float32 parameter gradient against float64 on the card (GRADIENT_F64 of
# the largest entry) and, for the causal ones, the logits before a changed token bit for bit
HF_FAMILIES = {
    "gpt2S": CASE10 + ["case.model=gpt2S"],
    "hf-gpt2": CASE10 + ["case.model=hf-gpt2"],
    "hf-bert": CASE9 + ["case.model=hf-bert"],
    "hf-roberta-base": CASE10 + ["case.model=hf-roberta-base", "case.data.task=masked-lm"],
    "hf-distilbert": CASE9 + ["case.model=hf-distilbert"],
    "hf-bert classification": COLA + ["case.model=hf-bert"],
}
# slice 15, seed 7, launching no port kernel: the decoders of handle_preceding_layers=VAE on
# robbing_the_fed (ResNet-18 on its checkpoint, 1 image at 224, the server's external data): 15a
# the top placement (a VAE of the images, 200 steps at batch 32), 15b the block before stage 2
# (64 bins on 28 x 28 x 128 = 100,352 features, a FeatureDecoder of the unmodified prefix, 800
# steps at batch 16); tag on case 10 (transformer3, 32 tokens of 50,257) under 15c the fedAVG
# user (4 sentences, 4 local steps of 1, 30 steps), 15d the silo cut from 1,000 users x 1,000
# sentences to 8 x 4, single-step (the preset's) and 15d' with 2 local steps of 2 (15 steps each),
# and 15e gpt2 (768 x 12) under the fedAVG user, 1 x 32, 2 local steps (10 steps). They lie inside
# tag's 50-step warmup, so 15d-15e's loss need not fall yet; 15c's must
VAE = ["case.server.model_modification.handle_preceding_layers=VAE", "case.server.has_external_data=True"]
SLICE15_DECODERS = {
    "slice 15a robbing_the_fed VAE": RTF + VAE,
    "slice 15b robbing_the_fed VAE position=2": RTF + VAE + ["case.server.model_modification.position=2",
                                                             "case.server.model_modification.num_bins=64"],
}
TEXT_FEDAVG = CASE10 + ["attack=tag", "case/user=local_updates"]
TEXT_SILO = CASE10 + ["attack=tag", "case/user=multiuser_aggregate", "case.user.user_range=[0,8]",
                      "case.user.num_data_points=4"]
SLICE15_TEXT = {
    "slice 15c tag fedAVG": (TEXT_FEDAVG, 30, {}, True),
    "slice 15d tag silo": (TEXT_SILO, 15, {}, False),
    "slice 15d' tag silo 2 local steps": (TEXT_SILO + ["case.user.num_local_updates=2",
                                                       "case.user.num_data_per_local_update_step=2"], 15, {}, False),
    "slice 15e gpt2 tag fedAVG": (TEXT_FEDAVG + ["case.model=gpt2", "case.user.num_data_points=1",
                                                 "case.user.num_local_updates=2"], 10, {}, False),
}
IDLE_STEPS = 5  # 15c's steps timed without and with the profiler, for its idle share
# 15c's objective and its gradient through the fedAVG user's unrolled steps, card against CPU in
# float64 on one exchange (measured 1.6e-16 and 1.9e-15; in float32 8.4e-8 and 1.0e-6)
FEDAVG_TEXT64 = 1e-9
# the CPU's decode of the card's readout rows against the card's (the decoders' convolutions and
# their dense layers of 100,352 inputs summed in other orders in float32)
DECODE = 1e-4
# the card's readout against the CPU's on the card's exchange: a token may differ only where the
# card's device decision was this near another one (its two best scores, or the supplement's
# weighted best score and the slot's cost)
NEAR_TIE = 1e-5
PERMUTATION_SIZES = (32, 256)  # P = sentences x tokens of 12b and 12e
TEXT_REPORT_KEYS = {"accuracy", "token_acc", "bleu", "google_bleu", "sacrebleu", "rouge1", "rouge2", "rougeL",
                    "order", "label_acc", "feat_mse", "parameters"}
# phase 4's TAG gradient on gpt2 (embeddings and token-label logits) on the card against the
# CPU: float32 on both sides through a double backward of 12 layers, sums in other orders
TEXT_GRADIENT = 1e-3
# float32 against float64 on the card: 6a's user gradient lay 3.35e-5 of its largest entry
# from float64 (PR 12), the CPU's 4.0e-7
GRADIENT_F64 = 1e-4
# a float32 sum of 16 users' gradients, then one division, against their mean in float64: at
# most 15 roundings of half an ulp of a running sum up to 16 times the largest entry
SILO_SUM = 2e-6

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
        slice_shape = shape == image_shape
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
    # slice 12: the permutation attack's (P, P) matrix as one unboxed row, no sign
    unused = torch.zeros(1, device=dev)
    for size in PERMUTATION_SIZES:
        check_adam_box_step(ops, image, report_exact, randn, (1, 1, 1, size * size), unused, unused, None,
                            f"b4_adam_box_step slice12 P={size}", boxed=False)
    check_box_project(ops, image, report_exact, randn, image_shape, lo, hi)
    check_tv_value_and_grad(ops, image, report, report_exact, randn, image_shape)
    check_tv_forward(ops, image, report, randn, image_shape)
    check_fused_euclidean(ops, matching, report, randn, n_params)
    check_typed_forms(ops, matching, image, randn, record)
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


def check_tv_forward(ops, image, report, randn, image_shape):
    """b3_tv_forward, rebuilt as the fused TV kernel's value-only form, against its plain
    version at every shape phase 3 gives the fused kernel, p = q = 1 and p = 2, q = 0.5:
    one launch a call, the value to 1e-5 relative and bit for bit the fused kernel's value
    at scale 1; NaN and +-inf pixels at the boundary give the plain version's non-finite
    value; the same bits repeated and in a replayed CUDA graph."""
    name = "b3_tv_forward"
    one = torch.tensor([1.0], device=DEVICE)
    for shape in (image_shape, BIG, BATCH, OPPONENTS, LARGE, STAGE, STAGE2, (2, 3, 331, 1007), (2, 3, 17, 23),
                  (1, 6, 33, 31), (1, 6, 9, 1), (1, 3, 1, 7)):
        x = randn(*shape)
        for p, q in ((1.0, 1.0), (2.0, 0.5)):
            before = ops.tv_forward.launches
            value = ops.tv_forward(x, p, q, 1e-8)
            require(ops.tv_forward.launches == before + 1, f"{name} at {shape}: not one launch a call")
            want = image.tv_forward_plain(x, p, q, 1e-8)
            # a mean of n float32 terms summed in two orders: 1e-5 relative
            report(name, f"{shape} p={p} q={q}", value, want, 1e-5 * abs(want.item()),
                   shape == image_shape and p == q == 1.0)
            fused = ops.tv_value_and_grad(x, one, p, q, 1e-8)[0]
            require(differing_bits(value, fused) == 0,
                    f"{name} at {shape} p={p} q={q}: {value.item()}, the fused kernel's value {fused.item()}")
    cases = 0
    for shape in (image_shape, BIG, (2, 3, 17, 23)):
        H, W = shape[-2:]
        for h, w in ((H // 2, W - 1), (H - 1, W // 2), (0, 0), (H - 1, W - 1)):
            for planted in (float("nan"), float("inf"), float("-inf")):
                for p, q in ((1.0, 1.0), (2.0, 0.5)):
                    x = randn(*shape)
                    x[-1, -1, h, w] = planted
                    value, want = ops.tv_forward(x, p, q, 1e-8), image.tv_forward_plain(x, p, q, 1e-8)
                    require(str(value.item()) == str(want.item()),
                            f"{name} at {shape}, {planted} at ({h}, {w}), p={p} q={q}: {value.item()} against "
                            f"{want.item()}")
                    cases += 1
    print(f"check {name} non-finite pixels at the boundary: {cases} cases, the plain version's non-finite value "
          f"ok", flush=True)
    x, other = randn(*BIG), randn(*BIG)
    first, second, other_want = ops.tv_forward(x), ops.tv_forward(x), ops.tv_forward(other)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ops.tv_forward(x)
    replays = []
    for source in (x.clone(), other):
        x.copy_(source)
        graph.replay()
        replays.append(static.clone())
    same = [differing_bits(got, want) == 0 for got, want in ((second, first), (replays[0], first),
                                                             (replays[1], other_want))]
    print(f"check {name} {BIG} repeated launch and two graph replays: {'ok' if all(same) else 'FAILED'}",
          flush=True)
    require(all(same), f"{name} gives other bits when repeated or replayed: {same}")


def differing_bits(got, want):
    """The entries whose bits differ (NaN with NaN counts as equal)."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int(((got.view(torch.int32) != want.view(torch.int32)) & ~both_nan).sum())


def check_adam_box_step(ops, image, report_exact, randn, shape, lo, hi, signed, slice_shape, report=None,
                        boxed=True):
    """b4_adam_box_step against its plain version over three steps, with NaN and signed
    zeros planted in the gradient and a loss that improves, does not, then improves,
    so that the two best-value buffers swap and the best iterate is taken and kept.
    A 5-dimensional shape is a stack of trials: ``ops.adam_box_step_trials`` (one
    launch a step for every trial, each trial with its own loss and best value) against
    the plain version run on each trial in turn, and bit for bit against the kernel's
    single calls on each trial in turn. ``signed="soft"``: the soft sign at steps 3-5 of
    10 (s = 0.7, 0.6, 0.5), whose tanhf need not round as PyTorch's tanh: NaN in the
    same places, and elsewhere within 4 float32 ulps of each tensor's largest entry
    (``report``); the best values equal. ``boxed=False``: the form a leaf other than the
    image takes (the permutation attack's matrix as one row, bounds of one channel unused),
    recorded under ``slice_shape`` whatever ``signed`` is."""
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
            fn(*args, signed=signed, soft_scale=soft, **({} if boxed else dict(boxed=False)))
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
                report_exact("b4_adam_box_step", where, got[key], want[key],
                             signed and slice_shape if boxed else slice_shape)


def attack_gradient(breaching, device, tree0, overrides):
    """A slice's loss and its gradient at the candidate tree tree0 (``data``, and for
    the joint attack ``labels``, the label logits), on `device`: the gradient of every
    leaf, flattened and joined (``objective_at``'s evaluation of a case built for it)."""
    return objective_at(breaching, device, overrides)(tree0)


def objective_at(breaching, device, overrides):
    """The case of ``overrides`` built once on ``device``, and a function of the candidate
    tree tree0 that gives the loss and its flattened gradient there, as often as called. An
    attack with augmentations (5a) takes one draw of them from a seeded generator on the
    CPU, the same on every device and call."""
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

    def evaluate(tree0):
        tree = {k: v.to(device).requires_grad_(True) for k, v in tree0.items()}
        draws = None
        if attacker.augmentations:  # the same draws on both devices, made on the CPU
            gen = torch.Generator().manual_seed(11)
            draws = [d if d is None or augmentation.host_draws else d.to(device) for augmentation, d in
                     zip(attacker.augmentations,
                         attacker._draw_augmentations(tuple(tree0["data"].shape), (gen, gen)))]
        value, _ = attacker._loss(tree, rec_models, targets, labels, draws)
        grads = torch.autograd.grad(value, tuple(tree.values()))
        return value.item(), torch.cat([g.reshape(-1) for g in grads]).cpu()

    return evaluate


def check_reference(breaching, name, overrides, shape, classes=None):
    """Phase 4: a slice's attack gradient on the card (kernels, cuDNN) against the CPU
    (plain versions), same weights, data and candidate; with ``classes``, the joint
    attack's, with respect to the data and label logits of that many classes."""
    gen = torch.Generator().manual_seed(5)
    x0 = dict(data=torch.randn(*shape, generator=gen))
    if classes:
        x0["labels"] = torch.randn(shape[0], classes, generator=gen)
    on_card = objective_at(breaching, DEVICE, overrides)
    v_gpu, g_gpu = on_card(x0)
    v_again, g_again = on_card(x0)
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
          f"{short(result['labels'])} (true {short(true['labels'])}); PSNR={metrics['psnr']:.3f} "
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


def short(labels, shown=16):
    """A label tensor as a list, its first ``shown`` and the count beyond them."""
    values = labels.tolist()
    return values if len(values) <= shown else f"{values[:shown]} and {len(values) - shown} more"


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
    """6b: the same model and images with each server model state, 25 steps each."""
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
    """6e: 6a's setup with the noise off. Attacker A takes RESUME_STEPS + 1 steps (51), read back
    every RESUME_STEPS / 2 and checkpointed after every chunk (steps 25, 50, 51); a fresh
    attacker B resumes from A's file of step 50. B's restored state equals that file bit for
    bit; B's loss at step 50 equals A's to 1e-6, and B's state after its one step equals A's
    after step 51 to 1e-6 of each tensor's largest entry, in all but 1e-4 of the entries: cuDNN's
    backward need not repeat its bits (phase 4), and the hard sign turns a last-bit
    difference of a gradient entry near 0 into a step the other way. Returns the launch
    counts of A and of B."""
    from breaching_tpu_torch import utils_checkpoint
    from breaching_tpu_torch.attacks import optimization_based_attack as attack_module

    path, at_resume = os.path.join(tmp, "state.npz"), os.path.join(tmp, "state_at_resume.npz")
    saved, restored = {}, []
    save, restore = utils_checkpoint.save_attack_state, attack_module._RunState.restore

    def save_and_keep(target, arrays, iteration):
        save(target, arrays, iteration)
        saved[(target, iteration)] = {k: v.copy() for k, v in arrays.items()}
        if target == path and iteration == RESUME_STEPS:
            shutil.copy(path, at_resume)

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
        cfg.attack.impl.checkpoint_path = at_resume
        second, _, stats, resumed_losses = attack_path(breaching, ops, "slice 6e resumed run", cfg, setup, server,
                                                       shared, payloads, true, 1, require_fall=False)
    finally:
        utils_checkpoint.save_attack_state, attack_module._RunState.restore = save, restore
    require(stats.get("resumed_at") == RESUME_STEPS and restored == [True],
            f"slice 6e: resumed at {stats.get('resumed_at')}, restored state equal to the file: {restored}")
    a, b = saved[(path, RESUME_STEPS + 1)], saved[(at_resume, RESUME_STEPS + 1)]
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
        elif key == "rpsnr":  # held in float64 for every user, check_rpsnr_of_every_user
            ok = True
        elif key == "order":
            ok = (a is None and b is None) or np.array_equal(a, b)
        else:
            ok = a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))
        if not ok:
            failed.append(key)
        print(f"slice 10 report user {user_idx} card against CPU: {key} card={a} cpu={b}"
              f"{'' if ok else ' FAILED'}", flush=True)
    print(f"slice 10 report user {user_idx}: registered PSNR card={card['rpsnr']:.6f} cpu={on_cpu['rpsnr']:.6f} "
          f"(|difference| {abs(card['rpsnr'] - on_cpu['rpsnr']):.3e} dB; held in float64 below); the CPU's "
          f"report took {seconds:.1f} s", flush=True)
    require(not failed, f"slice 10: user {user_idx}'s report on the card disagrees with the CPU in {failed}")


class CpuRegistrations:
    """Every benchmark user's registered PSNR on the CPU in float32 and in float64, computed
    by a child process (``breaching_tpu_torch.rpsnr_spread --cpu``, ``RPSNR_THREADS``
    threads) while the card runs the later paths; ``close`` stops it."""

    def __init__(self, pairs):
        self.tmp = tempfile.TemporaryDirectory()
        images, self.out = (os.path.join(self.tmp.name, name) for name in ("pairs.npz", "cpu.json"))
        np.savez(images, rec=np.stack([rec for rec, _ in pairs]), true=np.stack([true for _, true in pairs]))
        self.log = open(os.path.join(self.tmp.name, "child.log"), "w")
        self.started = time.perf_counter()
        self.process = subprocess.Popen([sys.executable, "-m", "breaching_tpu_torch.rpsnr_spread", "--load", images,
                                         "--cpu", self.out, "--threads", str(RPSNR_THREADS)], cwd=REPO,
                                        stdout=self.log, stderr=subprocess.STDOUT)

    def rows(self):
        """Waits for the child; its rows (``cpu32``, ``cpu64``, their seconds) by user."""
        returncode = self.process.wait()
        self.log.flush()
        with open(self.log.name) as log:
            require(returncode == 0, f"slice 10: the CPU's registrations failed ({returncode}): {log.read()[-2000:]}")
        with open(self.out) as out:
            return json.load(out)

    def close(self):
        if self.process.poll() is None:
            self.process.kill()
            self.process.wait()
        self.log.close()
        self.tmp.cleanup()


def register_every_user(reports, children):
    """Slice 10: each benchmark user's reconstruction and truth as the report registers them
    (denormalized, clamped to [0, 1]), registered on the card in float64 now, and on the CPU
    in float32 and float64 by a ``CpuRegistrations`` child, appended to ``children``.
    Returns (the card's float32 figures, from the reports; its float64 figures)."""
    from breaching_tpu_torch.analysis import metrics as M

    pairs, card64, start = [], [], time.perf_counter()
    for _, _, _, rec, true, payloads in reports:
        metadata = payloads[0]["metadata"]
        dm, ds = (torch.as_tensor(v, device=DEVICE).reshape(1, -1, 1, 1) for v in (metadata.mean, metadata.std))
        den = [torch.clamp(x["data"].detach().to(DEVICE, torch.float32) * ds + dm, 0, 1) for x in (rec, true)]
        pairs.append(tuple(x[0].cpu().numpy() for x in den))
        card64.append(float(M.registered_psnr(*(x.double() for x in den))))
    torch.cuda.synchronize()
    print(f"slice 10 registered PSNR of {len(reports)} users on the card in float64 in "
          f"{time.perf_counter() - start:.1f} s; the CPU's float32 and float64 registrations run in a child process "
          f"({RPSNR_THREADS} threads) beside the later paths", flush=True)
    children.append(CpuRegistrations(pairs))
    return [metrics["rpsnr"] for _, metrics, *_ in reports], card64


def check_rpsnr_of_every_user(card32, card64, child):
    """Slice 10: each benchmark user's registered PSNR, card against CPU on the same tensors.
    Rounding alone moves the 500-step registration's end point by up to 0.468 dB, in float32
    on either platform; so each user's float64 figure on the card is held to the CPU's within
    ``RPSNR_USER64``, and the mean of the users' float32 gaps within ``RPSNR_MEAN``; every
    user's float32 gap is printed, and each float32 figure's gap to the CPU's float64."""
    rows = child.rows()
    gap32 = np.asarray([abs(a - row["cpu32"]) for a, row in zip(card32, rows)])
    gap64 = np.asarray([abs(a - row["cpu64"]) for a, row in zip(card64, rows)])
    for user, (row, a, b) in enumerate(zip(rows, card32, card64)):
        print(f"slice 10 registered PSNR user {user}: card float32={a:.6f} float64={b:.6f}, cpu float32="
              f"{row['cpu32']:.6f} float64={row['cpu64']:.6f}; |card32 - cpu32| {gap32[user]:.3e} dB, |card64 - "
              f"cpu64| {gap64[user]:.3e} dB, |card32 - cpu64| {abs(a - row['cpu64']):.3e} dB, |cpu32 - cpu64| "
              f"{abs(row['cpu32'] - row['cpu64']):.3e} dB", flush=True)
    print(f"slice 10 registered PSNR of {len(rows)} users: |card64 - cpu64| max {gap64.max():.3e} dB (tolerance "
          f"{RPSNR_USER64}); |card32 - cpu32| max {gap32.max():.3e} dB, mean {gap32.mean():.3e} dB (tolerance "
          f"{RPSNR_MEAN}); the CPU's child took {sum(r['cpu32_seconds'] + r['cpu64_seconds'] for r in rows):.1f} s "
          f"of registrations and ended {time.perf_counter() - child.started:.1f} s after it started", flush=True)
    require(gap64.max() <= RPSNR_USER64 and gap32.mean() <= RPSNR_MEAN,
            f"slice 10: registered PSNR on the card is {gap64.max():.3e} dB from the CPU's in float64 (tolerance "
            f"{RPSNR_USER64}), {gap32.mean():.3e} dB in float32 on average (tolerance {RPSNR_MEAN})")


def run_benchmark(breaching, ops, tmp, children):
    """Phase 5, slice 10: the port's ``benchmark_breaches.main_process`` on ``BENCHMARK``,
    the launch counts set to 0 just before it and read just after. Requires a report of
    every key for each of the 8 users (no user's failure swallowed), registered PSNR at
    least the PSNR, the benchmark table (a header and 8 rows) and the averaged row, 8 PNGs
    of 224x224x3 with the reconstructions' pixels, and the fused path's launches: B1 once
    a step for every user, the cosine backward, the fused TV kernel and the Adam step once
    a step for all 8; then registers every user again (``register_every_user``, its CPU
    child appended to ``children``). Returns (the launch counts, the card's float32 and
    float64 registered PSNRs)."""
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
    return launches, register_every_user(reports, children)


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


def on_cpu(tree):
    """A payload's or a shared update's tensors on the CPU (metadata kept as it is)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, list):
        return [on_cpu(v) for v in tree]
    if isinstance(tree, dict) and not hasattr(tree, "modality"):
        return {k: on_cpu(v) for k, v in tree.items()}
    return tree


def run_analytic_on_cpu_too(breaching, ops, path, overrides, later=None):
    """11a-11b: the exchange and the analytic attack on the card through the entry points, no
    port kernel launched; then the same attack on the CPU on the card's payload and gradient,
    or with ``later`` (a thread pool) in a thread beside the later paths, whose comparison
    ``later``'s caller prints when it takes the result. Returns the launch counts and the
    pending comparison (None without ``later``)."""
    import copy

    cfg, setup, user, server, model = build(breaching, overrides)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    rec, _ = attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    metrics = breaching.analysis.report(rec, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
    cpu_setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    cpu_model = copy.deepcopy(server.model).cpu()
    cpu_attacker = breaching.attacks.prepare_attack(cpu_model, server.loss, cfg.attack, cpu_setup)
    cpu_payloads, cpu_shared = on_cpu(payloads), on_cpu(shared)

    def attack_on_cpu():
        start = time.perf_counter()
        cpu_rec, _ = cpu_attacker.reconstruct(cpu_payloads, cpu_shared, server.secrets)
        return cpu_rec, time.perf_counter() - start

    data = rec["data"].cpu()
    require(tuple(data.shape) == tuple(true["data"].shape) and bool(torch.isfinite(data).all()),
            f"{path}: the reconstruction is not a finite {tuple(true['data'].shape)} tensor")
    require(not any(launches.values()), f"{path}: launches {launches}, the path has no port kernel")

    def compare(result):
        cpu_rec, cpu_seconds = result
        want = cpu_rec["data"]
        gap = float((data - want).abs().max() / want.abs().max())
        print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters, {tuple(data.shape)}; "
              f"exchange and attack {seconds:.2f} s on the card (the CPU's attack {cpu_seconds:.2f} s"
              f"{', in a thread beside the later paths' if later else ''}); labels "
              f"{None if rec['labels'] is None else rec['labels'].tolist()} (true {true['labels'].tolist()}); "
              f"PSNR={metrics['psnr']:.3f} "
              f"SSIM={metrics['ssim']:.4f}; largest difference from the CPU's attack on the same gradient {gap:.3e} "
              f"of its largest entry; launches { {k: v for k, v in launches.items() if v} }", flush=True)

    if later is None:
        compare(attack_on_cpu())
        return launches, None
    future = later.submit(attack_on_cpu)
    return launches, lambda: compare(future.result())


def run_exchange_and_attack(breaching, ops, path, overrides, steps):
    """11c: the fishing server's protocol on the card, then ``steps`` attack steps of
    ``attack_path`` (it/s, launches a step, peak memory). Returns the launch counts."""
    cfg, setup, user, server, model = build(breaching, overrides + [f"attack.optim.max_iterations={steps}",
                                                                     "attack.optim.callback=100"])
    require_checkpoint(model, CHECKPOINT)
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    torch.cuda.synchronize()
    info = server.secrets.get("ClassAttack", {})
    print(f"{path}: the server's protocol {time.perf_counter() - start:.2f} s, {user.counted_queries} queries of "
          f"{user.num_users} user(s) x {user.num_data_points} images of {tuple(cfg.case.data.shape)}; target "
          f"{np.asarray(info.get('target_indx')).tolist()} of {info.get('true_num_data')}", flush=True)
    return attack_path(breaching, ops, path, cfg, setup, server, shared, payloads, true, steps)[0]


def run_fishing_april(breaching, ops, path, overrides):
    """11d: a fishing server in front of APRIL through ``main_process``. APRIL fills one slot:
    the target's under the class attack (``ClassAttack``), slot 0 after feature estimation.
    Prints the PSNR of that image against each true image's and the nearest one's label:
    isolated when the nearest is the target itself, or under feature estimation an image of
    the target class."""
    launches, metrics, out, _ = run_slice7(breaching, ops, path, overrides, 0, {})
    info = out["server"].secrets.get("ClassAttack")
    slot = 0 if info is None else int(np.asarray(info["target_indx"]).reshape(-1)[0])
    data, true, labels = out["reconstruction"]["data"], out["true"]["data"], out["true"]["labels"]
    dm, ds = (torch.as_tensor(v, device=data.device).reshape(1, -1, 1, 1) for v in
              (out["server"].cfg_data.mean, out["server"].cfg_data.std))
    truth = torch.clamp(true * ds + dm, 0, 1)
    image = torch.clamp(data[slot:slot + 1] * ds + dm, 0, 1)
    mse = torch.mean((image - truth) ** 2, dim=(1, 2, 3))
    nearest = int(torch.argmin(mse))
    target_cls = int(out["server"].cfg_server.target_cls_idx)
    isolated = nearest == slot if info is not None else int(labels[nearest]) == target_cls
    print(f"{path}: APRIL's image in slot {slot} of {data.shape[0]}: PSNR {10 * math.log10(1 / float(mse[slot])):.3f} "
          f"dB against the true image there; the nearest true image is {nearest} (label {int(labels[nearest])}, PSNR "
          f"{10 * math.log10(1 / float(mse[nearest])):.3f} dB): {'isolated' if isolated else 'not isolated'}",
          flush=True)
    require(not bool(data[torch.arange(data.shape[0], device=data.device) != slot].any()),
            f"{path}: images besides slot {slot} are not zero")
    return launches


def run_case8(breaching, ops):
    """11e: the single-step silo of case 8 on the card; its aggregate (a float32 sum over the
    users, then one division) against the same users' UserSingleStep gradients averaged in
    float64, and beside it the gap to the users' float64 gradients; then the attack."""
    import copy

    from breaching_tpu_torch.cases.users import MultiUserAggregate, UserSingleStep

    path = "slice 11e case 8"
    cfg, setup, user, server, model = build(breaching, CASE8)
    require(isinstance(user, MultiUserAggregate) and user.num_users == CASE8_USERS, f"{path}: not a silo of "
            f"{CASE8_USERS} users")
    require_checkpoint(model, CHECKPOINT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    torch.cuda.synchronize()
    seconds, peak = time.perf_counter() - start, torch.cuda.max_memory_allocated()
    aggregate = shared[0]["gradients"]
    model64 = copy.deepcopy(model).double()
    setup64 = dict(setup, dtype=torch.float64)
    payload64 = dict(payloads[0], parameters={k: v.double() for k, v in payloads[0]["parameters"].items()},
                     buffers=None if payloads[0]["buffers"] is None else
                     {k: v.double() for k, v in payloads[0]["buffers"].items()})
    mean32, mean64 = ({k: torch.zeros_like(g, dtype=torch.float64) for k, g in aggregate.items()} for _ in range(2))
    start = time.perf_counter()
    for pos, (idx, loader) in enumerate(zip(user.user_indices, user.dataloaders)):
        # the user's own images, as the silo drew them
        data = dict(inputs=true["data"][pos * CASE8_IMAGES:(pos + 1) * CASE8_IMAGES].cpu().numpy(),
                    labels=true["labels"][pos * CASE8_IMAGES:(pos + 1) * CASE8_IMAGES].cpu().numpy())
        for sub_model, sub_setup, payload, mean in ((model, setup, payloads[0], mean32),
                                                     (model64, setup64, payload64, mean64)):
            sub = UserSingleStep(sub_model, server.loss, loader, sub_setup, idx, cfg.case.user)
            for k, g in sub.compute_local_updates(payload, custom_data=data)[0]["gradients"].items():
                mean[k] += g.double() / CASE8_USERS
    torch.cuda.synchronize()
    scale = max(float(g.abs().max()) for g in mean32.values())
    gap32 = max(float((aggregate[k].double() - g).abs().max()) for k, g in mean32.items()) / scale
    gap64 = max(float((aggregate[k].double() - g).abs().max()) for k, g in mean64.items()) / scale
    meta = shared[0]["metadata"]
    print(f"{path}: {CASE8_USERS} users x {CASE8_IMAGES} images of {tuple(cfg.case.data.shape)} aggregated in "
          f"{seconds:.2f} s with their images' synthesis (peak {peak / 2**30:.3f} GiB); metadata num_data_points "
          f"{meta['num_data_points']}, num_users {meta['num_users']}; the aggregate {gap32:.3e} of its largest entry "
          f"from the users' float32 gradients averaged in float64, {gap64:.3e} from their float64 gradients "
          f"(the references {time.perf_counter() - start:.2f} s)", flush=True)
    require(meta["num_data_points"] == CASE8_USERS * CASE8_IMAGES and meta["num_users"] == CASE8_USERS
            and true["data"].shape[0] == CASE8_USERS * CASE8_IMAGES, f"{path}: metadata {meta}")
    require(gap32 <= SILO_SUM, f"{path}: the aggregate is {gap32:.3e} from the float64 mean of its users")
    del model64, payload64, mean32, mean64
    torch.cuda.empty_cache()
    return attack_path(breaching, ops, path, cfg, setup, server, shared, payloads, true, CASE8_STEPS)[0]


def check_zoo(breaching):
    """11f: each new model at ImageNet width (case 2's data), one parameter gradient of 2
    images at 224 (``ZOO_SIZE`` where the model takes no 224) in float32 on the card against
    the same in float64 on the card."""
    import copy

    generator = torch.Generator().manual_seed(7)
    for name in ZOO:
        size = ZOO_SIZE.get(name, 224)
        x = torch.randn(2, 3, size, size, generator=generator).to(DEVICE)
        cfg = breaching.get_config(["case=2_single_imagenet", f"case.model={name}", "seed=7"])
        breaching.utils.system_startup(cfg=cfg, device=DEVICE)  # full float32: TF32 off
        model, loss = breaching.cases.construct_model(name, cfg.case.data, generator=generator)
        model = model.to(DEVICE)
        y = torch.tensor([0, 1], device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        grads = torch.autograd.grad(loss(model(x), y), list(model.parameters()))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - start)
        peak = torch.cuda.max_memory_allocated()
        model64 = copy.deepcopy(model).double()
        exact = torch.autograd.grad(loss(model64(x.double()), y), list(model64.parameters()))
        scale = max(float(g.abs().max()) for g in exact)
        gap = max(float((g.double() - e).abs().max()) for g, e in zip(grads, exact)) / scale
        print(f"slice 11f {name}: {sum(p.numel() for p in model.parameters())} parameters; the parameter gradient "
              f"of 2x3x{size}x{size} in {ms:.1f} ms (first call), peak {peak / 2**30:.3f} GiB; {gap:.3e} of its "
              f"largest entry from float64", flush=True)
        require(bool(all(torch.isfinite(g).all() for g in grads)) and gap <= GRADIENT_F64,
                f"slice 11f {name}: the gradient is {gap:.3e} from float64, or not finite")
        del model, model64, grads, exact
        torch.cuda.empty_cache()


def run_slice11(breaching, ops):
    """Phase 5, slice 11: 11a-11f. Returns the launch counts by path."""
    from concurrent.futures import ThreadPoolExecutor

    began = time.perf_counter()
    # 11a's CPU attack (R-GAP's float64 solves on the host, about 45 s) runs in a thread beside
    # 11b-11f; its comparison is printed at the end of the slice
    with ThreadPoolExecutor(max_workers=1) as later:
        paths = {}
        paths["slice 11a rgap"], rgap_on_cpu = run_analytic_on_cpu_too(breaching, ops, "slice 11a rgap", RGAP,
                                                                       later)
        paths["slice 11b april"], _ = run_analytic_on_cpu_too(breaching, ops, "slice 11b april", APRIL)
        paths["slice 11c fishing_optimization_cross_silo"] = run_exchange_and_attack(
            breaching, ops, "slice 11c fishing_optimization_cross_silo", CROSS_SILO, SLICE7_STEPS)
        for path, overrides in (("slice 11d fishing_analytic_cross_silo", ANALYTIC_SILO),
                                ("slice 11d fishing_feature_cross_device", FEATURE_DEVICE)):
            paths[path] = run_fishing_april(breaching, ops, path, overrides)
        paths["slice 11e case 8"] = run_case8(breaching, ops)
        check_zoo(breaching)
        rgap_on_cpu()
    print(f"chip_smoke: slice 11 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths



def run_records(breaching, ops, children):
    """Phase 5, slice 10, in a temporary directory that is also the working directory
    (the averaged benchmark row goes to ``outputs/tables`` there), with LPIPS weights that
    ``LPIPS.random_init`` draws from a seeded generator. Returns (the launch counts by
    path, the card's registered PSNRs of the benchmark's users in float32 and float64);
    the CPU's child is appended to ``children``."""
    from breaching_tpu_torch.analysis.lpips import LPIPS

    previous = os.environ.get("BREACHING_LPIPS_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        weights = os.path.join(tmp, "lpips_alex.npz")
        LPIPS.random_init("alex", generator=torch.Generator().manual_seed(0)).save_npz(weights)
        os.environ["BREACHING_LPIPS_WEIGHTS"] = weights
        try:
            benchmark, registered = run_benchmark(breaching, ops, tmp, children)
            return {"slice 10 benchmark fleet": benchmark,
                    "slice 10 simulate_breach records": run_simulate_records(breaching, ops, tmp)}, registered
        finally:
            if previous is None:
                os.environ.pop("BREACHING_LPIPS_WEIGHTS", None)
            else:
                os.environ["BREACHING_LPIPS_WEIGHTS"] = previous


def text_attack_gradient(breaching, device, tree0, overrides):
    """A text attack's loss and its gradient with respect to each leaf of the candidate
    tree tree0 (embeddings and token-label logits) on ``device``, against the prepared
    target (the embedding leaf zeroed, as the attack matches it); a fedAVG user's update
    through its unrolled local steps."""
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device=device)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    shared, payloads, _ = server.run_protocol(user)
    rec_models, labels, _ = attacker.prepare_attack(payloads, shared)
    attacker.objective.initialize(loss_fn, rec_models[0].module,
                                  attacker._local_hyperparams(attacker._shared_data_cache[0]["metadata"]),
                                  cfg.attack.impl)
    targets = [tuple(attacker._shared_data_cache[0]["gradients"][k] for k in rec_models[0].params)]
    tree = {k: v.to(device).requires_grad_(True) for k, v in tree0.items()}
    value, _ = attacker._loss(tree, rec_models, targets, labels)
    grads = torch.autograd.grad(value, tuple(tree.values()), allow_unused=True, materialize_grads=True)
    return value.item(), {k: g.cpu() for k, g in zip(tree, grads)}


def check_text_reference(breaching):
    """Phase 4, slice 12: 12e's TAG gradient on gpt2 (768 x 12, the GPT-2 vocabulary) at one
    sentence of 32 tokens, with respect to the embeddings and the token-label logits, on the
    card against the CPU, same weights, sentence and candidate."""
    overrides = SLICE12["slice 12e gpt2 tag"][0]
    gen = torch.Generator().manual_seed(5)
    x0 = dict(data=torch.randn(1, 32, 768, generator=gen) * 0.1, labels=torch.randn(1, 32, 50257, generator=gen))
    start = time.perf_counter()
    v_gpu, g_gpu = text_attack_gradient(breaching, DEVICE, x0, overrides)
    card_seconds = time.perf_counter() - start
    v_cpu, g_cpu = text_attack_gradient(breaching, "cpu", x0, overrides)
    v_err = abs(v_gpu - v_cpu) / abs(v_cpu)
    errors = {k: ((g_gpu[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()).item() for k in x0}
    ok = v_err <= 1e-4 and max(errors.values()) <= TEXT_GRADIENT and all(bool(torch.isfinite(g).all())
                                                                         for g in g_gpu.values())
    print(f"reference slice 12e gpt2 tag: loss card={v_gpu:.7f} cpu={v_cpu:.7f} rel_err={v_err:.2e} (tol 1e-4); "
          f"gradient from the largest entry: embeddings {errors['data']:.2e}, token-label logits "
          f"{errors['labels']:.2e} (tol {TEXT_GRADIENT:g}) {'ok' if ok else 'FAILED'} (card side {card_seconds:.1f} s, "
          f"CPU side {time.perf_counter() - start - card_seconds:.1f} s)", flush=True)
    require(ok, "slice 12e's TAG gradient on the card disagrees with the CPU")


def run_text_path(breaching, ops, path, overrides, steps, needs, must_fall):
    """Phase 5, slice 12: a text preset through the entry points, launch counts from the
    attack alone: each kernel of ``needs`` once per outer "step" or once per "evaluation"
    of the objective, no other. Prints the text report. Returns the launch counts."""
    cfg = breaching.get_config(overrides + [f"attack.optim.max_iterations={steps}"])
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
    start = time.perf_counter()
    metrics = breaching.analysis.report(result, true, payloads, server.model, cfg_case=cfg.case, setup=setup)
    report_seconds = time.perf_counter() - start
    losses, evaluations = stats["Trial_0_Val"], stats["objective_evaluations"]
    vocab, tokens = int(cfg.case.data.vocab_size), true["data"]
    shown = {k: round(v, 4) if isinstance(v, float) else v for k, v in metrics.items() if k != "order"}
    print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters (random weights), "
          f"{tuple(tokens.shape)} tokens of a vocabulary of {vocab}; {cfg.attack.optim.optimizer}, "
          f"{cfg.attack.objective.type}; set-up {setup_seconds:.2f} s; {steps} steps in {seconds:.2f} s = "
          f"{steps / seconds:.2f} it/s, {evaluations} objective evaluations = {evaluations / seconds:.1f} "
          f"evaluations/s; loss first={losses[0]:.6f} best={min(losses):.6f} last={losses[-1]:.6f}; peak memory "
          f"{peak / 2**30:.3f} GiB; report in {report_seconds:.2f} s: {shown}; launches per step "
          f"{ {k: v / steps for k, v in launches.items() if v} }", flush=True)
    data = result["data"]
    require(data.dtype == torch.int64 and tuple(data.shape) == tuple(tokens.shape)
            and bool(((data >= 0) & (data < vocab)).all()),
            f"{path}: the reconstruction is not {tuple(tokens.shape)} token ids of the vocabulary")
    require(len(losses) == steps and all(math.isfinite(v) for v in losses),
            f"{path}: {len(losses)} losses for {steps} steps, or a loss that is not finite")
    if must_fall:
        require(min(losses) < losses[0], f"{path}: the best value did not fall below the first")
    require(set(metrics) == TEXT_REPORT_KEYS and all(math.isfinite(v) for k, v in metrics.items() if k != "order"),
            f"{path}: the text report {sorted(metrics)} is not complete and finite")
    if "permutation" in path:  # the assignment orders the leaked bag: the same tokens
        require(torch.equal(torch.sort(data.reshape(-1)).values, torch.sort(attacker._leaked).values),
                f"{path}: the reconstruction is not an order of the leaked tokens")
    want = {name: evaluations if per == "evaluation" else steps for name, per in needs.items()}
    require({k: v for k, v in launches.items() if v} == want,
            f"{path}: launches {launches}, the path needs {want} ({evaluations} evaluations, {steps} steps)")
    return launches


def run_slice12(breaching, ops):
    """Phase 5, slice 12: 12a-12e. Returns the launch counts by path."""
    began = time.perf_counter()
    paths = {path: run_text_path(breaching, ops, path, *spec) for path, spec in SLICE12.items()}
    print(f"chip_smoke: slice 12 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


@contextlib.contextmanager
def recorded_device_decisions(attacker):
    """Records the inputs of the text readout's device decisions, the imprint's nearest-token
    match or each call of Decepticon's full-vocabulary supplement (the additive one or, with
    ``exact_supplement``, the one against exact references); the readout runs unchanged.
    Yields a function that gives, after the readout, each slot's least distance from another
    decision over the calls (None if none ran): the best score's margin over the second best
    and, for a supplement, also the gap between the weighted best score and the slot's cost,
    which decides a replacement."""
    from breaching_tpu_torch.attacks import decepticon_attack as decepticon
    from breaching_tpu_torch.attacks.auxiliaries import text_utils

    calls = []
    match = text_utils.match_embeddings_to_tokens

    def recorded_match(model, embeddings):
        calls.append(dict(kind="match", model=model, embeddings=embeddings))
        return match(model, embeddings)

    def recorded_supplement(recovered_tokens, costs, breached, table, norm_scale, norm_bias, v, weight):
        calls.append(dict(kind="supplement", table=table, costs=np.array(costs), breached=breached,
                          norm_scale=norm_scale, norm_bias=norm_bias, v=v, weight=weight))
        return supplement(recovered_tokens, costs, breached, table, norm_scale, norm_bias, v, weight)

    def recorded_exact(recovered_tokens, costs, ordered, model, shape, v, weight):
        calls.append(dict(kind="exact", costs=np.array(costs), ordered=np.array(ordered), model=model,
                          seq_len=shape[1], v=v, weight=weight))
        return exact(recovered_tokens, costs, ordered, model, shape, v, weight)

    use_abs = "abs" in attacker.cfg.get("matcher", "abs-corrcoef")

    def top_two(states, refs, use_abs):
        found = []
        for chunk in states.split(max(1, 2 ** 28 // refs.shape[0])):
            score = chunk @ refs.T
            found.append((score.abs() if use_abs else score).topk(2, dim=1).values)
        best, second = torch.cat(found).double().cpu().numpy().T
        return best, second

    def exact_top_two(call):
        """The exact supplement's scores (``decepticon_attack.exact_scores``), each slot's
        best two."""
        model, v = call["model"], call["v"]
        device = model.params[model.module.registry["embedding"]].device
        wte, pos_tab, offset, emb_norm, norm = attacker._exact_tables(model, call["seq_len"])
        slots = np.arange(len(call["ordered"])) % call["seq_len"]

        def on_device(array):
            return torch.as_tensor(np.asarray(array, np.float32), device=device)

        emb_norm = None if emb_norm is None else tuple(map(on_device, emb_norm))
        found = [(score.abs() if use_abs else score).topk(2, dim=1).values for score in decepticon.exact_scores(
            on_device(wte), on_device(pos_tab[slots] + offset), emb_norm, *map(on_device, norm),
            on_device(call["ordered"]), v)]
        best, second = torch.cat(found).double().cpu().numpy().T
        return best, second

    def unit(x):
        x = x - x.mean(dim=-1, keepdim=True)
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)

    def call_margins(call):
        with torch.no_grad():
            if call["kind"] == "match":
                table = call["model"].params[call["model"].module.registry["embedding"]].detach()
                flat = call["embeddings"].reshape(-1, call["embeddings"].shape[-1])
                best, second = top_two(unit(flat), unit(table.to(flat)), False)
                return best - second
            if call["kind"] == "exact":
                best, second = exact_top_two(call)
            else:
                table = call["table"]
                scale, bias = (torch.as_tensor(call[k], device=table.device) for k in ("norm_scale", "norm_bias"))
                refs = decepticon._unit_rows(decepticon._torch_layer_norm(table, scale, bias)[1:, call["v"]:-1])
                states = decepticon._unit_rows(torch.as_tensor(call["breached"], dtype=torch.float32,
                                                               device=table.device))
                best, second = top_two(states, refs, use_abs)
            return np.minimum(best - second, np.abs(best * max(call["weight"], 1e-9) - call["costs"]))

    def margins():
        if not calls:
            return None
        return np.min(np.stack([call_margins(call) for call in calls]), axis=0)

    supplement = getattr(attacker, "_supplement_from_full_vocabulary", None)
    exact = getattr(attacker, "_supplement_exact", None)
    if supplement is not None:
        attacker._supplement_from_full_vocabulary = recorded_supplement
        attacker._supplement_exact = recorded_exact
    text_utils.match_embeddings_to_tokens = recorded_match
    try:
        yield margins
    finally:
        text_utils.match_embeddings_to_tokens = match
        if supplement is not None:
            del attacker._supplement_from_full_vocabulary, attacker._supplement_exact


def run_readout_path(breaching, ops, path, overrides):
    """Phase 5, slice 13: a malicious text server and its analytic readout through the entry
    points, the launch counts from the readout alone (none: no port kernel runs here); then
    the readout again on the CPU from the card's exchange, whose tokens must equal the card's
    but where the card's decision lay within NEAR_TIE of another. Prints the seconds by
    stage, the solver's seconds, peak memory and the text report. Returns the launch counts."""
    import copy

    from breaching_tpu_torch import native

    cfg = breaching.get_config(overrides)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    torch.cuda.synchronize()
    server_seconds = time.perf_counter() - start
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    torch.cuda.synchronize()
    user_seconds = time.perf_counter() - start
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    ops.reset_launch_counts()
    native.capacitated_assignment.seconds = 0.0
    with recorded_device_decisions(attacker) as decision_margins:
        start = time.perf_counter()
        rec, stats = attacker.reconstruct(payloads, shared, server.secrets)
        torch.cuda.synchronize()
        readout_seconds = time.perf_counter() - start
    launches = ops.launch_counts()
    solver_seconds = native.capacitated_assignment.seconds
    peak = torch.cuda.max_memory_allocated()
    margins = decision_margins()
    metrics = breaching.analysis.report(rec, true, payloads, server.model, cfg_case=cfg.case, setup=setup)

    cpu_setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    cpu_attacker = breaching.attacks.prepare_attack(copy.deepcopy(server.model).cpu(), server.loss, cfg.attack,
                                                    cpu_setup)
    start = time.perf_counter()
    cpu_rec, _ = cpu_attacker.reconstruct(on_cpu(payloads), on_cpu(shared), server.secrets)
    cpu_seconds = time.perf_counter() - start
    tokens, cpu_tokens = rec["data"].cpu(), cpu_rec["data"]
    near = (torch.as_tensor(margins).reshape(tokens.shape) < NEAR_TIE if margins is not None
            else torch.zeros_like(tokens, dtype=torch.bool))
    differ = tokens != cpu_tokens
    stages = {k: round(v, 3) for k, v in stats.get("decepticon_seconds", {}).items()}
    vocab = int(cfg.case.data.vocab_size)
    print(f"{path}: {model.name} {sum(p.numel() for p in model.parameters())} parameters (random weights), "
          f"{tuple(true['data'].shape)} tokens of a vocabulary of {vocab}; server (model, rewiring or block, "
          f"calibration) {server_seconds:.2f} s, user gradient {user_seconds:.2f} s, readout {readout_seconds:.2f} s "
          f"{stages or ''}, of it the assignment solver {solver_seconds:.3f} s; peak memory {peak / 2**30:.3f} GiB; "
          f"token_acc={metrics['token_acc']:.4f} accuracy={metrics['accuracy']:.4f} bleu={metrics['bleu']:.4f}; "
          f"the CPU's readout on the card's exchange in {cpu_seconds:.2f} s: {int(differ.sum())} of "
          f"{tokens.numel()} tokens differ, {int(near.sum())} slots with the card's decision within {NEAR_TIE} of "
          f"another; launches { {k: v for k, v in launches.items() if v} }", flush=True)
    require(tokens.dtype == torch.int64 and tuple(tokens.shape) == tuple(true["data"].shape)
            and bool(((tokens >= 0) & (tokens < vocab)).all()),
            f"{path}: the reconstruction is not {tuple(true['data'].shape)} token ids of the vocabulary")
    require(set(metrics) == TEXT_REPORT_KEYS and all(math.isfinite(v) for k, v in metrics.items() if k != "order"),
            f"{path}: the text report {sorted(metrics)} is not complete and finite")
    require(not bool((differ & ~near).any()),
            f"{path}: {int((differ & ~near).sum())} tokens differ from the CPU's readout of the card's exchange "
            f"where the card's decision was not a near tie")
    require(not any(launches.values()), f"{path}: launches {launches}, the path has no port kernel")
    return launches


def run_slice13(breaching, ops):
    """Phase 5, slice 13: 13a-13e. Returns the launch counts by path."""
    began = time.perf_counter()
    paths = {path: run_readout_path(breaching, ops, path, overrides) for path, overrides in SLICE13.items()}
    print(f"chip_smoke: slice 13 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


def check_hf_tag_gradients(breaching):
    """Phase 4, slice 14: 14d's TAG gradient on hf-roberta-base and hf-distilbert at one
    sentence of 32 tokens, with respect to the embeddings and the token-label logits, on
    the card against the CPU, same weights, sentence and candidate."""
    for path in ("slice 14d hf-roberta-base tag", "slice 14d hf-distilbert tag"):
        from breaching_tpu_torch.cases.models.hf_models import hf_config

        overrides = SLICE14_ATTACK[path][0]
        data = breaching.get_config(overrides).case
        vocab = int(data.data.vocab_size)
        width = hf_config(str(data.model)[3:], vocab, 32).hidden
        gen = torch.Generator().manual_seed(5)
        x0 = dict(data=torch.randn(1, 32, width, generator=gen) * 0.1,
                  labels=torch.randn(1, 32, vocab, generator=gen))
        start = time.perf_counter()
        v_gpu, g_gpu = text_attack_gradient(breaching, DEVICE, x0, overrides)
        card_seconds = time.perf_counter() - start
        v_cpu, g_cpu = text_attack_gradient(breaching, "cpu", x0, overrides)
        v_err = abs(v_gpu - v_cpu) / abs(v_cpu)
        errors = {k: ((g_gpu[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()).item() for k in x0}
        ok = v_err <= 1e-4 and max(errors.values()) <= TEXT_GRADIENT and all(bool(torch.isfinite(g).all())
                                                                             for g in g_gpu.values())
        print(f"reference {path}: loss card={v_gpu:.7f} cpu={v_cpu:.7f} rel_err={v_err:.2e} (tol 1e-4); gradient "
              f"from the largest entry: embeddings {errors['data']:.2e}, token-label logits {errors['labels']:.2e} "
              f"(tol {TEXT_GRADIENT:g}) {'ok' if ok else 'FAILED'} (card side {card_seconds:.1f} s, CPU side "
              f"{time.perf_counter() - start - card_seconds:.1f} s)", flush=True)
        require(ok, f"{path}: the TAG gradient on the card disagrees with the CPU")


def check_hf_family(breaching, name, overrides):
    """Phase 4, slice 14: one HuggingFace architecture at full width on the card, random
    weights from seed 7: the float32 gradient of its task loss with respect to every
    parameter (2 sentences of 32 tokens) against the same in float64 on the card, within
    GRADIENT_F64 of the largest entry (TF32 off, as system_startup sets it); for GPT-2,
    the logits before each changed token bit for bit (the causal mask), those at it moved."""
    import copy

    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    start = time.perf_counter()
    model, loss_fn = breaching.cases.construct_model(cfg.case.model, cfg.case.data, generator=setup["generator"])
    model.to(DEVICE)
    vocab, task = int(cfg.case.data.vocab_size), cfg.case.data.task
    gen = torch.Generator().manual_seed(7)
    ids = torch.randint(vocab, (2, 32), generator=gen).to(DEVICE)
    if task == "classification":
        labels = torch.randint(int(cfg.case.data.classes), (2,), generator=gen).to(DEVICE)
    elif task == "masked-lm":
        labels = torch.where(torch.rand(2, 32, generator=gen).to(DEVICE) < 0.15, ids, -100)
    else:
        labels = ids

    def gradient(net):
        params = tuple(net.parameters())
        return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss_fn(net(ids), labels), params)])

    g32 = gradient(model)
    g64 = gradient(copy.deepcopy(model).double())
    err = ((g32.double() - g64).abs().max() / g64.abs().max()).item()
    leaves, count = len(list(model.parameters())), sum(p.numel() for p in model.parameters())
    causal = ""
    if getattr(model, "config", None) is not None and model.config.family == "gpt2":
        with torch.no_grad():
            base = model(ids)
            for t in range(ids.shape[1]):
                changed = ids.clone()
                changed[:, t] = (changed[:, t] + 1) % vocab
                logits = model(changed)
                require(torch.equal(logits[:, :t], base[:, :t]) and not torch.equal(logits[:, t], base[:, t]),
                        f"slice 14 {name}: changing token {t} moved a logit before it, or none at it")
        causal = f"; changing token t leaves every logit before t bit for bit, for each t of {ids.shape[1]}"
    torch.cuda.synchronize()
    print(f"reference slice 14 {name}: {model.name} {count} parameters in {leaves} leaves (random weights, "
          f"{task}); float32 parameter gradient from float64 on the card {err:.2e} of its largest entry "
          f"(tol {GRADIENT_F64:g}; TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}){causal} "
          f"({time.perf_counter() - start:.1f} s)", flush=True)
    require(bool(torch.isfinite(g32).all()) and err <= GRADIENT_F64,
            f"slice 14 {name}: the float32 gradient lies {err:.2e} from float64")
    del model


def run_slice14(breaching, ops):
    """Phase 5, slice 14: 14a-14c (the readouts, each read again on the CPU) and 14d-14f (the
    attacks). Returns the launch counts by path."""
    began = time.perf_counter()
    print(f"slice 14 on {card_line()}", flush=True)
    paths = {path: run_readout_path(breaching, ops, path, overrides) for path, overrides in SLICE14_READOUT.items()}
    paths.update({path: run_text_path(breaching, ops, path, *spec) for path, spec in SLICE14_ATTACK.items()})
    print(f"chip_smoke: slice 14 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


@contextlib.contextmanager
def recorded_trainings():
    """Each decoder training of ``aux_training`` (``train_encoder_decoder``,
    ``train_feature_decoder``) while the block is open: its module, seconds and the peak
    memory so far; its ``decode`` is wrapped to record every call's input and images."""
    from breaching_tpu_torch.cases.malicious import aux_training

    record, originals = [], {name: getattr(aux_training, name)
                             for name in ("train_encoder_decoder", "train_feature_decoder")}

    def recorded(train):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            decode, module = train(*args, **kwargs)
            torch.cuda.synchronize()
            entry = dict(module=module, seconds=time.perf_counter() - start, peak=torch.cuda.max_memory_allocated(),
                         calls=[])
            record.append(entry)

            def recorded_decode(rows):
                images = decode(rows)
                entry["calls"].append((torch.as_tensor(rows).detach().clone(), images.detach().clone()))
                return images

            return recorded_decode, module
        return run

    for name, train in originals.items():
        setattr(aux_training, name, recorded(train))
    try:
        yield record
    finally:
        for name, train in originals.items():
            setattr(aux_training, name, train)


def run_decoder_path(breaching, ops, path, overrides):
    """Phase 5, slice 15a-b: robbing_the_fed under ``handle_preceding_layers=VAE`` through
    ``main_process``, no port kernel: the decoder's training (its loss at the first and last
    step, which must fall, seconds and peak memory), the readout's PSNR, and the CPU's
    decode of the card's rows against the card's images (``DECODE`` of their largest entry).
    Returns the launch counts."""
    import copy

    with recorded_trainings() as record:
        launches, metrics, out, _ = run_slice7(breaching, ops, path, overrides, 0, {})
    require(len(record) == 1 and len(record[0]["calls"]) == 1, f"{path}: {len(record)} decoder trainings, "
            f"{[len(e['calls']) for e in record]} decode calls")
    entry = record[0]
    module, losses = entry["module"], entry["module"].losses.cpu()
    rows, images = entry["calls"][0]
    on_cpu = copy.deepcopy(module).cpu().decode(rows.cpu())
    err = float((on_cpu - images.cpu()).abs().max() / images.abs().max())
    secrets = out["server"].secrets["ImprintBlock"]
    print(f"{path}: {type(module).__name__} of {sum(p.numel() for p in module.parameters())} parameters trained "
          f"{len(losses)} steps in {entry['seconds']:.2f} s (peak memory so far {entry['peak'] / 2**30:.3f} GiB), "
          f"loss first={float(losses[0]):.6f} last={float(losses[-1]):.6f}; readout rows of {secrets['shape']} "
          f"{tuple(rows.shape)} decoded to {tuple(images.shape)}; PSNR={metrics['psnr']:.3f} dB "
          f"SSIM={metrics['ssim']:.4f}; the CPU's decode of the card's rows {err:.2e} of the largest entry from the "
          f"card's (tol {DECODE:g})", flush=True)
    require_checkpoint(out["server"].model.victim if hasattr(out["server"].model, "victim") else out["server"].model,
                       CHECKPOINT)
    require(bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0]),
            f"{path}: the decoder's loss did not fall ({float(losses[0])} -> {float(losses[-1])})")
    require(err <= DECODE and math.isfinite(metrics["psnr"]), f"{path}: the CPU decodes the card's rows "
            f"{err:.2e} away, or the PSNR is not finite")
    return launches


def check_fedavg_text_gradient(breaching):
    """Slice 15c: tag's objective and its gradient with respect to the candidate embeddings
    through the fedAVG user's 4 unrolled local steps, on the card and on the CPU, each in
    float32 and float64, on one exchange (the CPU's user's delta: a delta p_4 - p_0 is
    rounded to its parameters' ulps in float32, and TAG's L1 term takes the sign of each
    delta difference, so two devices' own users' deltas move the gradient by 7e-3 of its
    largest entry, and float32 lies 1e-2 from float64 on either device). The card is held
    to the CPU in float32 (1e-4 in value, ``TEXT_GRADIENT`` of the largest entry) and in
    float64 (``FEDAVG_TEXT64``); float32 against float64 is printed."""
    import copy

    overrides = SLICE15_TEXT["slice 15c tag fedAVG"][0]
    cfg = breaching.get_config(overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, _, loss_fn = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    (rec,), _, _ = attacker.prepare_attack(payloads, shared)
    prepared = attacker._shared_data_cache[0]
    hyper = attacker._local_hyperparams(prepared["metadata"])
    target = [prepared["gradients"][k] for k in rec.params]
    width = rec.module.embedding.shape[1]
    vocab, points, tokens = int(cfg.case.data.vocab_size), int(cfg.case.user.num_data_points), int(cfg.case.data.shape[0])
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(points, tokens, width, generator=gen) * 0.1
    soft = torch.softmax(torch.randn(points, tokens, vocab, generator=gen), dim=-1)

    def gradient(device, dtype):
        module = copy.deepcopy(rec.module).to(device, dtype)
        attacker.objective.initialize(loss_fn, module, dict(hyper, labels=hyper["labels"].to(device)), cfg.attack.impl)
        params = {k: v.detach().to(device, dtype).requires_grad_(True) for k, v in rec.params.items()}
        x = x0.to(device, dtype).requires_grad_(True)
        value, _ = attacker.objective(params, {k: v.to(device, dtype) for k, v in rec.buffers.items()},
                                      tuple(t.to(device, dtype) for t in target), x, soft.to(device, dtype))
        return value.item(), torch.autograd.grad(value, x)[0].double().cpu()

    start = time.perf_counter()
    found = {(device, bits): gradient(device, dtype) for device in (DEVICE, "cpu")
             for bits, dtype in ((32, torch.float32), (64, torch.float64))}
    scale = found[("cpu", 64)][1].abs().max()
    errors = {f"{a[0]}{a[1]}-{b[0]}{b[1]}": (abs(found[a][0] - found[b][0]) / abs(found[b][0]),
                                             float((found[a][1] - found[b][1]).abs().max() / scale))
              for a, b in (((DEVICE, 64), ("cpu", 64)), ((DEVICE, 32), ("cpu", 32)), ((DEVICE, 32), (DEVICE, 64)),
                           (("cpu", 32), ("cpu", 64)))}
    (value64, grad64), (value32, grad32) = errors[f"{DEVICE}64-cpu64"], errors[f"{DEVICE}32-cpu32"]
    ok = max(value64, grad64) <= FEDAVG_TEXT64 and value32 <= 1e-4 and grad32 <= TEXT_GRADIENT and all(
        bool(torch.isfinite(g).all()) for _, g in found.values())
    print(f"reference slice 15c tag fedAVG ({cfg.case.user.num_local_updates} unrolled local steps of "
          f"{cfg.case.user.num_data_per_local_update_step}, {tuple(x0.shape)} embeddings): the objective "
          f"{found[(DEVICE, 64)][0]:.9f} on the card in float64; (value, embedding gradient) errors, relative and "
          f"of the largest entry: { {k: f'{v:.2e} / {g:.2e}' for k, (v, g) in errors.items()} } (held: card against "
          f"CPU, tol 1e-4 / {TEXT_GRADIENT:g} in float32, {FEDAVG_TEXT64:g} in float64) {'ok' if ok else 'FAILED'} "
          f"({time.perf_counter() - start:.1f} s)",
          flush=True)
    require(ok, "slice 15c: the TAG gradient through the local steps on the card disagrees with the CPU's")


def text_idle_share(breaching, path, overrides, steps):
    """The idle share of ``steps`` attack steps of a text path on the card: the kernels'
    device time under ``torch.profiler`` against the wall time of the same attack unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    cfg = breaching.get_config(overrides + [f"attack.optim.max_iterations={steps}"])
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    attacker.reconstruct(payloads, shared, server.secrets)  # warm-up
    torch.cuda.synchronize()
    start = time.perf_counter()
    attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        attacker.reconstruct(payloads, shared, server.secrets)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{path}: {steps} steps {wall_ms / steps:.3f} ms a step unprofiled, device busy {busy_ms / steps:.3f} ms a "
          f"step, idle share {1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kernels) / steps:.1f} launches a "
          f"step", flush=True)
    require(busy_ms > 0, f"{path}: the profiler saw no device time")


def check_text_silo(breaching, path, overrides):
    """Slices 15d-d': the text silo on the card, its aggregate (a float32 sum of the users'
    gradients over one division, or the running mean of their deltas) against the same
    users' float32 updates averaged in float64 (``SILO_SUM`` of its largest entry), and the
    shared metadata."""
    from breaching_tpu_torch.cases.users import MultiUserAggregate, UserMultiStep, UserSingleStep

    cfg, setup, user, server, model = build(breaching, overrides)
    require(isinstance(user, MultiUserAggregate), f"{path}: not a silo")
    torch.cuda.synchronize()
    start = time.perf_counter()
    shared, payloads, true = server.run_protocol(user)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    aggregate, meta = shared[0]["gradients"], shared[0]["metadata"]
    mean = {k: torch.zeros_like(g, dtype=torch.float64) for k, g in aggregate.items()}
    user_cls = UserSingleStep if user.num_local_updates == 1 else UserMultiStep
    for idx, loader in zip(user.user_indices, user.dataloaders):
        sub = user_cls(model, server.loss, loader, setup, idx, cfg.case.user)
        for k, g in sub.compute_local_updates(payloads[0])[0]["gradients"].items():
            mean[k] += g.double() / user.num_users
    scale = max(float(g.abs().max()) for g in mean.values())
    gap = max(float((aggregate[k].double() - g).abs().max()) for k, g in mean.items()) / scale
    print(f"{path}: {user.num_users} users x {user.num_data_points} sentences of {cfg.case.data.shape[0]} tokens, "
          f"{user.num_local_updates} local step(s), aggregated in {seconds:.2f} s; metadata data_key "
          f"{meta['data_key']}, num_data_points {meta['num_data_points']}, num_users {meta['num_users']}; the "
          f"aggregate {gap:.3e} of its largest entry from the users' float32 updates averaged in float64 "
          f"(tol {SILO_SUM:g})", flush=True)
    require(meta["data_key"] == "input_ids" and meta["num_users"] == user.num_users
            and meta["num_data_points"] == user.num_users * user.num_data_points
            and tuple(true["data"].shape) == (user.num_users * user.num_data_points, int(cfg.case.data.shape[0])),
            f"{path}: metadata {meta}")
    require(gap <= SILO_SUM, f"{path}: the aggregate is {gap:.3e} from the float64 mean of its users")


def run_slice15(breaching, ops):
    """Phase 5, slice 15: 15a-15b (the decoders) and 15c-15e (tag on the fedAVG user and the
    silo on text), each with the launch counts set to 0 just before it and required 0 just
    after. Returns the launch counts by path."""
    began = time.perf_counter()
    print(f"slice 15 on {card_line()}", flush=True)
    paths = {path: run_decoder_path(breaching, ops, path, overrides) for path, overrides in SLICE15_DECODERS.items()}
    check_fedavg_text_gradient(breaching)
    for path, spec in SLICE15_TEXT.items():
        if "silo" in path:
            check_text_silo(breaching, path, spec[0])
        paths[path] = run_text_path(breaching, ops, path, *spec)
    text_idle_share(breaching, "slice 15c tag fedAVG", TEXT_FEDAVG, IDLE_STEPS)
    print(f"chip_smoke: slice 15 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


# --------------------------------------------------------------------------- slice 16
# the forms of B1-B4 in the types the precision knobs give them (csrc/precision.cu), named
# "<kernel> <types>" as the wrappers count them (ops.launch_counts_by_type)
TYPED_FORMS = ("b1_matching_sums bf16-f32", "b1_matching_sums f16-f32", "b1_matching_sums f32-bf16",
               "b1_matching_sums f64-f64", "b2_cosine_backward bf16-f32", "b2_cosine_backward f16-f32",
               "b2_cosine_backward f32-bf16", "b2_cosine_backward f64-f64", "b2_axpby f32-bf16",
               "b2_axpby f64-f64", "b3_tv_value_and_grad bf16", "b3_tv_value_and_grad f64",
               "b4_box_project bf16", "b4_box_project f64", "b4_adam_box_step bf16", "b4_adam_box_step f64")
PRECISION_SOURCE = "breaching_tpu_torch/csrc/precision.cu"
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16, "f16": torch.float16}
# the tolerance of a typed form's output against its plain version: one rounding of the
# output's type (the two compute alike in the accumulation type), or for float64 1e-12
OUT_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2.0 ** -22, torch.float64: 1e-12}
FUSED16 = ["attack.objective.type=fused-cosine-similarity"]
SLICE16_STEPS, SLICE16_HALF_STEPS, SLICE16_F64_STEPS, SLICE16_MIXED_STEPS, SLICE16_BATCHED_STEPS = 50, 5, 10, 25, 10
SLICE16_TRIALS = 2
SHIFT16 = {"continuous_shift": {"shift": 224, "padding": "circular"}}  # the multiscale preset's augmentation
FORM_LAUNCHES = {}  # slice 16's path -> its launches by form


def check_typed_forms(ops, matching, image, randn, record):
    """Phase 3, slice 16: every typed form against its plain version on the card, at the
    shapes slice 16's paths give it: B1, the cosine backward and ``axpby`` at ResNet-18's
    11,380,173 gradient entries (and 1,000,003 entries 4 bytes off a boundary), B3 and B4
    at 1x3x224x224 and in the trials form on 2x1x3x224x224, B3 also at p = 2, q = 0.5."""
    dev = torch.device(DEVICE)
    for n, offset in ((N2, 0), (1_000_003, 1)):
        base = randn(n + offset), randn(n + offset)
        for form in ("bf16-f32", "f16-f32", "f32-bf16", "f64-f64"):
            rt, dt = (DTYPES[t] for t in form.split("-"))
            r, d = base[0].to(rt)[offset:], base[1].to(dt)[offset:]
            acc = matching.acc_dtype(r)
            got = ops.matching_sums(r, d).double()
            want = matching.matching_sums_plain(r, d).double()
            rw, dw = r.double(), d.double()
            scale = torch.stack([(rw * dw).abs().sum(), (rw * rw).sum(), (dw * dw).sum()])
            tol = (1e-12 if acc == torch.float64 else 1e-5) * scale
            err = (got - want).abs()
            report_typed(f"b1_matching_sums {form}", f"n={n}{' unaligned' if offset else ''}", err, tol, record,
                         not offset)
            g = torch.tensor(0.37, dtype=acc, device=dev)
            sums = ops.matching_sums(r, d)
            got = ops.cosine_backward(sums, g, r, d).double()
            want = matching.cosine_backward_plain(sums, g, r, d).double()
            report_typed(f"b2_cosine_backward {form}", f"n={n}{' unaligned' if offset else ''}", (got - want).abs(),
                         OUT_TOL[rt] * want.abs().max().item(), record, not offset)
            if form in ("f32-bf16", "f64-f64"):
                a, b = torch.tensor([-0.7], dtype=acc, device=dev), torch.tensor([1.3], dtype=acc, device=dev)
                got, want = ops.axpby(a, r, b, d).double(), matching.axpby_plain(a, r, b, d).double()
                report_typed(f"b2_axpby {form}", f"n={n}{' unaligned' if offset else ''}", (got - want).abs(),
                             OUT_TOL[rt] * want.abs().max().item(), record, not offset)
    lo32, hi32 = torch.tensor([-1.9, -2.0, -1.7], device=dev), torch.tensor([2.1, 2.1, 2.0], device=dev)
    for name, dtype in (("bf16", torch.bfloat16), ("f64", torch.float64)):
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        tol = OUT_TOL[dtype]
        scale = torch.tensor([0.2], dtype=dtype, device=dev)
        for shape, p, q in ((BIG, 1.0, 1.0), (BIG, 2.0, 0.5), ((SLICE16_TRIALS, *BIG), 1.0, 1.0)):
            x = randn(*shape).to(dtype)
            trials = len(shape) == 5
            values, grad = (ops.tv_value_and_grad_trials if trials else ops.tv_value_and_grad)(x, scale, p, q)
            want_values, want_grad = (image.tv_value_and_grad_trials_plain if trials
                                      else image.tv_value_and_grad_plain)(x, scale, p, q)
            err = torch.cat([((values.double() - want_values.double()).abs() / want_values.double().abs()).reshape(-1),
                             ((grad.double() - want_grad.double()).abs()
                              / want_grad.double().abs().max()).reshape(-1)])
            report_typed(f"b3_tv_value_and_grad {name}", f"{shape} p={p} q={q}", err, tol, record,
                         shape == BIG and p == 1.0)
        lo, hi = lo32.to(dtype), hi32.to(dtype)
        x = randn(*BIG).to(dtype)
        report_typed(f"b4_box_project {name}", BIG, (ops.box_project(x, lo, hi).double()
                                                     - image.box_project_plain(x, lo, hi).double()).abs(), 0.0,
                     record, True)
        for shape in (BIG, (SLICE16_TRIALS, *BIG)):
            trials = shape[0] if len(shape) == 5 else None
            for signed in (True, False, "soft"):
                x = (0.5 * randn(*shape)).to(dtype)
                args = [x, randn(*shape).to(dtype), (0.1 * randn(*shape)).to(dtype),
                        (0.01 * randn(*shape).abs()).to(dtype), x.clone()]
                per = (trials,) if trials else ()
                vals = [torch.full(per, 0.5, dtype=acc, device=dev), torch.full(per, 1.0, dtype=acc, device=dev)]
                step = ops.AdamStep(0.1, 0.9, 0.999, 1e-8, 0.1, 0.001)
                soft = ops.soft_sign_scalars(3, 10) if signed == "soft" else None
                got = [t.clone() for t in args] + [torch.empty(per, dtype=acc, device=dev)]
                want = [t.clone() for t in args] + [torch.empty(per, dtype=acc, device=dev)]
                kernel = ops.adam_box_step_trials if trials else ops.adam_box_step
                plain = image.adam_box_step_trials_plain if trials else image.adam_box_step_plain
                kernel(*got[:5], lo, hi, *vals, got[5], step, signed=signed, soft_scale=soft)
                plain(*want[:5], lo, hi, *vals, want[5], step, signed=signed, soft_scale=soft)
                err = torch.cat([((a.double() - b.double()).abs() / b.double().abs().max()).reshape(-1)
                                 for a, b in zip(got, want)])
                report_typed(f"b4_adam_box_step {name}", f"{shape} signed={signed}", err, tol, record,
                             shape == BIG and signed is True)


def report_typed(name, shape, err, tol, record, at_path_shape):
    """A typed form's check: every error within ``tol`` (a number, or a tensor of err's shape)."""
    ok = bool((err <= tol).all())
    print(f"check {name} {shape}: max_err={err.max().item():.3e} tol={torch.as_tensor(tol).max().item():.3e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    require(ok, f"{name} disagrees with its plain version at {shape}")
    if at_path_shape:
        record(name, name, err.max().item())


def idle_share(breaching, overrides, steps=3):
    """(it/s unprofiled, idle share, peak bytes) of ``steps`` attack steps on the card: the
    kernels' device time under ``torch.profiler`` against the wall time of the same attack
    unprofiled (the paths before it ran the same step, so nothing is built or tuned here)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = breaching.get_config(overrides + [f"attack.optim.max_iterations={steps}", "attack.optim.callback=0"])
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, _, _ = breaching.cases.construct_case(cfg.case, setup)
    shared, payloads, _ = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        attacker.reconstruct(payloads, shared, server.secrets)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    require(busy > 0, "the profiler saw no device time")
    return steps / wall, 1.0 - busy / wall, peak


def run_resnet16(breaching, ops, path, overrides, steps, form_needs, experiments=1, case=SLICE2):
    """A slice-16 path of ResNet-18 through ``run_resnet``; its launches by form kept in
    ``FORM_LAUNCHES``, each form of ``form_needs`` launched that many times a step."""
    launches = run_resnet(breaching, ops, path, case, overrides, steps, experiments)
    forms = ops.launch_counts_by_type()
    FORM_LAUNCHES[path] = forms
    want = {form: n * steps for form, n in form_needs.items()}
    require(all(forms.get(form) == n for form, n in want.items()),
            f"{path}: launches by form {forms}, the path needs {want}")
    return launches


def run_small16(breaching, ops, path, overrides, steps, form_needs):
    """A slice-16 path on case 1 (ConvNet-64, CIFAR-10 shapes) through the entry points:
    a finite reconstruction in the setup's type and each form of ``form_needs`` launched
    (once per "step" or per objective "evaluation")."""
    cfg, setup, user, server, model = build(breaching, overrides + [f"attack.optim.max_iterations={steps}",
                                                                   "attack.optim.callback=100"])
    shared, payloads, true = server.run_protocol(user)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    start = time.perf_counter()
    result, stats = attacker.reconstruct(payloads, shared, server.secrets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, forms = ops.launch_counts(), ops.launch_counts_by_type()
    FORM_LAUNCHES[path] = forms
    losses, evaluations = stats["Trial_0_Val"], stats["objective_evaluations"]
    print(f"{path}: {cfg.attack.optim.optimizer}, {cfg.attack.objective.type}, candidate "
          f"{result['data'].dtype}; {steps} steps in {seconds:.2f} s, {evaluations} evaluations; loss first="
          f"{losses[0]:.6f} best={min(losses):.6f} last={losses[-1]:.6f}; launches by form {forms}", flush=True)
    require(result["data"].dtype == setup["dtype"] and bool(torch.isfinite(result["data"]).all()),
            f"{path}: the reconstruction is not a finite {setup['dtype']} tensor")
    want = {form: evaluations if per == "evaluation" else steps for form, per in form_needs.items()}
    require(all(forms.get(form) == n for form, n in want.items()), f"{path}: launches by form {forms}, needs {want}")
    return launches


def run_gradient16(breaching, overrides, dtype, second):
    """The attack gradient of slice 2 fused at one candidate: (value, gradient) on the card,
    and again with ``second`` "cpu" on the CPU in the same type, or with ``second`` a context
    on the card under it, on the same case."""
    gen = torch.Generator().manual_seed(5)
    x0 = dict(data=torch.randn(*BIG, generator=gen).to(dtype))
    overrides = SLICE2 + FUSED16 + resnet_weights()[0] + overrides
    on_card = objective_at(breaching, DEVICE, overrides)
    card = on_card(x0)
    if second == "cpu":
        return card, attack_gradient(breaching, "cpu", x0, overrides)
    with second():
        return card, on_card(x0)


def run_resume16(breaching, ops, path, overrides, steps, callback, keep):
    """16e: a checkpointed run (a file after every chunk) and a fresh attacker resumed from
    the file as ``keep(arrays, iteration, section)`` picked it; both on cuDNN's
    deterministic algorithms, so that the resumed run must end as the uninterrupted one:
    every loss after the resume, the best value and the reconstruction equal."""
    from breaching_tpu_torch import utils_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        state, kept = os.path.join(tmp, "state.npz"), os.path.join(tmp, "kept.npz")
        save = utils_checkpoint.save_attack_state

        def save_and_keep(target, arrays, iteration, **section):
            save(target, arrays, iteration, **section)
            if target == state and keep(arrays, iteration, section.get("section")):
                shutil.copy(state, kept)

        deterministic = torch.backends.cudnn.deterministic
        utils_checkpoint.save_attack_state, torch.backends.cudnn.deterministic = save_and_keep, True
        try:
            runs = []
            for target in (state, kept):
                cfg, setup, user, server, model = build(breaching, overrides + [
                    f"attack.optim.max_iterations={steps}", f"attack.optim.callback={callback}",
                    "attack.impl.checkpoint_every=1", f"attack.impl.checkpoint_path={target}"])
                shared, payloads, true = server.run_protocol(user)
                attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
                ops.reset_launch_counts()
                runs.append(attacker.reconstruct(payloads, shared, server.secrets) + (ops.launch_counts(),))
                FORM_LAUNCHES.setdefault(path, ops.launch_counts_by_type())
        finally:
            utils_checkpoint.save_attack_state, torch.backends.cudnn.deterministic = save, deterministic
    (rec, stats, launches), (resumed, resumed_stats, _) = runs
    histories = [k for k in stats if k.endswith("_Val")]
    tails = {k: (stats[k][-len(resumed_stats[k]):] if resumed_stats[k] else []) == resumed_stats[k]
             for k in histories}
    same = torch.equal(rec["data"], resumed["data"]) and stats["opt_value"] == resumed_stats["opt_value"]
    print(f"{path}: resumed at {resumed_stats.get('resumed_at')}; losses after the resume equal {tails}; best value "
          f"{stats['opt_value']:.9f} and {resumed_stats['opt_value']:.9f}; reconstructions "
          f"{'equal' if same else 'differ'} (max |difference| "
          f"{(rec['data'] - resumed['data']).abs().max().item():.3e})", flush=True)
    require("resumed_at" in resumed_stats and all(tails.values()) and same,
            f"{path}: the resumed run does not end as the uninterrupted one")
    return launches


def run_slice16(breaching, ops):
    """Phase 5, slice 16: the attack's precision knobs, the batched trial step on what it
    took one trial at a time before, and checkpoints of L-BFGS, trials one after the
    other and the multiscale attack. Returns the launch counts by path."""
    from breaching_tpu_torch.attacks.auxiliaries.precision import bfloat16_operands

    began = time.perf_counter()
    paths = {}
    fused_pair = dict.fromkeys(("b1_matching_sums", "b2_cosine_backward"), 1)
    # 16a: attack.impl.dtype=bfloat16 (and float16), the fused cosine on half-precision gradients
    for path, dtype, steps in (("slice 16a attack.impl.dtype=bfloat16", "bfloat16", SLICE16_STEPS),
                               ("slice 16a'' attack.impl.dtype=float16", "float16", SLICE16_HALF_STEPS)):
        short_type = "bf16" if dtype == "bfloat16" else "f16"
        paths[path] = run_resnet16(breaching, ops, path, FUSED16 + [f"attack.impl.dtype={dtype}"], steps,
                                   {f"{k} {short_type}-f32": n for k, n in fused_pair.items()})
    rates = {}
    for name, overrides in (("slice 2 fused, float32", FUSED16), ("16a, bfloat16", FUSED16 + [
            "attack.impl.dtype=bfloat16"])):
        rates[name] = idle_share(breaching, SLICE2 + resnet_weights()[0] + overrides)
    print("slice 16a beside slice 2 fused: " + "; ".join(
        f"{name}: {rate:.2f} it/s, idle share {idle:.3f}, peak memory {peak / 2**30:.3f} GiB"
        for name, (rate, idle, peak) in rates.items()), flush=True)
    # 16a': case.impl.dtype=bfloat16, a bfloat16 candidate; 16a''': its L-BFGS-free first-order
    # path through box_project and axpby on ConvNet-64
    paths["slice 16a' case.impl.dtype=bfloat16"] = run_resnet16(
        breaching, ops, "slice 16a' case.impl.dtype=bfloat16", FUSED16 + ["case.impl.dtype=bfloat16"],
        SLICE16_HALF_STEPS, {"b1_matching_sums f32-bf16": 1, "b2_cosine_backward f32-bf16": 1,
                             "b3_tv_value_and_grad bf16": 1, "b4_adam_box_step bf16": 1})
    paths["slice 16a''' bfloat16 gd"] = run_small16(
        breaching, ops, "slice 16a''' bfloat16 gd", CASE1 + [
            "attack=invertinggradients", "attack.objective.type=fused-euclidean", "attack.optim.optimizer=gd",
            "attack.optim.step_size=0.01", "case.impl.dtype=bfloat16"], 5,
        {"b1_matching_sums f32-bf16": "step", "b2_axpby f32-bf16": "step", "b4_box_project bf16": "step"})
    # 16b: case.impl.dtype=float64, and its L-BFGS path (4a' in float64)
    paths["slice 16b case.impl.dtype=float64"] = run_resnet16(
        breaching, ops, "slice 16b case.impl.dtype=float64", FUSED16 + ["case.impl.dtype=float64"], SLICE16_F64_STEPS,
        {"b1_matching_sums f64-f64": 1, "b2_cosine_backward f64-f64": 1, "b3_tv_value_and_grad f64": 1,
         "b4_adam_box_step f64": 1})
    start = time.perf_counter()
    (v_card, g_card), (v_cpu, g_cpu) = run_gradient16(breaching, ["case.impl.dtype=float64"], torch.float64, "cpu")
    v_err, g_err = abs(v_card - v_cpu) / abs(v_cpu), ((g_card - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f"slice 16b: the float64 attack gradient at one candidate, card against CPU: loss {v_card:.15f} and "
          f"{v_cpu:.15f} (relative {v_err:.2e}, tol 1e-12); gradient {g_err:.2e} of its largest entry (tol 1e-11) "
          f"({time.perf_counter() - start:.1f} s)", flush=True)
    require(v_err <= 1e-12 and g_err <= 1e-11 and g_card.dtype == torch.float64,
            "slice 16b: the float64 attack gradient on the card disagrees with the CPU's")
    paths["slice 16b' float64 deep_leakage fused"] = run_small16(
        breaching, ops, "slice 16b' float64 deep_leakage fused", SLICE4["slice 4a' deep_leakage fused"][0] + [
            "case.impl.dtype=float64"], 2, {"b1_matching_sums f64-f64": "evaluation", "b2_axpby f64-f64": "evaluation"})
    paths["slice 16b'' float64 gd"] = run_small16(
        breaching, ops, "slice 16b'' float64 gd", CASE1 + [
            "attack=invertinggradients", "attack.objective.type=fused-euclidean", "attack.optim.optimizer=gd",
            "attack.optim.step_size=0.01", "case.impl.dtype=float64"], 5,
        {"b1_matching_sums f64-f64": "step", "b2_axpby f64-f64": "step", "b4_box_project f64": "step"})
    # 16c: mixed precision, and its gradient's distance from float32's
    paths["slice 16c mixed_precision"] = run_resnet16(
        breaching, ops, "slice 16c mixed_precision", FUSED16 + ["attack.impl.mixed_precision=True"],
        SLICE16_MIXED_STEPS, {})
    mode = []

    def recording():
        mode.append(bfloat16_operands())
        return mode[-1]

    (v32, g32), (vmp, gmp) = run_gradient16(breaching, [], torch.float32, recording)
    print(f"slice 16c: the attack gradient at one candidate with bfloat16 operands against float32: loss "
          f"{vmp:.7f} and {v32:.7f} (relative {abs(vmp - v32) / abs(v32):.2e}); gradient "
          f"{((gmp - g32).abs().max() / g32.abs().max()).item():.2e} of its largest entry; {mode[0].rounded} "
          f"convolutions and products rounded", flush=True)
    require(mode[0].rounded > 0 and math.isfinite(vmp), "slice 16c: nothing was rounded, or the loss is not finite")
    # 16d: the batched trial step on what it took one trial at a time before
    trials = [f"attack.restarts.num_trials={SLICE16_TRIALS}"]
    for path, case, overrides, experiments, augmentations in (
            ("slice 16d augmentations", SLICE2, trials, 1, SHIFT16),
            ("slice 16d BN train + DeepInversion", SLICE2, trials + [
                "case.server.provide_public_buffers=False", "attack.regularization.deep_inversion.scale=0.1"], 1, None),
            ("slice 16d fedAVG restarts", SLICE3, trials, 1, None),
            ("slice 16d fedAVG fleet", SLICE3, [], SLICE16_TRIALS, None),
            ("slice 16d grad_accum=2", SLICE2, trials + ["case.user.num_data_points=2", "attack.impl.grad_accum=2"],
             1, None)):
        paths[path] = run_batched16(breaching, ops, path, case, overrides, experiments, augmentations)
    # 16e: resumed checkpoints
    paths["slice 16e L-BFGS"] = run_resume16(
        breaching, ops, "slice 16e L-BFGS (4a, resumed after 2 of 4 outer steps)", SLICE4["slice 4a deep_leakage"][0],
        4, 2, lambda arrays, iteration, section: iteration == 2)
    paths["slice 16e trials one after the other"] = run_resume16(
        breaching, ops, "slice 16e 2 gd trials one after the other (resumed at the second's step 4 of 8)", CASE1 + [
            "attack=invertinggradients", "attack.optim.optimizer=gd", "attack.optim.step_size=0.01",
            "attack.restarts.num_trials=2"], 8, 4, lambda arrays, iteration, section: section == "trial1"
        and iteration == 4)
    paths["slice 16e multiscale"] = run_resume16(
        breaching, ops, "slice 16e multiscale (2 stages of 2 steps at 112 and 224, resumed at stage 0's step 1)",
        MULTISCALE + resnet_weights()[0] + ["attack.num_stages=2"], 2, 1,
        lambda arrays, iteration, section: arrays["tree/data"].shape[-1] == 112 and iteration == 1)
    print(f"chip_smoke: slice 16 took {time.perf_counter() - began:.1f} s", flush=True)
    return paths


def run_batched16(breaching, ops, path, case, overrides, experiments, augmentations):
    """16d: a path of ResNet-18 at 224 whose trials (restarts, or a fleet of
    ``experiments``) run the batched step: one evaluation per trial a step, the fused TV
    and Adam step once a step for every trial."""
    weight_overrides, weights = resnet_weights()
    cfg = breaching.get_config(case + weight_overrides + overrides + [
        f"attack.optim.max_iterations={SLICE16_BATCHED_STEPS}", "attack.optim.callback=100"])
    setup = breaching.utils.system_startup(cfg=cfg, device=DEVICE)
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    payload_lists, shared_lists = [], []
    for idx in range(experiments):
        if experiments > 1:
            cfg.case.user.user_idx = idx
            user = breaching.cases.construct_user(model, server.loss, cfg.case, setup)
        shared, payloads, true = server.run_protocol(user)
        payload_lists.append(payloads)
        shared_lists.append(shared)
    if augmentations:
        cfg.attack.augmentations = augmentations
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    torch.cuda.synchronize()
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
    FORM_LAUNCHES[path] = ops.launch_counts_by_type()
    steps, trials = SLICE16_BATCHED_STEPS, SLICE16_TRIALS
    histories = [stats[f"Trial_{t}_Val"] for t in range(trials)]
    print(f"{path}: {trials} trials on {weights}, {steps} steps in {seconds:.2f} s = {trials * steps / seconds:.2f} "
          f"trial steps/s; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses first "
          f"{[round(h[0], 6) for h in histories]} last {[round(h[-1], 6) for h in histories]}; "
          f"{stats['objective_evaluations']} evaluations; launches {launches}", flush=True)
    require(all(len(h) == steps for h in histories) and stats["objective_evaluations"] == trials * steps,
            f"{path}: the trials did not run the batched step ({stats['objective_evaluations']} evaluations)")
    require(all(tuple(r["data"].shape) == tuple(true["data"].shape) for r in results),
            f"{path}: a reconstruction of another shape")
    require(histories[0] != histories[1], f"{path}: the trials ran alike")
    want = dict(b3_tv_value_and_grad=steps, b4_adam_box_step=steps)
    require({k: v for k, v in launches.items() if v} == want, f"{path}: launches {launches}, the path needs {want}")
    return launches


# --------------------------------------------------------------------------- slice 18
# the first step's loss (the objective at one candidate) and the first SLICE18_EARLY steps' are held:
# two solo runs on the card part after a few steps, and cuDNN's deterministic algorithms do not always
# keep them together (18a prints both spreads; PERF.md §6); Adam's 25 steps amplify a part to
# 1e-3-1e-2, where a wrong slice, moment or gather moves the losses by O(1) from the second step on;
# the 25 steps' gap is printed beside solo's own; the CPU tests hold the same runs to solo at rtol 1e-5
SLICE18_STEPS, SLICE18_EARLY, SLICE18_FIRST_TOL, SLICE18_TOL, SLICE18_GRAD_TOL = 25, 3, 1e-5, 1e-4, 1e-4
SLICE18_BASE = SLICE2 + ["attack.objective.type=fused-cosine-similarity", "attack.optim.signed=False",
                         f"attack.optim.max_iterations={SLICE18_STEPS}", f"attack.optim.callback={SLICE18_STEPS}"]
SLICE18 = {  # path -> (overrides, sharding mode)
    "slice 18a restarts": (SLICE18_BASE + ["attack.restarts.num_trials=4"], "restarts"),
    "slice 18b batch": (SLICE18_BASE + ["case.user.num_data_points=2", "case.data.batch_size=2"], "batch"),
    "slice 18c experimental-2d": (SLICE18_BASE + ["case.user.num_data_points=2", "case.data.batch_size=2"],
                                  "experimental-2d"),
}
SLICE18_RANKS = 2
NO_MULTI_CARD = "two ranks share one card: this measures the code, not the scaling (no multi-card run was made)"


def user_means(breaching, cfg, setup, user, server, model, payload, true, users, images):
    """The silo's users' float32 gradients summed in float32 in the users' order and divided by
    their number (the solo silo's arithmetic), the same gradients averaged in float64, and their
    float64 gradients averaged (each user's own images, as the silo drew them)."""
    import copy

    from breaching_tpu_torch.cases.users import UserSingleStep

    model64 = copy.deepcopy(model).double()
    setup64 = dict(setup, dtype=torch.float64)
    payload64 = dict(payload, parameters={k: v.double() for k, v in payload["parameters"].items()},
                     buffers=None if payload["buffers"] is None else
                     {k: v.double() for k, v in payload["buffers"].items()})
    mean32, mean64 = ({k: torch.zeros_like(g, dtype=torch.float64) for k, g in payload["parameters"].items()}
                      for _ in range(2))
    solo = {k: torch.zeros_like(g) for k, g in payload["parameters"].items()}
    for pos, (idx, loader) in enumerate(zip(user.user_indices, user.dataloaders)):
        data = dict(inputs=true["data"][pos * images:(pos + 1) * images].cpu().numpy(),
                    labels=true["labels"][pos * images:(pos + 1) * images].cpu().numpy())
        for sub_model, sub_setup, sub_payload, mean in ((model, setup, payload, mean32),
                                                         (model64, setup64, payload64, mean64)):
            sub = UserSingleStep(sub_model, server.loss, loader, sub_setup, idx, cfg.case.user)
            for k, g in sub.compute_local_updates(sub_payload, custom_data=data)[0]["gradients"].items():
                mean[k] += g.double() / users
                if mean is mean32:
                    solo[k] += g
    return {k: g / users for k, g in solo.items()}, mean32, mean64


def launched(counts):
    return {k: v for k, v in counts.items() if v}


def trajectory_gap(got, want, steps=None):
    """The largest relative gap between two runs' losses, trial by trial, over their first
    ``steps`` (all where None)."""
    return max(float(np.max(np.abs(np.asarray(got[k][:steps]) - np.asarray(v[:steps]))
                            / np.maximum(np.abs(np.asarray(v[:steps])), 1e-30))) for k, v in want.items())


def relative_gap(got, want):
    """The largest entry of |got - want| over the largest of |want|, over dicts of arrays."""
    scale = max(float(np.abs(np.asarray(w, dtype=np.float64)).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[k], dtype=np.float64) - np.asarray(w, dtype=np.float64)).max())
               for k, w in want.items()) / scale


def run_slice18(breaching, ops, keep):
    """Phase 5, slice 18 (the module docstring): 18a-c and 18e in one spawn of 2 ranks on the
    card, each held to solo; 18d through ``torchrun``; 18f the tools. Returns the launch
    counts by path (18a-c and 18e summed over the ranks)."""
    from breaching_tpu_torch import decepticon_lab, fleet_probe, measure_asymmetry

    began = time.perf_counter()
    paths = run_ranks18(breaching)
    paths["slice 18d torchrun nccl"] = run_torchrun18()
    paths.update(run_tools18(breaching, ops, keep, decepticon_lab, fleet_probe, measure_asymmetry))
    print(f"chip_smoke: slice 18 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


def run_ranks18(breaching):
    """18a-c, 18b's gradient and 18e in one spawn of 2 ranks on the card, each held to solo."""
    from breaching_tpu_torch.parallel.dryrun import attack_run, run_each, run_ranks

    print(f"slice 18 on {card_line()}: {SLICE18_RANKS} ranks over gloo (NCCL where every rank of a host has a "
          f"card of its own, else gloo); {NO_MULTI_CARD}", flush=True)
    calls = [("attack_run", (overrides, mode, True)) for overrides, mode in SLICE18.values()]
    calls += [("silo_run", (CASE8,)), ("batch_gradient", (SLICE18["slice 18b batch"][0],))]
    start = time.perf_counter()
    ranks = run_ranks(SLICE18_RANKS, run_each, calls, device=DEVICE, timeout=600)
    print(f"slice 18: {SLICE18_RANKS} ranks spawned, ran 18a-c, 18e and 18b's gradient and ended in "
          f"{time.perf_counter() - start:.1f} s", flush=True)
    paths, solos = {}, {}
    for i, (path, (overrides, mode)) in enumerate(SLICE18.items()):
        key = tuple(overrides)
        if key not in solos:  # twice: the card's own spread from run to run
            solos[key] = [attack_run(overrides, None, True, device=DEVICE) for _ in range(2)]
            if not i:  # and twice with cuDNN's deterministic algorithms
                deterministic = torch.backends.cudnn.deterministic
                torch.backends.cudnn.deterministic = True
                try:
                    pair = [attack_run(overrides, None, True, device=DEVICE)["trials"] for _ in range(2)]
                finally:
                    torch.backends.cudnn.deterministic = deterministic
                print(f"{path}: two solo runs part by {trajectory_gap(pair[1], pair[0], 2):.3e} at the second step "
                      f"and {trajectory_gap(pair[1], pair[0]):.3e} over the {SLICE18_STEPS} with cuDNN's deterministic "
                      f"algorithms (not held)", flush=True)
        solo, again = solos[key]
        results = [rank[i] for rank in ranks]
        first, early, gap = (max(trajectory_gap(r["trials"], solo["trials"], steps) for r in results)
                             for steps in (1, SLICE18_EARLY, None))
        trials = len(solo["trials"])
        rates = [(r["part"]["trials"][1] - r["part"]["trials"][0]) * SLICE18_STEPS / r["seconds"] for r in results]
        for rank, r in enumerate(results):
            print(f"{path} rank {rank} of {r['world'][1]} over {r['backend']}: mesh {r['part']['mesh']}, trials "
                  f"{r['part']['trials']}, images {r['part']['images']}; {r['seconds']:.2f} s, {rates[rank]:.1f} it/s; "
                  f"launches {launched(r['launches'])}", flush=True)
            require(r["backend"] == "gloo" and r["world"][1] == SLICE18_RANKS, f"{path}: {r['backend']} {r['world']}")
            require(r["part"]["mode"] == mode, f"{path}: ran as {r['part']['mode']}")
            for name in ("b3_tv_value_and_grad", "b4_adam_box_step", "b1_matching_sums", "b2_cosine_backward"):
                require(r["launches"][name] >= SLICE18_STEPS, f"{path}: rank {rank} launched {name} "
                        f"{r['launches'][name]} times in {SLICE18_STEPS} steps")
            require(np.array_equal(r["data"], results[0]["data"]), f"{path}: the ranks return other reconstructions")
        solo_rate = trials * SLICE18_STEPS / solo["seconds"]
        # the ranks of a line of the model axis run the same trials, except under "batch"
        copies = results[0]["part"]["mesh"]["model"] if results[0]["part"]["mode"] != "batch" else 1
        spread, early_spread = (trajectory_gap(again["trials"], solo["trials"], steps)
                                for steps in (None, SLICE18_EARLY))
        print(f"{path}: {trials} trial(s) x {SLICE18_STEPS} steps, {sum(rates) / copies:.1f} it/s of distinct "
              f"trials over the ranks (solo {solo_rate:.1f} it/s, {solo['seconds']:.2f} s); the largest gap of a "
              f"trial's loss to solo's {first:.3e} relative at the first step (tol {SLICE18_FIRST_TOL}), {early:.3e} "
              f"over the first {SLICE18_EARLY} (tol {SLICE18_TOL}; solo again {early_spread:.3e}); {gap:.3e} over "
              f"the {SLICE18_STEPS} steps beside the second solo run's {spread:.3e} (not held); {NO_MULTI_CARD}",
              flush=True)
        require(first <= SLICE18_FIRST_TOL and early <= SLICE18_TOL,
                f"{path}: the losses are {first:.3e} from solo's at the first step, {early:.3e} over the first "
                f"{SLICE18_EARLY}")
        paths[path] = {name: sum(r["launches"][name] for r in results) for name in KERNELS}
    for rank, r in enumerate(rank[-1] for rank in ranks):
        start, stop = r["images"]
        err = float(np.abs(r["grad"] - r["solo"][start:stop]).max()) / float(np.abs(r["solo"]).max())
        print(f"slice 18b batch rank {rank}: the attack gradient of images {start}:{stop} at the first candidate "
              f"{err:.3e} of the largest entry from its slice of solo's (tol {SLICE18_GRAD_TOL})", flush=True)
        require(err <= SLICE18_GRAD_TOL, f"slice 18b: rank {rank}'s gradient is {err:.3e} from solo's slice")
    silo = [rank[-2] for rank in ranks]
    cfg, setup, user, server, model = build(breaching, CASE8)
    true = {k: torch.as_tensor(v, device=DEVICE) for k, v in silo[0]["true"].items()}  # the ranks' images
    solo, mean32, mean64 = ({k: v.cpu().numpy() for k, v in m.items()} for m in user_means(
        breaching, cfg, setup, user, server, model, server.distribute_payload(), true, CASE8_USERS, CASE8_IMAGES))
    for rank, r in enumerate(silo):
        to_solo, to32, to64 = (relative_gap(r["gradients"], want) for want in (solo, mean32, mean64))
        print(f"slice 18e case 8 silo rank {rank} of {r['world'][1]} over {r['backend']}: {CASE8_USERS} users x "
              f"{CASE8_IMAGES} images, {CASE8_USERS // SLICE18_RANKS} a rank; the aggregate {to_solo:.3e} of its "
              f"largest entry from solo's, {to32:.3e} from the users' float32 gradients averaged in float64 (tol "
              f"{SILO_SUM} for both), {to64:.3e} from their float64 gradients; launches none; {NO_MULTI_CARD}",
              flush=True)
        require(to_solo <= SILO_SUM and to32 <= SILO_SUM, f"slice 18e: rank {rank}'s aggregate is {to_solo:.3e} "
                f"from solo's, {to32:.3e} from the float64 mean")
    paths["slice 18e case 8 silo"] = {name: 0 for name in KERNELS}
    del model, true
    torch.cuda.empty_cache()
    return paths


def run_torchrun18():
    """18d: slice 2's preset (10 steps) through ``torchrun`` as a world of one rank, which takes
    NCCL; its kernel launches from the entry point's log."""
    with tempfile.TemporaryDirectory() as out:
        command = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1", "-m",
                   "breaching_tpu_torch.simulate_breach", *SLICE2, "attack.optim.max_iterations=10",
                   "attack.optim.callback=10", "attack.impl.sharding=restarts", f"base_dir={out}"]
        start = time.perf_counter()
        proc = subprocess.run(command, cwd=REPO, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    launches = next((json.loads(line.split("Kernel launches: ", 1)[1]) for line in log.splitlines()
                     if "Kernel launches: " in line), None)
    started = next((line for line in log.splitlines() if line.startswith("Rank 0 of 1 on ")), "no rank's start")
    print(f"slice 18d torchrun nccl: exit {proc.returncode} in {seconds:.1f} s (process start included); the log: "
          f"'{started}' (a world of one rank is solo itself); launches {launched(launches or {})}", flush=True)
    require(proc.returncode == 0, f"slice 18d: torchrun failed:\n{log[-3000:]}")
    require(" over nccl " in started, "slice 18d: the rank did not start on NCCL")
    require(launches is not None and launches.get("b4_adam_box_step", 0) >= 10, f"slice 18d: launches {launches}")
    return {name: launches.get(name, 0) for name in KERNELS}


def run_tools18(breaching, ops, keep, decepticon_lab, fleet_probe, measure_asymmetry):
    """18f: the four tools' counterparts that run the card (the converter reads files only)."""
    paths = {}
    ops.reset_launch_counts()
    start = time.perf_counter()
    line = fleet_probe.main(["8", "float32", "--iterations", str(SLICE18_STEPS), "--chunk", str(SLICE18_STEPS)],
                            device=DEVICE)
    paths["slice 18f fleet_probe"] = ops.launch_counts()
    print(f"slice 18f fleet_probe (one process, no process group): {json.dumps(line)} "
          f"({time.perf_counter() - start:.1f} s with the exchanges and the warm-up fleet); launches "
          f"{launched(paths['slice 18f fleet_probe'])}", flush=True)
    require(line["fleet"] == 8 and len(line["psnrs"]) == 8 and "vs_baseline" not in line, f"fleet_probe: {line}")
    require(paths["slice 18f fleet_probe"]["b4_adam_box_step"] >= SLICE18_STEPS, "fleet_probe launched no Adam step")
    with tempfile.TemporaryDirectory() as out:
        ops.reset_launch_counts()
        start = time.perf_counter()
        result = measure_asymmetry.main(["--iterations", str(SLICE18_STEPS), "--case", "1_single_image_small",
                                         "--out", out, f"case.data.path={keep}"], device=DEVICE)
        paths["slice 18f measure_asymmetry"] = ops.launch_counts()
        written = sorted(os.listdir(out))
    rows = result["rows"]
    print(f"slice 18f measure_asymmetry on slice 1 against 17a's checkpoint ({SLICE18_STEPS} steps, "
          f"{time.perf_counter() - start:.1f} s): random PSNR {rows['random']['metrics']['psnr']:.3f} grad-norm "
          f"{rows['random']['grad_norm']:.4f}, trained PSNR {rows['trained']['metrics']['psnr']:.3f} grad-norm "
          f"{rows['trained']['grad_norm']:.4f}, gap {result['gap']:+.3f} dB; wrote {written}; launches "
          f"{launched(paths['slice 18f measure_asymmetry'])}", flush=True)
    require(written == ["asymmetry.md", "metrics_asym_random.yaml", "metrics_asym_trained.yaml"],
            f"measure_asymmetry wrote {written}")
    require(rows["random"]["grad_norm"] != rows["trained"]["grad_norm"], "measure_asymmetry: one model in both")
    overrides = SLICE13["slice 13a decepticons_transformer"]
    with tempfile.TemporaryDirectory() as lab:
        ops.reset_launch_counts()
        start = time.perf_counter()
        decepticon_lab.simulate("13a", overrides, lab, device=DEVICE)
        cached = decepticon_lab.attack("13a", overrides, lab, device=DEVICE)
        paths["slice 18f decepticon_lab"] = ops.launch_counts()
    cfg, setup, user, server, _ = build(breaching, decepticon_lab.PRESETS.get("13a", []) + ["name=lab_13a",
                                                                                         *overrides])
    payload = server.distribute_payload()
    shared, true_data = user.compute_local_updates(payload)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    live, _ = attacker.reconstruct([payload], [shared], server.secrets)
    same = np.array_equal(cached["reconstruction"], live["data"].cpu().numpy())
    print(f"slice 18f decepticon_lab on 13a's exchange: simulate and attack in {time.perf_counter() - start:.1f} s, "
          f"token-bag recall {cached['bag_recall']:.4f}, positional accuracy {cached['metrics']['accuracy']:.4f}; "
          f"the cached attack's tokens {'equal' if same else 'differ from'} the uncached readout's; launches "
          f"{launched(paths['slice 18f decepticon_lab'])}", flush=True)
    require(same, "decepticon_lab: the cached attack's tokens differ from the uncached readout's")
    return paths


# --------------------------------------------------------------------------- slice 17
# the in-repo trainer (breaching_tpu_torch/train_model.py) on the card: 17a case 1's ConvNet
# (width 64) at CIFAR-10's 3x32x32 on the synthetic training split, the materialized epoch with
# the device augmentation, 4,096 images in batches of 128 for 2 epochs; its checkpoint reloaded
# through the pretrained path, then slice 1's attack on it; 17b 2 SGD steps of the same model
# from 17a's weights on the first 2 materialized batches, card against CPU; 17c
# case 10's transformer3 (its own width, the GPT-2 vocabulary) through the loader, 2 epochs of
# 10 steps of 8 sentences
TRAIN_CASE = ["case=1_single_image_small"]
TRAIN17 = dict(epochs=2, batch_size=128, limit=4096, eval_batches=2, materialize=1, device_aug=1)
TRAIN17_STEPS = 25  # slice 1's attack on the trained checkpoint
TRAIN17_TEXT = dict(epochs=2, batch_size=8, limit=80, eval_batches=2)
# 17b: of each leaf's largest entry, the parameters after 2 float32 steps card against CPU (from
# 17a's weights: from a fresh initialization float32 itself lies percents from float64), and
# every leaf in float64
TRAIN_F32, TRAIN_F64 = 1e-4, 1e-12
# 17b's CPU steps run on 2 threads: on all 8 cores they slowed slice 10's registrations, the child
# of RPSNR_THREADS threads that ends phase 5, by taking their cores
TRAIN_THREADS = 2


def train17(cfg, tr, device=None):
    """``train_model.train`` with ``tr`` over the trainer's defaults on ``device`` (the
    card's by default): its result, the seconds of the call and the device's peak memory
    in it."""
    from breaching_tpu_torch import train_model

    device = device or DEVICE
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    began = time.perf_counter()
    result = train_model.train(cfg, dict(train_model.TRAIN_DEFAULTS, **tr), device=device)
    seconds = time.perf_counter() - began
    return result, seconds, torch.cuda.max_memory_allocated() if device != "cpu" else 0


def leaf_distance(got, want, keys):
    """The largest distance over ``keys`` of ``got`` from ``want``, as a fraction of each
    leaf's largest entry."""
    return max(float(np.abs(got[k].astype(np.float64) - want[k]).max() / max(np.abs(want[k]).max(), 1e-300))
               for k in keys)


def require_round_trip(breaching, path, cfg_model, cfg_data, out):
    """The checkpoint ``out`` through ``construct_model(pretrained=True)``: every tensor of
    the loaded model equal to its entry."""
    from breaching_tpu_torch.cases.models.model_preparation import dump_flat_state

    model, _ = breaching.cases.construct_model(cfg_model, cfg_data, pretrained=True)
    with np.load(out) as blob:
        flat = dict(blob)
    loaded = dump_flat_state(model)
    equal = sorted(loaded) == sorted(flat) and all(np.array_equal(loaded[k], flat[k]) for k in flat)
    print(f"{path}: {len(flat)} tensors of {out.rsplit('/', 1)[-1]} reloaded through the pretrained path, "
          f"{'every one equal' if equal else 'NOT equal'}", flush=True)
    require(equal, f"{path}: the reloaded checkpoint differs from the saved one")
    return flat


def report_training(path, result, seconds, peak, examples):
    """Prints each epoch (mean loss, seconds, images/s, validation accuracy) and the peak
    memory; requires the second epoch's mean loss below the first's."""
    for i, epoch in enumerate(result["epochs"]):
        rate = epoch["steps"] * examples / epoch["seconds"]
        print(f"{path}: epoch {i + 1} mean loss {epoch['loss']:.6f} in {epoch['seconds']:.3f} s "
              f"({rate:.1f} examples/s, {epoch['steps']} steps), validation accuracy {epoch['val_acc']:.4f}",
              flush=True)
    first, second = (epoch["loss"] for epoch in result["epochs"])
    print(f"{path}: train() in {seconds:.1f} s, peak memory {peak / 2**30:.3f} GiB", flush=True)
    require(second < first, f"{path}: the second epoch's mean loss {second} is not below the first's {first}")


def two_steps(breaching, start, tmp, dtype, device):
    """The parameters and statistics after 2 SGD steps from the weights ``start`` on the
    first 2 materialized batches of 128 (``train`` resumed from them, one epoch of 256
    images), in ``dtype`` on ``device``."""
    out = os.path.join(tmp, f"steps_{dtype}_{device}.npz")
    np.savez(out, **start)
    cfg = breaching.get_config(TRAIN_CASE + [f"case.impl.dtype={dtype}", f"case.data.path={tmp}"])
    train17(cfg, dict(epochs=1, batch_size=128, limit=256, eval_batches=0, resume=1, out=out), device)
    with np.load(out) as blob:
        return dict(blob)


def check_train_reference(breaching, trained):
    """Slice 17b, a phase-4 check run after 17a: 2 SGD steps of case 1's ConvNet-64 from
    17a's trained weights ``trained`` on the card and on the CPU, in float32 and float64;
    and, on the card alone, float32 against float64 from a fresh initialization, where
    BatchNorm's batch variance on the smooth synthetic images makes float32 ill-conditioned
    on either platform."""
    from breaching_tpu_torch.cases.models.model_preparation import dump_flat_state

    began = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(TRAIN_THREADS)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            results = {(dtype, device): two_steps(breaching, trained, tmp, dtype, device)
                       for dtype in ("float", "float64") for device in (DEVICE, "cpu")}
            cfg = breaching.get_config(TRAIN_CASE)
            fresh, _ = breaching.cases.construct_model(cfg.case.model, cfg.case.data,
                                                       generator=torch.Generator().manual_seed(7))
            fresh = dump_flat_state(fresh)
            fresh32, fresh64 = (two_steps(breaching, fresh, tmp, dtype, DEVICE) for dtype in ("float", "float64"))
    finally:
        torch.set_num_threads(threads)
    params = [k for k in trained if k.startswith("params/")]
    buffers = [k for k in trained if k.startswith("buffers/")]
    moved = max(float(np.abs(results["float", "cpu"][k] - trained[k]).max()) for k in params) / max(
        float(np.abs(trained[k]).max()) for k in params)
    f32 = leaf_distance(results["float", DEVICE], results["float", "cpu"], params)
    f32_buffers = leaf_distance(results["float", DEVICE], results["float", "cpu"], buffers)
    own = {device: leaf_distance(results["float", device], results["float64", device], params)
           for device in (DEVICE, "cpu")}
    f64 = leaf_distance(results["float64", DEVICE], results["float64", "cpu"], params + buffers)
    print(f"slice 17b: 2 SGD steps of 17a's ConvNet-64 on 2 x 128 images, card against CPU: float32 parameters "
          f"{f32:.3g} of each leaf's largest entry (tolerance {TRAIN_F32}; the recalibrated statistics "
          f"{f32_buffers:.3g}; float32 from float64 {own[DEVICE]:.3g} on the card, {own['cpu']:.3g} on the CPU), "
          f"float64 every leaf {f64:.3g} (tolerance {TRAIN_F64}); the steps moved a parameter by {moved:.3g} of "
          f"the largest; from a fresh initialization float32 lies {leaf_distance(fresh32, fresh64, params):.3g} "
          f"from float64 on the card; {time.perf_counter() - began:.1f} s", flush=True)
    require(moved > 0, "slice 17b: the steps left the parameters where they were")
    require(f32 <= TRAIN_F32, f"slice 17b: float32 steps card against CPU {f32} > {TRAIN_F32}")
    require(f64 <= TRAIN_F64, f"slice 17b: float64 steps card against CPU {f64} > {TRAIN_F64}")


def run_slice17(breaching, ops, keep):
    """Phase 5, slice 17: the trainer through ``train_model.train`` on the card (17a, 17c),
    each checkpoint reloaded; 17b on 17a's checkpoint; slice 1's attack on it through
    ``simulate_breach.main_process``. 17a's checkpoint is copied to ``keep/checkpoints`` for
    slice 18. Returns the launch counts by path."""
    from breaching_tpu_torch.cases.models.model_preparation import dump_flat_state
    from breaching_tpu_torch.simulate_breach import main_process

    began = time.perf_counter()
    print(f"slice 17 on {card_line()}", flush=True)
    paths = {}
    with tempfile.TemporaryDirectory() as data:
        cfg = breaching.get_config(TRAIN_CASE + [f"case.data.path={data}"])
        ops.reset_launch_counts()
        result, seconds, peak = train17(cfg, TRAIN17)
        paths["slice 17a trainer"] = ops.launch_counts()
        report_training("slice 17a ConvNet-64 at 3x32x32", result, seconds, peak, TRAIN17["batch_size"])
        flat = require_round_trip(breaching, "slice 17a", cfg.case.model, cfg.case.data, result["out"])
        os.makedirs(os.path.join(keep, "checkpoints"), exist_ok=True)
        shutil.copy(result["out"], os.path.join(keep, "checkpoints", os.path.basename(result["out"])))
        check_train_reference(breaching, flat)
        cfg = breaching.get_config(SLICE + [f"attack.optim.max_iterations={TRAIN17_STEPS}", "attack.optim.callback=50",
                                            "seed=0", "name=trained", f"case.data.path={data}", f"base_dir={data}"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        outputs = {}
        start = time.perf_counter()
        metrics = main_process(cfg, device=DEVICE, outputs=outputs)
        torch.cuda.synchronize()
        launches = paths["slice 17a attack on the trained checkpoint"] = ops.launch_counts()
        losses = outputs["stats"]["Trial_0_Val"]
        on_server = dump_flat_state(outputs["server"].model)
        require(all(np.array_equal(on_server[k], flat[k]) for k in flat),
                "slice 17a: the attacked server's model is not the trained checkpoint")
        print(f"slice 17a attack on the trained checkpoint: {len(losses)} steps in {time.perf_counter() - start:.2f} s "
              f"(main_process, report included); loss first={losses[0]:.6f} last={losses[-1]:.6f}; "
              f"PSNR={metrics['psnr']:.3f} SSIM={metrics['ssim']:.4f}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        require(losses[-1] < losses[0], "slice 17a: the attack's loss on the trained checkpoint did not fall")
        want = {name: TRAIN17_STEPS for name in SLICE_KERNELS}
        require({k: v for k, v in launches.items() if v} == want, f"slice 17a: launches {launches}, the path needs {want}")
    with tempfile.TemporaryDirectory() as data:
        cfg = breaching.get_config(CASE10 + [f"case.data.path={data}"])
        ops.reset_launch_counts()
        result, seconds, peak = train17(cfg, TRAIN17_TEXT)
        paths["slice 17c trainer on text"] = ops.launch_counts()
        report_training("slice 17c transformer3", result, seconds, peak, TRAIN17_TEXT["batch_size"])
        require_round_trip(breaching, "slice 17c", cfg.case.model, cfg.case.data, result["out"])
    for path in ("slice 17a trainer", "slice 17c trainer on text"):
        require(not any(paths[path].values()), f"{path} launched a port kernel: {paths[path]}")
    print(f"chip_smoke: slice 17 in {time.perf_counter() - began:.1f} s", flush=True)
    return paths


def time_typed_forms(ops, iters=50):
    """Phase 6, slice 16: each typed form at the shape its path gives it (B1 and B2 at
    ResNet-18's 11,380,173 gradient entries, B3 and B4 at 1x3x224x224): the call, its device
    time cold and warm, its host time, the plain version, a library call of the same
    function where one exists (on upcast copies where the types differ), and the bound."""
    from breaching_tpu_torch.ops import image, matching
    from breaching_tpu_torch.timing import time_ms

    gen = torch.Generator().manual_seed(97)
    dev = torch.device(DEVICE)
    base = torch.randn(N2, generator=gen).to(dev), torch.randn(N2, generator=gen).to(dev)
    x32 = torch.randn(*BIG, generator=gen).to(dev)
    lo32, hi32 = torch.tensor([-1.9, -2.0, -1.7], device=dev), torch.tensor([2.1, 2.1, 2.0], device=dev)
    cases = {}
    for form in TYPED_FORMS:
        kernel, types = form.split(" ")
        ts = [DTYPES[t] for t in types.split("-")]
        size = [torch.empty((), dtype=t).element_size() for t in ts]
        if kernel.startswith(("b1", "b2")):
            r, d = base[0].to(ts[0]), base[1].to(ts[1])
            acc = matching.acc_dtype(r)
            n = N2
            if kernel == "b1_matching_sums":
                cases[form] = (lambda r=r, d=d: ops.matching_sums(r, d), lambda r=r, d=d: matching.matching_sums_plain(
                    r, d), (lambda r=r, d=d, acc=acc: (torch.dot(r.to(acc), d.to(acc)), torch.linalg.vector_norm(
                        r.to(acc)), torch.linalg.vector_norm(d.to(acc))), "torch.dot + 2 vector_norm on upcast copies"),
                    (size[0] + size[1]) * n + 24, 6 * n)
            elif kernel == "b2_cosine_backward":  # the library call of b2_axpby, the kernel it grew from
                sums, g = ops.matching_sums(r, d), torch.tensor(0.37, dtype=acc, device=dev)
                ar = -0.7 * r.to(acc)
                cases[form] = (lambda r=r, d=d, s=sums, g=g: ops.cosine_backward(s, g, r, d),
                               lambda r=r, d=d, s=sums, g=g: matching.cosine_backward_plain(s, g, r, d),
                               (lambda ar=ar, d=d, acc=acc: torch.add(ar, d.to(acc), alpha=1.3),
                                "torch.add(alpha=) on upcast copies"), (2 * size[0] + size[1]) * n + 32, 3 * n)
            else:
                a, b = torch.tensor([-0.7], dtype=acc, device=dev), torch.tensor([1.3], dtype=acc, device=dev)
                ar = (a * r.to(acc))
                cases[form] = (lambda r=r, d=d, a=a, b=b: ops.axpby(a, r, b, d),
                               lambda r=r, d=d, a=a, b=b: matching.axpby_plain(a, r, b, d),
                               (lambda ar=ar, d=d, acc=acc: torch.add(ar, d.to(acc), alpha=1.3),
                                "torch.add(alpha=) on upcast copies"), (2 * size[0] + size[1]) * n + 16, 3 * n)
        else:
            dtype = ts[0]
            acc = torch.float64 if dtype == torch.float64 else torch.float32
            x, m, e = x32.to(dtype), x32.numel(), size[0]
            lo, hi = lo32.to(dtype), hi32.to(dtype)
            if kernel == "b3_tv_value_and_grad":
                g = torch.tensor([0.2], dtype=dtype, device=dev)
                cases[form] = (lambda x=x, g=g: ops.tv_value_and_grad(x, g),
                               lambda x=x, g=g: image.tv_value_and_grad_plain(x, g), None, 2 * e * m + 2 * e, 20 * m)
            elif kernel == "b4_box_project":
                lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
                cases[form] = (lambda x=x, lo=lo, hi=hi: ops.box_project(x, lo, hi),
                               lambda x=x, lo=lo, hi=hi: image.box_project_plain(x, lo, hi),
                               (lambda x=x, lo4=lo4, hi4=hi4: torch.clamp(x, lo4, hi4), "torch.clamp"),
                               2 * e * m + 6 * e, 2 * m)
            else:
                args = (x.clone(), torch.randn(*BIG, generator=gen).to(dev).to(dtype), torch.zeros_like(x),
                        torch.zeros_like(x), x.clone(), lo, hi, torch.tensor(0.5, dtype=acc, device=dev),
                        torch.tensor(float("inf"), dtype=acc, device=dev), torch.empty((), dtype=acc, device=dev),
                        ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3))
                lo4, hi4 = lo.reshape(1, -1, 1, 1), hi.reshape(1, -1, 1, 1)
                # the library call of b4_box_project, the kernel it grew from; torch._fused_adam_
                # on the same type beside it (fused_adam)
                cases[form] = (lambda args=args: ops.adam_box_step(*args),
                               lambda args=args: image.adam_box_step_plain(*args),
                               (lambda x=x, lo4=lo4, hi4=hi4: torch.clamp(x, lo4, hi4), "torch.clamp"),
                               8 * e * m + 64, 15 * m)
    out = {}
    for form, (kernel, plain, library, nbytes, flops) in cases.items():
        bound_ms, bound_by = bound(nbytes, flops)
        ms, device_ms, host_ms, device_warm_ms = time_ms(kernel, iters)
        plain_t = time_ms(plain, iters)
        lib = time_ms(library[0], iters) if library else None
        out[form] = dict(ms=ms, device_ms=device_ms, host_ms=host_ms, device_warm_ms=device_warm_ms,
                         plain_ms=plain_t[0], plain_device_ms=plain_t[1], plain_host_ms=plain_t[2],
                         plain_device_warm_ms=plain_t[3], library_ms=lib[0] if lib else None, bound_ms=bound_ms,
                         bound_by=bound_by)
        if lib:
            out[form].update(library_call=library[1], library_device_ms=lib[1], library_host_ms=lib[2],
                             library_device_warm_ms=lib[3])
        if form.startswith("b4_adam_box_step"):
            out[form]["fused_adam"] = time_fused_adam(BIG, iters, DTYPES[form.split(" ")[1]])
        print(f"time {form}: kernel {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device cold "
              f"({device_warm_ms * 1e3:.2f} warm), {host_ms * 1e3:.2f} us host; plain {plain_t[0] * 1e3:.2f} / "
              f"{plain_t[1] * 1e3:.2f} us" + (f"; {library[1]} {lib[0] * 1e3:.2f} / {lib[1] * 1e3:.2f} "
                                              f"({lib[3] * 1e3:.2f}) us" if lib else "")
              + f"; bound {bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    return out


def time_permutation_step(ops, size, iters=200):
    """Phase 6, slice 12: ``b4_adam_box_step`` at the permutation attack's (P, P) matrix as
    the path calls it (one unboxed row, no sign), beside its plain version and
    ``torch._fused_adam_`` on the (P, P) matrix."""
    from breaching_tpu_torch.ops import image
    from breaching_tpu_torch.timing import time_ms

    gen = torch.Generator().manual_seed(98)
    shape = (1, 1, 1, size * size)
    x, grad = (torch.rand(*shape, generator=gen).to(DEVICE) for _ in range(2))
    mu, nu, best = torch.zeros_like(x), torch.zeros_like(x), x.clone()
    unused = torch.zeros(1, device=DEVICE)
    value = torch.tensor(0.5, device=DEVICE)
    vals = (torch.tensor(float("inf"), device=DEVICE), torch.empty((), device=DEVICE))
    step = ops.AdamStep(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, bias1=1 - 0.9 ** 3, bias2=1 - 0.999 ** 3)
    args = (x, grad, mu, nu, best, unused, unused, value, *vals, step)
    m = x.numel()
    bound_ms, bound_by = bound(32 * m + 36, 15 * m)
    ms, device_ms, host_ms, device_warm_ms = time_ms(lambda: ops.adam_box_step(*args, signed=None, boxed=False),
                                                     iters)
    plain = time_ms(lambda: image.adam_box_step_plain(*args, signed=None, boxed=False), iters)
    print(f"time b4_adam_box_step P={size} ({size}x{size} as one unboxed row): kernel {ms * 1e3:.2f} us per call, "
          f"{device_ms * 1e3:.2f} us device cold ({device_warm_ms * 1e3:.2f} warm), {host_ms * 1e3:.2f} us host; "
          f"plain {plain[0] * 1e3:.2f} / {plain[1] * 1e3:.2f} ({plain[3] * 1e3:.2f}) / {plain[2] * 1e3:.2f} us; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    return dict(shape=(size, size), ms=ms, device_ms=device_ms, host_ms=host_ms, device_warm_ms=device_warm_ms,
                plain_ms=plain[0], plain_device_ms=plain[1], plain_host_ms=plain[2], plain_device_warm_ms=plain[3],
                bound_ms=bound_ms, bound_by=bound_by, fused_adam=time_fused_adam((size, size), iters))


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


def time_fused_adam(shape, iters, dtype=torch.float32):
    """The fused Adam step's second yardstick: ``torch._fused_adam_`` (PyTorch's own
    fused Adam, without the sign, box, guard and best iterate) on one tensor of the
    candidate's shape and type, where the installed torch has it."""
    from breaching_tpu_torch.timing import time_ms

    name = f"torch._fused_adam_ {shape}" + ("" if dtype == torch.float32 else f" {dtype}")
    if not hasattr(torch, "_fused_adam_"):
        print(f"time {name}: not in torch {torch.__version__}", flush=True)
        return None
    gen = torch.Generator().manual_seed(96)
    p, g = (torch.randn(*shape, generator=gen).to(DEVICE, dtype) for _ in range(2))
    m, v, step = torch.zeros_like(p), torch.zeros_like(p), torch.ones((), device=DEVICE)

    def call():
        torch._fused_adam_([p], [g], [m], [v], [], [step], lr=0.1, beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    try:
        ms, device_ms, host_ms, device_warm_ms = time_ms(call, iters)
    except RuntimeError as err:  # not capturable in a CUDA graph, or not of this type, on this torch
        print(f"time {name}: {err}", flush=True)
        return None
    print(f"time {name}: {ms * 1e3:.2f} us per call, {device_ms * 1e3:.2f} us device cold "
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
        "b3_tv_forward": (lambda: ops.tv_forward(x), lambda: op("tv_forward")(x, 1.0, 1.0, 1e-8, workspace)),
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


class LateSlices:
    """Slices 11-15, 17 and 18 in a child process of this script (``--late OUT``) on the same card,
    started after phase 4 and run beside slices 1-10 and 16: most paths leave the card
    idle most of the time, so two processes nearly halve phase 5's wall time. The child
    prints to its own log, which ``paths`` prints once it has ended, and writes its paths'
    launch counts to OUT; ``close`` stops it."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.out = os.path.join(self.tmp.name, "late.json")
        self.log = open(os.path.join(self.tmp.name, "late.log"), "w")
        self.process = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--late", self.out],
                                        stdout=self.log, stderr=subprocess.STDOUT)

    def paths(self):
        """Waits for the child, prints its log; its launch counts by path."""
        returncode = self.process.wait()
        self.log.flush()
        with open(self.log.name) as log:
            print(log.read(), end="", flush=True)
        require(returncode == 0, f"slices 11-15, 17 and 18 failed in their process ({returncode})")
        with open(self.out) as out:
            return json.load(out)

    def close(self):
        if self.process.poll() is None:
            self.process.kill()
            self.process.wait()
        self.log.close()
        self.tmp.cleanup()


def run_late(out):
    """The child of ``LateSlices``: slices 11-15, 17 and 18, their launch counts by path written to
    ``out``. Exits 1 where a check fails."""
    sys.path.insert(0, REPO)
    import breaching_tpu_torch as breaching
    from breaching_tpu_torch import ops

    began = time.perf_counter()
    try:
        paths = {}
        for run in (run_slice11, run_slice12, run_slice13, run_slice14, run_slice15):
            paths.update(run(breaching, ops))
        with tempfile.TemporaryDirectory() as keep:
            paths.update(run_slice17(breaching, ops, keep))
            paths.update(run_slice18(breaching, ops, keep))
    except CheckFailed as failed:
        print(f"chip_smoke: FAILED in slices 11-15, 17 and 18: {failed}", flush=True)
        return 1
    print(f"chip_smoke: slices 11-15, 17 and 18 in their process in {time.perf_counter() - began:.1f} s",
          flush=True)
    with open(out, "w") as fh:
        json.dump(paths, fh)
    return 0


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
    check_text_reference(breaching)
    check_hf_tag_gradients(breaching)
    for name, overrides in HF_FAMILIES.items():
        check_hf_family(breaching, name, overrides)
    print(f"chip_smoke: phase 4 done at {time.perf_counter() - began:.1f} s", flush=True)
    late = LateSlices()  # slices 11-15, 17 and 18 beside 1-10 and 16
    try:
        paths = run_phase5(breaching, ops, late)
    finally:
        late.close()
    print(f"chip_smoke: phase 5 done at {time.perf_counter() - began:.1f} s", flush=True)
    return finish(ops, n_params, image_shape, errors, paths, began)


def run_phase5(breaching, ops, late):
    """Phase 5 in this process (slices 1-7, 10 and 16) and in ``late``'s (11-15, 17 and 18): the
    launch counts by path, slice 16's under "slice 16"."""
    fused = ["attack.objective.type=fused-cosine-similarity"]
    mark = [time.perf_counter()]

    def slice_done(name):
        """Prints the seconds since the previous slice ended: each slice's own."""
        now = time.perf_counter()
        print(f"chip_smoke: slice {name} in {now - mark[0]:.1f} s", flush=True)
        mark[0] = now

    paths = {"slice 1": run_slice(breaching, ops), "slice 1 restarts": run_restarts(breaching, ops)}
    slice_done(1)
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
        if path in ("slice 2 fleet", "slice 3 fused"):
            slice_done(path.split()[1])
    for path, (overrides, steps, needs) in SLICE4.items():
        paths[path] = run_slice4(breaching, ops, path, overrides, steps, needs)
    slice_done(4)
    peaks = {}
    for path, (overrides, steps, needs) in SLICE5.items():
        paths[path], peaks[path] = run_slice5(breaching, ops, path, overrides, steps, needs)
    accum10, accum1 = peaks["slice 5b inverting_large_batch_cifar"], peaks["slice 5b' grad_accum=1"]
    print(f"slice 5b: peak memory {accum10 / 2**30:.3f} GiB with grad_accum=10, {accum1 / 2**30:.3f} GiB with "
          f"grad_accum=1 ({accum1 / accum10:.2f}x)", flush=True)
    require(accum10 < accum1, "slice 5b: grad_accum=10 does not lower the peak memory")
    slice_done(5)
    paths["slice 6a local DP"] = run_dp(breaching, ops)
    paths.update(run_model_states(breaching, ops))
    paths["slice 6c fedavg local DP"] = run_resnet(breaching, ops, "slice 6c fedavg local DP", SLICE3, DP[:2], 25)
    require({k: v for k, v in paths["slice 6c fedavg local DP"].items() if v} == {k: 25 for k in IMAGE_KERNELS},
            f"slice 6c: launches {paths['slice 6c fedavg local DP']}")
    paths["slice 6d wainakh-whitebox"] = run_wainakh(breaching, ops)
    with tempfile.TemporaryDirectory() as tmp:
        paths["slice 6e checkpointed run"], paths["slice 6e resumed run"] = run_resume(breaching, ops, tmp)
        paths["slice 6f trace_dir"] = run_trace(breaching, ops, tmp)
    slice_done(6)
    paths.update(run_slice7_paths(breaching, ops))
    slice_done(7)
    children = []  # the CPU's registrations of slice 10's users, running beside the later paths
    try:
        records, registered = run_records(breaching, ops, children)
        paths.update(records)
        slice_done(10)
        paths16 = run_slice16(breaching, ops)  # its forms' launches in FORM_LAUNCHES
        check_rpsnr_of_every_user(*registered, *children)
    finally:
        for child in children:
            child.close()
    paths.update(late.paths())
    paths["slice 16"] = paths16
    return paths


def finish(ops, n_params, image_shape, errors, paths, began):
    """Phase 6 and the two JSON lines, once no other process uses the card."""
    paths16 = paths.pop("slice 16")
    timings = time_kernels(ops, n_params, image_shape, iters=100)
    slice2 = ("b1_matching_sums", "b2_cosine_backward", "b4_adam_box_step")
    timings2 = time_kernels(ops, N2, BIG, names=slice2, iters=50)
    slice3 = ("b3_tv_value_and_grad", "b4_adam_box_step")
    timings3 = time_kernels(ops, N2, BATCH, names=slice3, iters=50)
    timings4 = {**time_kernels(ops, N2, BIG, names=("b4_adam_box_step soft",), iters=50),
                **time_kernels(ops, N2, OPPONENTS, names=("b3_tv_value_and_grad q=0.5",), iters=50)}
    timings5 = {shape: time_kernels(ops, n_params, shape, names=slice3 if shape != STAGE2 else slice3[:1], iters=50)
                for shape in (LARGE, STAGE, STAGE2)}
    trials = time_trials(ops, n_params, iters=50)
    timings16 = time_typed_forms(ops)
    permutation_steps = [time_permutation_step(ops, size, iters=100) for size in PERMUTATION_SIZES]
    configs = launch_configs(n_params, image_shape)
    hosts = host_breakdown(ops, n_params, image_shape, iters=100)

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
        if name == "b4_adam_box_step":  # slice 12: the permutation attack's (P, P) matrix
            rows[-1]["at_slice12"] = [dict(max_abs_err=errors[f"{name} slice12 P={row['shape'][0]}"], **row)
                                      for row in permutation_steps]
        if name in trials:  # the trials form (the fleet's and the restarts' step)
            rows[-1]["at_trials"] = dict(max_abs_err=errors[f"{name} trials"], **trials[name])
        if name in configs:  # the kernels redesigned for the dispatcher binding
            rows[-1]["launch_config"] = configs[name]
        rows[-1]["host_breakdown"] = hosts[name]
    for form in TYPED_FORMS:  # slice 16: the typed forms, launched on its paths
        name = form.split(" ")[0]
        by_path = {path: FORM_LAUNCHES.get(path, {}).get(form, 0) for path in paths16}
        rows.append(dict(name=form, route="cuda", source=PRECISION_SOURCE, replaces=KERNELS[name][1],
                         launches=sum(by_path.values()), launches_by_path={p: n for p, n in by_path.items() if n},
                         max_abs_err=errors[form], **timings16[form]))
        require(rows[-1]["launches"] > 0, f"{form} was launched on no path of slice 16")
    print(f"device times (cold) under their bound: {under_bound(rows) or 'none'}", flush=True)
    print(f"chip_smoke: phases 2-6 in {time.perf_counter() - began:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--late"]:
        sys.exit(run_late(sys.argv[2]))
    sys.exit(main())
