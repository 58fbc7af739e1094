"""Coarse-to-fine multiscale gradient inversion (counterpart of
``breaching_tpu/attacks/multiscale_optimization_attack.py``).

The attack runs the base attack's trials once per stage of a pyramid of square
sizes, each stage for ``optim.max_iterations`` steps with a fresh optimizer state and
schedule, at that stage's size: the data shape is set per stage, so the candidate,
the fused TV and the fused Adam step run at 1x3xs x s. The next stage starts from the
previous stage's best trial, resized (``resize: upsampling``), or with
``resize: focus`` resized to half the new size and embedded at the centre of a fresh
initial candidate. The model sees every stage's size: ResNets pool globally and take
any of them. A dry run stops after stage 0; the result is resized to the full shape.
Resizing is ``augmentations.resize``, the JAX package's ``jax.image.resize``.

An interrupt (``stats["interrupted_at"]``) ends the pyramid at the stage it reached.
``attack.impl.checkpoint_path``: every stage runs the base attack with the same file, as
the JAX package's stages do (breaching_tpu/attacks/multiscale_optimization_attack.py:40-70):
a stage resumes from a state saved at its own shapes, and a state saved by a stage of
another size does not fit and is ignored with a warning, so that the stage starts
afresh (and writes its own state over it).
"""

from __future__ import annotations

import logging

import numpy as np

from .auxiliaries.augmentations import resize
from .optimization_based_attack import OptimizationBasedAttacker

log = logging.getLogger(__name__)


class MultiScaleOptimizationAttacker(OptimizationBasedAttacker):
    """Inverting Gradients over a pyramid of image sizes."""

    supports_fleet = False  # each stage would have to stack every experiment anew

    def _scale_pyramid(self):
        size = self.data_shape[1]
        num_stages = int(self.cfg.num_stages)
        scheme = self.cfg.scale_pyramid
        if scheme == "linear":
            increment = size // num_stages
            return list(range(increment, size + 1, increment))
        if scheme == "log":
            return [int(round(size / (2 ** i))) for i in range(num_stages - 1, -1, -1)]
        if scheme == "trivial":
            return [size] * num_stages
        raise ValueError(f"Invalid scale pyramid {scheme}.")

    def _stage_init(self, previous, scale, num_points):
        """The initial data of a stage from the previous stage's best (N, C, h, w)."""
        if self.cfg.get("resize") != "focus":
            return resize(previous, (scale, scale))
        half = scale // 2
        start = (scale - half) // 2
        init = self._initialize_data((num_points, self.data_shape[0], scale, scale)).clone()
        init[:, :, start:start + half, start:start + half] = resize(previous, (half, half))
        return init

    def _run_all_trials(self, rec_models, shared_data, trial_targets, trial_labels, stats,
                        initial_data, dryrun):
        full_shape = self.data_shape
        if full_shape[1] != full_shape[2]:
            raise ValueError(f"The multiscale attack takes square images, not {full_shape[1:]}.")
        metadata = shared_data[0]["metadata"]
        num_points = int(metadata["num_data_points"]) if metadata["num_data_points"] \
            else len(trial_labels[0])
        pyramid = self._scale_pyramid()
        stage_init = initial_data
        try:
            for stage, scale in enumerate(pyramid):
                log.info(f"| Now solving stage {stage + 1}/{len(pyramid)} with scale {scale}:")
                self.data_shape = (full_shape[0], int(scale), int(scale))
                if stage > 0:
                    stage_init = self._stage_init(stage_best, int(scale), num_points)
                best, best_vals = super()._run_all_trials(rec_models, shared_data, trial_targets, trial_labels,
                                                          stats, stage_init, dryrun)
                stage_best = best["data"][int(np.argmin(best_vals))]
                if dryrun or "interrupted_at" in stats:
                    break
        finally:
            self.data_shape = full_shape
        trials, points = best["data"].shape[:2]
        final = resize(best["data"].flatten(0, 1), full_shape[1:]).unflatten(0, (trials, points))
        return dict(best, data=final), best_vals
