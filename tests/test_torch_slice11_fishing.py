"""The rest of slice 11's presets through the port's entry point against the JAX package's
runs: ``fishing_analytic_cross_silo``, ``fishing_feature_cross_device`` and case 8, with
the settings, cuts and tolerances that tests/test_torch_slice11_presets.py states. A file
of their own, so that the test workers run the two halves side by side.
"""

import pytest
import torch

from test_torch_slice11_presets import _jitted_init, _one_blas_thread, check_preset  # noqa: F401  (fixtures)

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", ["fishing_analytic_cross_silo", "fishing_feature_cross_device", "case8"])
def test_preset_runs_through_main_process_as_the_jax_package(preset, tmp_path, monkeypatch, caplog):
    check_preset(preset, tmp_path, monkeypatch, caplog)
