"""The port's counterparts of the scripts of ``tools/`` (``breaching_tpu_torch.convert_checkpoint``,
``decepticon_lab``, ``fleet_probe``, ``measure_asymmetry``), on the CPU at tiny sizes:

- ``convert_checkpoint``: on torchvision-style ResNet, VGG and DenseNet and timm-style ViT
  state dicts built as ``tests/test_convert_checkpoint.py`` builds them, the port's flat
  dict equals the JAX tool's key for key and array for array; for HuggingFace GPT-2 and
  BERT, a random directory written with ``transformers`` (where it is installed) in both of
  its file formats (``pytorch_model.bin`` and ``model.safetensors``) gives exactly the
  arrays of the JAX tool, which converts through ``transformers``' Flax classes;
- ``decepticon_lab`` on transformer3 (``random-tokens``, 12 tokens, seed 13) through
  ``tmp_path``: the attack on the cached exchange returns exactly the tokens of the attack
  on the live one;
- ``fleet_probe``'s JSON line at a fleet of 2 on ConvNetSmall16 at 3x16x16, 2 steps: its
  keys, and no ratio to another system's figure; the logging as it was before its run;
- ``measure_asymmetry`` on ConvNetSmall16 at 3x32x32 against a 2-step checkpoint of
  ``train_model``: both regimes, their files, and nothing written outside ``tmp_path``.
"""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import convert_checkpoint as jax_tool  # noqa: E402
from test_convert_checkpoint import (  # noqa: E402
    _randomize_bn_stats,
    _TorchTinyDenseNet,
    _TorchTinyResNet,
    _TorchTinyViT,
    _TorchVGG11BN,
)

from breaching_tpu_torch import convert_checkpoint, decepticon_lab, fleet_probe, measure_asymmetry  # noqa: E402

torch.set_num_threads(1)
SMALL = ["case.model=ConvNetSmall16", "case.data.shape=[3,16,16]"]


def _state_dict(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _vision(name):
    torch.manual_seed(0)
    module = dict(resnet18=_TorchTinyResNet, vgg11_bn=_TorchVGG11BN, densenet121=_TorchTinyDenseNet,
                  vit_base=_TorchTinyViT)[name]()
    _randomize_bn_stats(module, torch.Generator().manual_seed(1))
    return _state_dict(module.eval())


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("name", ["resnet18", "vgg11_bn", "densenet121", "vit_base"])
def test_vision_conversion_equals_the_jax_tool(name):
    state = _vision(name)
    _assert_same(convert_checkpoint.convert_state_dict(name, state), jax_tool.convert_state_dict(name, state))


def test_state_dict_file_and_npz_round_trip(tmp_path):
    path = tmp_path / "resnet18.pth"
    torch.save(_TorchTinyResNet().state_dict(), path)
    _assert_same(convert_checkpoint.load_torch_state_dict(str(path)), jax_tool.load_torch_state_dict(str(path)))
    convert_checkpoint.main(["resnet18", str(path), str(tmp_path / "data")])
    with np.load(tmp_path / "data" / "checkpoints" / "resnet18.npz") as saved:
        _assert_same(dict(saved), jax_tool.convert_state_dict("resnet18", jax_tool.load_torch_state_dict(str(path))))


@pytest.mark.parametrize("safe", [False, True])
@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_hf_conversion_equals_the_jax_tool(tmp_path, family, safe):
    pytest.importorskip("transformers")
    import transformers

    torch.manual_seed(0)
    if family == "gpt2":
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(vocab_size=128, n_positions=32, n_embd=32,
                                                                     n_layer=2, n_head=4))
    else:
        model = transformers.BertForMaskedLM(transformers.BertConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32))
    source = tmp_path / "source"
    model.save_pretrained(source, safe_serialization=safe)
    assert (source / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    _assert_same(convert_checkpoint.convert_hf(str(source), f"hf-{family}"),
                 jax_tool.convert_hf(str(source), f"hf-{family}"))


def test_safetensors_reader_reads_every_type(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    tensors = {"f32": torch.randn(3, 4), "f16": torch.randn(5).half(), "bf16": torch.randn(2, 3).bfloat16(),
               "i64": torch.arange(6).reshape(2, 3), "u8": torch.arange(4, dtype=torch.uint8)}
    save_file(tensors, str(tmp_path / "t.safetensors"))
    got = convert_checkpoint.read_safetensors(str(tmp_path / "t.safetensors"))
    for name, tensor in tensors.items():
        np.testing.assert_array_equal(got[name], tensor.float().numpy() if name == "bf16" else tensor.numpy())


def test_decepticon_lab_cached_attack_equals_the_live_one(tmp_path):
    overrides = ["case=10_causal_lang_training", "attack=decepticon", "case/server=malicious-transformer",
                 "case/data=random-tokens", "case.data.shape=[12]", "case.data.vocab_size=512",
                 "case.data.default_clients=40", "case.server.has_external_data=False", "seed=13",
                 "case.model=transformer3", "case.user.num_data_points=1"]
    path = decepticon_lab.simulate("tiny", overrides, str(tmp_path), device="cpu")
    assert os.path.dirname(path) == str(tmp_path)
    cached = decepticon_lab.attack("tiny", overrides, str(tmp_path), device="cpu")

    import breaching_tpu_torch as breaching

    cfg, setup, user, server, model = decepticon_lab._case("tiny", overrides, "cpu")
    payload = server.distribute_payload()
    shared, true_data = user.compute_local_updates(payload)
    attacker = breaching.attacks.prepare_attack(server.model, server.loss, cfg.attack, setup)
    live, _ = attacker.reconstruct([payload], [shared], server.secrets)
    np.testing.assert_array_equal(cached["reconstruction"], live["data"].numpy())
    assert 0.0 <= cached["bag_recall"] <= 1.0
    assert set(cached["metrics"]) >= {"accuracy", "token_acc", "google_bleu"}


def test_fleet_probe_prints_its_json_line(capsys):
    line = fleet_probe.main(["2", "float32", "--iterations", "2", "--chunk", "1", "case=1_single_image_small",
                             *SMALL], device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"device", "fleet", "dtype", "iterations", "agg_iters_per_sec", "wall_s", "psnr_mean",
                         "psnrs"}
    assert line["device"] == "cpu" and line["fleet"] == 2 and len(line["psnrs"]) == 2
    assert "vs_baseline" not in line
    assert logging.root.manager.disable == logging.NOTSET


def test_fleet_probe_restores_the_logging_when_it_fails():
    """The INFO logs it silences come back for whatever runs after it in the process, also
    where its run raises."""
    with pytest.raises(Exception):
        fleet_probe.main(["1", "float32", "case=1_single_image_small", "case.model=NoSuchModel"], device="cpu")
    assert logging.root.manager.disable == logging.NOTSET


def test_measure_asymmetry_writes_only_its_output_directory(tmp_path, monkeypatch):
    from breaching_tpu_torch import train_model

    data = tmp_path / "data"
    # CIFAR-10's own 32x32: the trainer's crops pad and cut at that size
    cfg = train_model.get_config(["case=1_single_image_small", SMALL[0], f"case.data.path={data}"])
    tr = dict(train_model.TRAIN_DEFAULTS, epochs=1, limit=64, batch_size=32, eval_batches=1)
    trained = train_model.train(cfg, tr, device="cpu")
    assert os.path.exists(trained["out"])
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    out = tmp_path / "asymmetry"
    result = measure_asymmetry.main(["--iterations", "2", "--case", "1_single_image_small", "--out", str(out),
                                     SMALL[0], f"case.data.path={data}"], device="cpu")
    assert set(result["rows"]) == {"random", "trained"}
    assert result["rows"]["random"]["grad_norm"] != result["rows"]["trained"]["grad_norm"]
    assert sorted(os.listdir(out)) == ["asymmetry.md", "metrics_asym_random.yaml", "metrics_asym_trained.yaml"]
    assert os.listdir(work) == []
