"""The port's config tree, YAML reader and composition against the JAX package's.

Both trees are text; the port parses its copy with its own YAML-subset reader,
the JAX package with PyYAML. Every comparison here is exact.
"""

import glob
import os

import pytest
import torch
import yaml

import breaching_tpu as jax_breaching
import breaching_tpu_torch as breaching
from breaching_tpu_torch.config import loader

torch.set_num_threads(1)

PORT_ROOT = loader.CONFIG_ROOT
JAX_ROOT = os.path.dirname(os.path.abspath(jax_breaching.config.loader.__file__))
YAML_FILES = sorted(os.path.relpath(p, PORT_ROOT)
                    for p in glob.glob(os.path.join(PORT_ROOT, "**", "*.yaml"), recursive=True))
CASES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(PORT_ROOT, "case", "*.yaml")))
ATTACKS = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(PORT_ROOT, "attack", "*.yaml"))
                 if not os.path.basename(p).startswith("_"))


def test_tree_is_a_copy_of_the_jax_package_tree():
    jax_files = sorted(os.path.relpath(p, JAX_ROOT)
                       for p in glob.glob(os.path.join(JAX_ROOT, "**", "*.yaml"), recursive=True))
    assert YAML_FILES == jax_files
    for rel in YAML_FILES:
        with open(os.path.join(PORT_ROOT, rel)) as a, open(os.path.join(JAX_ROOT, rel)) as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_reader_equals_safe_load(rel):
    with open(os.path.join(PORT_ROOT, rel)) as fh:
        text = fh.read()
    assert loader.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n- x\n- y: 2\n  z: 3\n",
    "c: [1, 'a b', \"c\\\"d # e\", [2, 3], []]  # trailing comment\n",
    "n: ~\nm:\ne: ''\nf: -.inf\ng: .5\nh: 1e5\ni: 010\nj: 0x1F\nk: 1_000\nl: 1.0e-4\n",
    "b: [yes, No, on, OFF, true, False, TRUE]\n",
    "s: 'it''s'\nt: a#b # c\nu: ~/data\nv: \"~/data\"\n",
    "l:\n  - - 1\n    - 2\n  -\n    m: 3\n",
    "top:\n  nested:\n    deep: 1\n  list:\n  - 1\n  - 2\nnext: 2\n",
])
def test_yaml_reader_equals_safe_load_on_subset_features(text):
    assert loader.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: {b: 1}\n", "a: &x 1\n", "a: |\n  text\n", "a: !!str 1\n"])
def test_yaml_reader_refuses_features_outside_the_subset(text):
    with pytest.raises(ValueError):
        loader.parse_yaml(text)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("attack", ATTACKS)
def test_composed_config_equals_jax_package(case, attack):
    overrides = [f"case={case}", f"attack={attack}"]
    assert breaching.get_config(overrides).to_dict() == jax_breaching.get_config(overrides).to_dict()


@pytest.mark.parametrize("overrides", [
    [],
    ["case=1_single_image_small", "attack=invertinggradients",
     "attack.objective.type=fused-cosine-similarity", "attack.optim.max_iterations=7",
     "case.user.num_data_points=4", "seed=3", "attack.optim.signed=False"],
    ["case=1_single_image_small", "case/data=CIFAR100", "case/server=malicious-fishing"],
    ["case=2_single_imagenet", "case/data/db=LMDB", "attack.optim.step_size_decay=None"],
])
def test_overrides_equal_jax_package(overrides):
    assert breaching.get_config(overrides).to_dict() == jax_breaching.get_config(overrides).to_dict()


def test_partial_configs_equal_jax_package():
    assert breaching.get_attack_config("deepleakage", ["optim.step_size=0.5"]).to_dict() == \
        jax_breaching.get_attack_config("deepleakage", ["optim.step_size=0.5"]).to_dict()
    assert breaching.get_case_config("4_fedavg_small_scale").to_dict() == \
        jax_breaching.get_case_config("4_fedavg_small_scale").to_dict()
