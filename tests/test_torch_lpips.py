"""The port's LPIPS scorer against the JAX package's on one weights file, written by the
JAX package's ``LPIPS.random_init(...).save_npz``: distances and features for the
AlexNet and VGG-16 trunks, the npz round trip in both directions, the port's own
``random_init``, the weights' discovery, and the conversion of an official
``lpips.LPIPS`` module (a stand-in with its attributes).

Tolerances (float32 on both sides, convolutions summed in other orders; measured
here in brackets): distances 1e-5 relative [1e-6]; features 1e-5 of their largest
entry [7e-7].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from breaching_tpu.analysis.lpips import LPIPS as JaxLPIPS
from breaching_tpu_torch.analysis import lpips as port_lpips
from breaching_tpu_torch.analysis.lpips import LPIPS, convert_torch_lpips, find_lpips_weights, load_lpips

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["alex", "vgg"])
def weights(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / f"lpips_{request.param}.npz")
    JaxLPIPS.random_init(request.param, key=jax.random.PRNGKey(3)).save_npz(path)
    return path


def _pairs(seed, size, batch=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, 3, size, size)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    return x, y


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("size", [16, 20, 32, 64])
def test_distance_and_features_match(weights, size):
    """16 and 20 px go through the bilinear upsampling to 32 and 40 px."""
    x, y = _pairs(size, size)
    port, ref = LPIPS.from_npz(weights), JaxLPIPS.from_npz(weights)
    got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(ref(_nhwc(x), _nhwc(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got, want = port.features(torch.from_numpy(x)).numpy(), np.asarray(ref.features(_nhwc(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(port(torch.from_numpy(x), torch.from_numpy(x)).numpy(), 0.0, atol=1e-6)


def test_port_save_npz_reads_back_in_the_jax_package(weights, tmp_path):
    port = LPIPS.from_npz(weights)
    path = str(tmp_path / "again.npz")
    port.save_npz(path)
    with np.load(weights) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    x, y = _pairs(1, 32)
    np.testing.assert_array_equal(np.asarray(JaxLPIPS.from_npz(path)(_nhwc(x), _nhwc(y))),
                                  np.asarray(JaxLPIPS.from_npz(weights)(_nhwc(x), _nhwc(y))))


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_random_init_is_seeded_and_serves_both_packages(net, tmp_path):
    one = LPIPS.random_init(net, generator=torch.Generator().manual_seed(0))
    two = LPIPS.random_init(net, generator=torch.Generator().manual_seed(0))
    for (w1, b1), (w2, b2) in zip(one.trunk, two.trunk):
        assert torch.equal(w1, w2) and torch.equal(b1, b2)
    path = str(tmp_path / f"lpips_{net}.npz")
    one.save_npz(path)
    x, y = _pairs(2, 32, batch=2)
    np.testing.assert_allclose(one(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(JaxLPIPS.from_npz(path)(_nhwc(x), _nhwc(y))), rtol=1e-5)


def test_discovery_order(tmp_path, monkeypatch):
    """$BREACHING_LPIPS_WEIGHTS, then <data.path>/checkpoints/lpips_<net>.npz, then
    ~/data/checkpoints/; None where no file exists."""
    from breaching_tpu_torch.config.loader import ConfigNode

    home, data = tmp_path / "home", tmp_path / "data"
    for root in (home / "data" / "checkpoints", data / "checkpoints"):
        root.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("BREACHING_LPIPS_WEIGHTS", raising=False)
    cfg_case = ConfigNode(data=ConfigNode(path=str(data)))
    assert find_lpips_weights(cfg_case) is None and load_lpips(cfg_case) is None
    LPIPS.random_init("alex", generator=torch.Generator().manual_seed(0)).save_npz(
        str(home / "data" / "checkpoints" / "lpips_alex.npz"))
    assert find_lpips_weights(cfg_case) == str(home / "data" / "checkpoints" / "lpips_alex.npz")
    LPIPS.random_init("alex", generator=torch.Generator().manual_seed(1)).save_npz(
        str(data / "checkpoints" / "lpips_alex.npz"))
    assert find_lpips_weights(cfg_case) == str(data / "checkpoints" / "lpips_alex.npz")
    env = str(tmp_path / "elsewhere.npz")
    LPIPS.random_init("alex", generator=torch.Generator().manual_seed(2)).save_npz(env)
    monkeypatch.setenv("BREACHING_LPIPS_WEIGHTS", env)
    assert find_lpips_weights(cfg_case) == env
    assert torch.equal(load_lpips(cfg_case).trunk[0][0], LPIPS.from_npz(env).trunk[0][0])
    monkeypatch.delenv("BREACHING_LPIPS_WEIGHTS")
    assert find_lpips_weights(None, net="vgg") is None


class _Slice(nn.Sequential):
    pass


def test_convert_torch_lpips_reads_the_modules_attributes(tmp_path):
    """A stand-in for ``lpips.LPIPS(net="alex")``: its trunk's slices, heads and scaling
    layer, converted and read back by the JAX package."""
    gen = torch.Generator().manual_seed(4)
    module = nn.Module()
    module.pnet_type = "alex"
    module.net = nn.Module()
    c_in, slices = 3, []
    for c_out, k, s, p, pool in port_lpips._ALEX_CONVS:
        layers = ([nn.MaxPool2d(3, 2)] if pool else []) + [nn.Conv2d(c_in, c_out, k, s, p), nn.ReLU()]
        for layer in layers:
            if isinstance(layer, nn.Conv2d):
                nn.init.normal_(layer.weight, std=0.05, generator=gen)
                nn.init.normal_(layer.bias, std=0.05, generator=gen)
        slices.append(_Slice(*layers))
        c_in = c_out
    for idx, block in enumerate(slices, start=1):
        setattr(module.net, f"slice{idx}", block)
    module.lins = nn.ModuleList()
    for c in (64, 192, 384, 256, 256):
        head = nn.Module()
        head.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c, 1, 1, bias=False))
        nn.init.uniform_(head.model[-1].weight, generator=gen)
        module.lins.append(head)
    module.scaling_layer = nn.Module()
    module.scaling_layer.shift = torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1)
    module.scaling_layer.scale = torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1)
    path = str(tmp_path / "lpips_alex.npz")
    port = convert_torch_lpips(module, path)
    with np.load(path) as blob:
        np.testing.assert_array_equal(blob["trunk/1/w"], slices[1][1].weight.detach().numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(blob["lin/2/w"], module.lins[2].model[-1].weight.detach().numpy()
                                      .transpose(2, 3, 1, 0))
    x, y = _pairs(5, 64, batch=2)
    np.testing.assert_allclose(port(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               np.asarray(JaxLPIPS.from_npz(path)(_nhwc(x), _nhwc(y))), rtol=1e-5)
