"""The malicious model server under ``handle_preceding_layers: VAE`` against the JAX
package's, at small sizes on the CPU (the victim's weights carried across by the bridge):

- the deep placement (ResNet-20 at 3x16x16, ``position=2``, 32 bins): the tapped prefix
  features (the imprint block's input on the unmodified victim) of the same images to
  1e-5 of the JAX package's ``prefix_fn``'s; the feature decoder on the JAX package's trained
  parameters decoding to 1e-5; the readout of each package's own exchange, decoded by
  those parameters in both, to 1e-5;
- the top placement (ConvNet-8 at 3x16x16): the readout decodes the rows reshaped to NHWC
  images, held to the JAX package's ``decode`` of the same array (to which the JAX
  package's own readout hands the flat rows, which its encoder refuses: ROADMAP Queue C);
  the whole path through ``reconstruct`` and ``report``;
- the server's secrets and the decoders' shapes in both placements.

The servers' decoders are trained for a few steps here (the servers' own 200 and 800 are
the card's; the first training steps are held in ``test_torch_aux_training.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamShapeError

import breaching_tpu_torch as breaching
from breaching_tpu.cases.malicious import aux_training as jax_aux
from breaching_tpu_torch.cases.malicious import aux_training as aux
from breaching_tpu_torch.cases.models.model_preparation import load_flat_state
from test_torch_imprint import DEEP, RTF, _cases, _close, _exchange, _flat, _nhwc, _readouts

torch.set_num_threads(1)
VAE = "case.server.model_modification.handle_preceding_layers=VAE"
DEEP2 = [o.replace("position=1", "position=2") for o in DEEP] + [VAE]
TOP = RTF + [VAE]
STEPS = 3


@pytest.fixture
def trainings(monkeypatch):
    """Each package's decoder training cut to ``STEPS`` steps; records its calls (the
    prefix, the shapes, the result) by package."""
    calls = dict(jax=[], port=[])

    def recorded(package, module, name):
        real = getattr(module, name)

        def train(*args, **kwargs):
            kwargs["steps"] = STEPS
            result = real(*args, **kwargs)
            calls[package].append(dict(args=args, kwargs=kwargs, result=result))
            return result

        monkeypatch.setattr(module, name, train)

    for name in ("train_feature_decoder", "train_encoder_decoder"):
        recorded("jax", jax_aux, name)
        recorded("port", aux, name)
    return calls


def _images(count, seed=0):
    return np.random.default_rng(seed).standard_normal((count, 16, 16, 3)).astype(np.float32)


def test_deep_placement_taps_the_prefix_and_decodes_as_jax(trainings):
    e = _cases(DEEP2)
    (j_call,), (call,) = trainings["jax"], trainings["port"]
    j_prefix, (_, j_data_shape, j_feature_shape) = j_call["args"][0], j_call["args"]
    prefix, (_, data_shape, feature_shape) = call["args"][0], call["args"]
    assert (data_shape, feature_shape) == (j_data_shape, j_feature_shape) == ((16, 16, 3), (8, 8, 32))
    secrets, j_secrets = e["server"].secrets["ImprintBlock"], e["j_server"].secrets["ImprintBlock"]
    assert secrets["shape"] == tuple(j_secrets["shape"]) == (8, 8, 32)
    assert secrets["structure"] == j_secrets["structure"] and "decoder" in secrets and "decoder" in j_secrets

    x = _images(4)
    features = prefix(torch.as_tensor(x).permute(0, 3, 1, 2))
    _close(features.detach(), j_prefix(jnp.asarray(x)))

    # the port's decoder on the JAX package's trained parameters
    j_decode, j_params = j_call["result"]
    decoder = secrets["decoder"].__self__
    load_flat_state(decoder, _flat(j_params), strict=True)
    rows = features.reshape(4, -1).detach().numpy()
    decoded = secrets["decoder"](rows)
    assert decoded.shape == (4, 16, 16, 3)
    _close(decoded, j_decode(rows))

    shared, payloads, _, j_shared, j_payloads, _ = _exchange(e)
    rec, j_rec = _readouts(e, shared, payloads, j_shared, j_payloads)
    assert rec["data"].shape == (1, 3, 16, 16)
    _close(_nhwc(rec["data"]), j_rec["data"])


def test_top_placement_decodes_the_rows_as_nhwc_images(trainings):
    e = _cases(TOP)
    (j_call,), (call,) = trainings["jax"], trainings["port"]
    assert j_call["args"][0] == call["args"][0] == (16, 16, 3)
    assert call["kwargs"]["arch"] == j_call["kwargs"]["arch"] == "VAE"
    secrets, j_secrets = e["server"].secrets["ImprintBlock"], e["j_server"].secrets["ImprintBlock"]
    assert secrets["shape"] == tuple(j_secrets["shape"]) == (16, 16, 3)
    j_decode, j_params = j_call["result"]
    model = secrets["decoder"].__self__
    load_flat_state(model, _flat(j_params), strict=True)

    shared, payloads, true, _, _, _ = _exchange(e)
    attacker = breaching.attacks.prepare_attack(e["server"].model, e["server"].loss, e["cfg"].attack, e["setup"])
    attacker.prepare_attack(payloads, shared)
    rows = _images(2, seed=1).reshape(2, -1)
    with pytest.raises(ScopeParamShapeError):  # the JAX package's readout hands its decode the flat rows
        j_decode(jnp.asarray(rows))
    got = attacker._reformat_data(torch.as_tensor(rows), secrets, None)
    dm, ds = (v.reshape(1, 1, 1, -1).numpy() for v in (attacker.dm, attacker.ds))
    want = np.clip(np.asarray(j_decode(jnp.asarray(rows.reshape(2, 16, 16, 3))))[..., :3], -dm / ds, (1 - dm) / ds)
    assert got.shape == (2, 3, 16, 16)
    _close(_nhwc(got), want)

    # the whole path: the readout through the decoder, the report
    rec, _ = attacker.reconstruct(payloads, shared, e["server"].secrets)
    assert rec["data"].shape == true["data"].shape and torch.isfinite(rec["data"]).all()
    metrics = breaching.analysis.report(rec, true, payloads, e["server"].model, order_batch=True,
                                        compute_full_iip=False, cfg_case=e["cfg"].case, setup=e["setup"])
    assert np.isfinite(metrics["psnr"])


@pytest.mark.parametrize("arch", ["AE", "VQ_CVAE"])
def test_top_placement_trains_the_named_aux_arch(trainings, arch):
    e = _cases(TOP + [f"case.server.model_modification.aux_arch={arch}"])
    (j_call,), (call,) = trainings["jax"], trainings["port"]
    assert call["kwargs"]["arch"] == j_call["kwargs"]["arch"] == arch
    model = e["server"].secrets["ImprintBlock"]["decoder"].__self__
    assert (model.codebook is None) == (arch == "AE") == ("codebook" not in j_call["result"][1])
    assert model.losses.shape == (STEPS,)
