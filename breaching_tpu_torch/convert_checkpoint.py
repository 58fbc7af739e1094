"""Convert pretrained PyTorch checkpoints into the flat npz layout that
``case.server.pretrained=True`` loads (counterpart of ``tools/convert_checkpoint.py``).

The npz holds flat keys ``params/<slash/joined/path>`` and ``buffers/<path>`` in the JAX
package's layout (HWIO convolution kernels, (in, out) dense kernels), which both packages
load (``model_preparation.load_flat_state``). Source layouts:

- torchvision ResNets, DenseNets and VGGs (plain or ``_bn``), and timm ViTs: state dicts
  (``torch.load(weights_only=True)``), renamed and transposed in numpy;
- HuggingFace GPT-2 and BERT directories (``hf-gpt2*``, ``hf-bert*``): ``pytorch_model.bin``
  (``torch.load(weights_only=True)``) or ``model.safetensors`` (read here: an 8-byte header
  length, the JSON header, then the raw tensors), renamed to the Flax models' parameter
  tree as ``transformers``' PyTorch-to-Flax conversion names it (``from_pt=True``), without
  ``transformers``: embeddings keep their (vocab, dim) layout as ``embedding``, layer norms
  take ``scale``, every other matrix is transposed into a ``kernel``; buffers (the causal
  mask, position ids), tied output heads and a pooler the masked-LM model lacks are left
  out, and a base model's keys take the head model's prefix.

    python3 -m breaching_tpu_torch.convert_checkpoint resnet18 path/to/resnet18.pth ~/data
    python3 -m breaching_tpu_torch.convert_checkpoint hf-gpt2 path/to/gpt2_checkpoint_dir ~/data

writes ``<data_path>/checkpoints/<model>.npz``.
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np


def _t_conv(w) -> np.ndarray:
    """torch conv weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _t_dense(w) -> np.ndarray:
    """torch linear weight (O, I) -> flax kernel (I, O)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w)))


def _put_norm(flat: dict, sd: dict, src: str, dst: str) -> None:
    """Map one torch BatchNorm/LayerNorm prefix onto flax params + buffers."""
    flat[f"params/{dst}/scale"] = np.asarray(sd[f"{src}.weight"])
    flat[f"params/{dst}/bias"] = np.asarray(sd[f"{src}.bias"])
    if f"{src}.running_mean" in sd:
        flat[f"buffers/{dst}/mean"] = np.asarray(sd[f"{src}.running_mean"])
        flat[f"buffers/{dst}/var"] = np.asarray(sd[f"{src}.running_var"])
        nbt = sd.get(f"{src}.num_batches_tracked")
        if nbt is not None:
            flat[f"buffers/{dst}/num_batches_tracked"] = np.asarray(nbt, np.float32)


def convert_resnet(sd: dict) -> dict:
    """torchvision ResNet state_dict -> flat npz dict.

    torchvision: conv1/bn1, layer{1..4}.{B}.(conv*/bn*/downsample.0/.1), fc.
    the flat layout (cases/models/resnets.py): stem_conv/stem_norm,
    stage{0..3}_block{B}.(conv*/bn*/downsample_conv/downsample_norm), head.
    """
    flat: dict = {}
    flat["params/stem_conv/conv/kernel"] = _t_conv(sd["conv1.weight"])
    _put_norm(flat, sd, "bn1", "stem_norm")
    for key in sd:
        m = re.match(r"layer(\d+)\.(\d+)\.(.+)", key)
        if not m:
            continue
        stage, block, rest = int(m.group(1)) - 1, int(m.group(2)), m.group(3)
        prefix = f"stage{stage}_block{block}"
        cm = re.match(r"conv(\d)\.weight", rest)
        if cm:
            flat[f"params/{prefix}/conv{cm.group(1)}/conv/kernel"] = _t_conv(sd[key])
        elif rest == "downsample.0.weight":
            flat[f"params/{prefix}/downsample_conv/conv/kernel"] = _t_conv(sd[key])
        elif rest.startswith("downsample.1.") and rest.endswith(".weight"):
            _put_norm(flat, sd, f"layer{stage + 1}.{block}.downsample.1",
                      f"{prefix}/downsample_norm")
        elif re.match(r"bn(\d)\.weight", rest):
            bn = rest.split(".")[0]
            _put_norm(flat, sd, f"layer{stage + 1}.{block}.{bn}", f"{prefix}/{bn}")
    flat["params/head/dense/kernel"] = _t_dense(sd["fc.weight"])
    flat["params/head/dense/bias"] = np.asarray(sd["fc.bias"])
    return flat


def convert_densenet(sd: dict) -> dict:
    """torchvision DenseNet state_dict -> flat npz dict
    (cases/models/densenets.py naming: stem_conv/stem_norm,
    block{D}_layer{L}.(norm1/conv1/norm2/conv2), transition{T}.(norm/conv),
    final_norm, head)."""
    flat: dict = {}
    flat["params/stem_conv/conv/kernel"] = _t_conv(sd["features.conv0.weight"])
    _put_norm(flat, sd, "features.norm0", "stem_norm")
    for key in sd:
        m = re.match(r"features\.denseblock(\d+)\.denselayer(\d+)\.(norm|conv)(\d)\.(.+)", key)
        if m:
            block, layer, kind, idx = (int(m.group(1)) - 1, int(m.group(2)) - 1,
                                       m.group(3), m.group(4))
            dst = f"block{block}_layer{layer}/{kind}{idx}"
            if kind == "conv":
                flat[f"params/{dst}/conv/kernel"] = _t_conv(sd[key])
            elif key.endswith(".weight"):
                _put_norm(flat, sd,
                          f"features.denseblock{block + 1}.denselayer{layer + 1}.norm{idx}",
                          dst)
            continue
        m = re.match(r"features\.transition(\d+)\.(norm|conv)\.(.+)", key)
        if m:
            t, kind = int(m.group(1)) - 1, m.group(2)
            if kind == "conv":
                flat[f"params/transition{t}/conv/conv/kernel"] = _t_conv(sd[key])
            elif key.endswith(".weight"):
                _put_norm(flat, sd, f"features.transition{t + 1}.norm", f"transition{t}/norm")
    _put_norm(flat, sd, "features.norm5", "final_norm")
    flat["params/head/dense/kernel"] = _t_dense(sd["classifier.weight"])
    flat["params/head/dense/bias"] = np.asarray(sd["classifier.bias"])
    return flat


def convert_vgg(sd: dict) -> dict:
    """torchvision VGG state_dict -> flat npz dict (cases/models/vgg.py naming:
    conv{i}/bn{i} in order of appearance, fc0/fc1/head). Works for plain and
    _bn variants: convs and norms are enumerated in features order.

    The first classifier layer reads the FLATTENED feature map, and torch
    flattens NCHW (channel-major) while the flax model flattens NHWC — its
    input rows are permuted from (C, H, W) to (H, W, C) order before the usual
    (O, I) -> (I, O) transpose. Later dense layers see 1-D activations and
    need no permutation."""
    flat: dict = {}
    conv_idx = bn_idx = last_conv_out = 0
    feature_keys = sorted(
        (int(k.split(".")[1]), k) for k in sd if k.startswith("features.") and k.endswith(".weight"))
    for _, key in feature_keys:
        src = key[: -len(".weight")]
        if np.asarray(sd[key]).ndim == 4:
            flat[f"params/conv{conv_idx}/conv/kernel"] = _t_conv(sd[key])
            if f"{src}.bias" in sd:
                flat[f"params/conv{conv_idx}/conv/bias"] = np.asarray(sd[f"{src}.bias"])
            last_conv_out = np.asarray(sd[key]).shape[0]
            conv_idx += 1
        else:  # 1-D weight in features = batchnorm
            _put_norm(flat, sd, src, f"bn{bn_idx}")
            bn_idx += 1
    first = True
    for src, dst in (("classifier.0", "fc0"), ("classifier.3", "fc1"), ("classifier.6", "head")):
        if f"{src}.weight" in sd:
            w = np.asarray(sd[f"{src}.weight"])
            if first and last_conv_out and w.shape[1] % last_conv_out == 0:
                side = int(round((w.shape[1] // last_conv_out) ** 0.5))
                if side * side * last_conv_out == w.shape[1]:
                    w = (w.reshape(w.shape[0], last_conv_out, side, side)
                         .transpose(0, 2, 3, 1).reshape(w.shape[0], -1))
                else:
                    import warnings

                    warnings.warn(
                        f"VGG fc0 input ({w.shape[1]}) is divisible by the last "
                        f"conv width ({last_conv_out}) but the feature map is "
                        f"not square — leaving the torch channel-major layout "
                        f"unpermuted; verify forward equivalence before use.")
            flat[f"params/{dst}/dense/kernel"] = _t_dense(w)
            flat[f"params/{dst}/dense/bias"] = np.asarray(sd[f"{src}.bias"])
            first = False
    return flat


def convert_vit(sd: dict) -> dict:
    """timm ViT state_dict -> flat npz dict (cases/models/vit.py naming:
    patch_embed (bare nn.Conv), cls_token, pos_embed,
    block{i}.(norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2), norm, head)."""
    flat: dict = {
        "params/cls_token": np.asarray(sd["cls_token"]),
        "params/pos_embed": np.asarray(sd["pos_embed"]),
        "params/patch_embed/kernel": _t_conv(sd["patch_embed.proj.weight"]),
        "params/patch_embed/bias": np.asarray(sd["patch_embed.proj.bias"]),
        "params/head/kernel": _t_dense(sd["head.weight"]),
        "params/head/bias": np.asarray(sd["head.bias"]),
    }
    _put_norm(flat, sd, "norm", "norm")
    for key in sd:
        m = re.match(r"blocks\.(\d+)\.(.+)", key)
        if not m:
            continue
        i, rest = m.group(1), m.group(2)
        if rest in ("norm1.weight", "norm2.weight"):
            _put_norm(flat, sd, f"blocks.{i}.{rest[:-7]}", f"block{i}/{rest[:-7]}")
        elif rest.endswith(".weight") and rest.startswith(("attn.", "mlp.")):
            leaf = rest[: -len(".weight")].replace(".", "/").replace("attn", "attn").replace("mlp", "mlp")
            flat[f"params/block{i}/{leaf}/kernel"] = _t_dense(sd[key])
        elif rest.endswith(".bias") and rest.startswith(("attn.", "mlp.")):
            leaf = rest[: -len(".bias")].replace(".", "/")
            flat[f"params/block{i}/{leaf}/bias"] = np.asarray(sd[key])
    return flat


_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
                       "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> dict:
    """name -> numpy array of a ``.safetensors`` file: a little-endian u64 header length, the
    JSON header (each tensor's dtype, shape and byte range), then the tensors' bytes. bfloat16
    comes out as float32 (its bits are a float32's upper half)."""
    with open(path, "rb") as fh:
        length = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(length))
        data = fh.read()
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        raw = data[begin:end]
        if entry["dtype"] == "BF16":
            array = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            array = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[entry["dtype"]]).newbyteorder("<"))
        out[name] = array.reshape(entry["shape"]).copy()
    return out


def load_hf_state_dict(model_dir: str) -> dict:
    """The state dict of a HuggingFace model directory, from ``model.safetensors`` or else
    ``pytorch_model.bin``, as numpy arrays."""
    safetensors = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(safetensors):
        return read_safetensors(safetensors)
    return load_torch_state_dict(os.path.join(model_dir, "pytorch_model.bin"))


# HuggingFace's Flax models: the base model's prefix, the modules whose weight is an
# embedding table, the layer norms, and what the Flax model holds no parameter for
_HF = {
    "gpt2": dict(prefix="transformer", embeddings=("wte", "wpe"), norms=re.compile(r"^(ln_\d+|ln_f)$"),
                 dropped=re.compile(r"(^|\.)attn\.(bias|masked_bias)$|^lm_head\.")),
    "bert": dict(prefix="bert", embeddings=("word_embeddings", "position_embeddings", "token_type_embeddings"),
                 norms=re.compile(r"^LayerNorm$"),
                 dropped=re.compile(r"position_ids$|^cls\.predictions\.decoder\.|^bert\.pooler\.|^pooler\.")),
}


def convert_hf(model_dir: str, name: str) -> dict:
    """A local HuggingFace GPT-2 (``GPT2LMHeadModel``) or BERT (``BertForMaskedLM``)
    checkpoint directory as the flat npz of the Flax model's parameters (the hf-gpt2 /
    hf-bert wrappers' layout), renamed as ``transformers``' PyTorch-to-Flax conversion
    renames them, for a model whose output head is tied to its embedding (the default of
    both configs)."""
    family = "gpt2" if "gpt2" in name else "bert" if "bert" in name else None
    if family is None:
        raise ValueError(f"Unsupported HF model {name}.")
    rules = _HF[family]
    flat: dict = {}
    for key, value in load_hf_state_dict(model_dir).items():
        if rules["dropped"].search(key):
            continue
        path = key.split(".")
        if path[0] != rules["prefix"] and not (family == "bert" and path[0] == "cls"):
            path = [rules["prefix"], *path]  # a base model's key under the head model's prefix
        module, leaf = path[-2], path[-1]
        if leaf == "weight" and module in rules["embeddings"]:
            leaf = "embedding"
        elif leaf in ("weight", "gamma") and rules["norms"].match(module):
            leaf = "scale"
        elif leaf == "beta" and rules["norms"].match(module):
            leaf = "bias"
        elif leaf == "weight" and value.ndim == 2:
            leaf, value = "kernel", value.T
        flat["params/" + "/".join([*path[:-1], leaf])] = np.ascontiguousarray(value)
    return flat


_VISION_CONVERTERS = (
    ("densenet", convert_densenet),
    ("resnet", convert_resnet),
    ("vgg", convert_vgg),
    ("vit", convert_vit),
)


def convert_state_dict(model_name: str, sd: dict) -> dict:
    lname = model_name.lower()
    for tag, fn in _VISION_CONVERTERS:
        if tag in lname:
            return fn(sd)
    raise ValueError(f"No converter for model {model_name}.")


def load_torch_state_dict(path: str) -> dict:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def save_npz(flat: dict, data_path: str, model_name: str) -> str:
    out_dir = os.path.expanduser(os.path.join(data_path, "checkpoints"))
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{model_name}.npz")
    np.savez(out, **flat)
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__)
        raise SystemExit(2)
    model_name, source, data_path = argv
    if model_name.startswith("hf-") or os.path.isdir(source):
        flat = convert_hf(source, model_name)
    else:
        flat = convert_state_dict(model_name, load_torch_state_dict(source))
    out = save_npz(flat, data_path, model_name)
    print(f"Wrote {len(flat)} tensors to {out}.")


if __name__ == "__main__":
    main()
