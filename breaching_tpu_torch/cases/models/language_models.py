"""Language models: the transformer encoder LM, the LSTM LM and the linear baseline
(counterpart of ``breaching_tpu/cases/models/language_models.py``), and the dispatch to the
HuggingFace architectures of ``hf_models.py`` (``gpt2S``, ``bert-sanity-check``, ``hf-*``)
with their registries in the port's parameter names.

A model takes int token ids (B, T) or float embeddings (B, T, D), told apart by dtype:
the attacks' ``run-embedding`` strategy feeds the candidate's embeddings directly.

- ``TransformerModel``: a token embedding U(-0.1, 0.1) * sqrt(D), fixed sin/cos positions
  or a learnable N(0, 1) table of ``max_len`` rows, ``nlayers`` encoder layers, then a
  head: the ``classifier`` on position 0 for ``task=classification``, the tied decoder
  ``h @ embedding.T + decoder_bias``, or an untied ``decoder`` with a U(-0.1, 0.1) kernel.
  As in the JAX package there is no attention mask: every model, ``gpt2`` included,
  attends both ways.
- ``EncoderLayer``: fused ``attn_qkv``, ``attn_out``, ``linear1`` / ``linear2`` with ReLU,
  post-LN (LN(x + f(x))) or with ``norm_first`` pre-LN (x + f(LN(x))). Attention is written
  out (matmul, softmax, matmul): the attacks differentiate the gradient, and the fused
  attention backends have no double backward.
- ``LSTMModel``: flax's ``OptimizedLSTMCell`` over the sequence as an explicit loop (cuDNN's
  RNN has no double backward either): gates i, f, g, o, input kernels without bias,
  hidden kernels with bias, a zero initial carry; the decoder is tied where the widths
  agree.
- ``LinearLM``: a N(0, 0.1) embedding and a dense decoder.

The dense layers are flax's used directly (``layer0/attn_qkv/kernel``: LeCun-normal
kernels, zero biases), the norms flax's LayerNorm (eps 1e-6). Each model names its
parameters in the JAX package's flat layout (``flax_entries``), so that
``model_preparation.load_flat_state`` takes the JAX package's parameters and
``jax_leaf_ranks`` its sorted leaf order (``layer10`` before ``layer2``), and it carries a
``registry`` of the names the text attacks read and its head's ``head_param_keys``.

A transformer's ``registry`` is the JAX package's ``_registry``: parameter names for
``embedding``, ``pos_embedding`` (None for fixed positions) and ``decoder_bias``, module
names for ``decoder`` (None when tied) and each layer's ``attention_qkv``,
``attention_out``, ``ff_first``, ``ff_second`` and ``norms``, ``nlayers``, and a
``kernel_layout`` of ``out_in`` (an ``nn.Linear`` weight is (out, in), flax's kernel (in,
out)); Decepticon's server and readout work from it. A forward given a ``capture`` dict
also records each layer's feed-forward input under ``layer<i>/ff_input``, where the JAX
``EncoderLayer`` sows it: ``norm1(x + attn(x))`` post-LN, ``norm2(x)`` pre-LN. A malicious
server may set ``imprint_block``, which then runs on the embedded sequence before the
positional term; its weights are ``imprint_block/linear0_kernel``, ... in the flat layout.

The HuggingFace registries (``_gpt2_registry``, ``_bert_registry``, ``_roberta_registry``,
``_distilbert_registry``) are the JAX package's in the port's dotted names: separate
``query``/``key``/``value`` modules for the encoders, ``embedding_norm``, ``type_embedding``,
``first_ff_norm``, RoBERTa's ``pos_offset`` of 2, and a ``kernel_layout`` of ``out_in`` for
every family (GPT-2's Conv1D weights are (out, in) in both packages, the encoders' Dense
kernels (in, out) in Flax).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from .layers import LayerNorm, direct, lecun_normal_


def fixed_positional_encoding(max_len: int, d_model: int) -> np.ndarray:
    """Sin/cos positional table (reference: PositionalEmbedding:89-130)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len)[:, None].astype(np.float32)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


def _dense(in_features: int, out_features: int, generator, kernel_bound: float | None = None) -> nn.Linear:
    """flax's ``nn.Dense``: a LeCun-normal kernel (or U(-b, b) with ``kernel_bound`` b) and a
    zero bias."""
    layer = direct(skip_init(nn.Linear, in_features, out_features))
    if kernel_bound is None:
        lecun_normal_(layer.weight, in_features, generator)
    else:
        with torch.no_grad():
            layer.weight.uniform_(-kernel_bound, kernel_bound, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def _embed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token ids through the embedding table; float embeddings as they are."""
    return table[x] if not torch.is_floating_point(x) else x


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, hidden: int, norm_first: bool = False, generator=None):
        super().__init__()
        self.num_heads, self.norm_first = num_heads, norm_first
        self.attn_qkv = _dense(dim, 3 * dim, generator)
        self.attn_out = _dense(dim, dim, generator)
        self.linear1 = _dense(dim, hidden, generator)
        self.linear2 = _dense(hidden, dim, generator)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def attention(self, h: torch.Tensor) -> torch.Tensor:
        batch, tokens, dim = h.shape
        head_dim = dim // self.num_heads
        q, k, v = (t.reshape(batch, tokens, self.num_heads, head_dim).transpose(1, 2)
                   for t in self.attn_qkv(h).chunk(3, dim=-1))
        scores = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(head_dim), dim=-1)
        return self.attn_out((scores @ v).transpose(1, 2).reshape(batch, tokens, dim))

    def feedforward(self, h: torch.Tensor, capture: dict | None, name: str) -> torch.Tensor:
        if capture is not None:  # Decepticon's calibration probe
            capture[f"{name}/ff_input"] = h
        return self.linear2(F.relu(self.linear1(h)))

    def forward(self, x: torch.Tensor, capture: dict | None = None, name: str = "") -> torch.Tensor:
        if self.norm_first:
            x = x + self.attention(self.norm1(x))
            return x + self.feedforward(self.norm2(x), capture, name)
        x = self.norm1(x + self.attention(x))
        return self.norm2(x + self.feedforward(x, capture, name))


class TransformerModel(nn.Module):
    def __init__(self, ntokens: int, ninp: int, nhead: int, nhid: int, nlayers: int,
                 positional_embedding: str = "fixed", tie_weights: bool = False, norm_first: bool = False,
                 max_len: int = 1024, num_classes: int | None = None, generator=None):
        super().__init__()
        self.ninp, self.nhid, self.nlayers = ninp, nhid, nlayers
        self.positional_embedding, self.max_len = positional_embedding, max_len
        self.tie_weights = tie_weights and num_classes is None
        self.embedding = nn.Parameter(torch.empty(ntokens, ninp))
        with torch.no_grad():
            self.embedding.uniform_(-0.1, 0.1, generator=generator).mul_(math.sqrt(ninp))
        if positional_embedding == "fixed":
            # a constant, not a buffer (a buffer would be shared as BatchNorm statistics are);
            # one copy per device and dtype
            self._tables = {None: torch.from_numpy(fixed_positional_encoding(max_len, ninp))}
        else:
            self.pos_embedding = nn.Parameter(torch.empty(max_len, ninp))
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 1.0, generator=generator)
        for i in range(nlayers):
            self.add_module(f"layer{i}", EncoderLayer(ninp, nhead, nhid, norm_first, generator))
        if num_classes is not None:
            self.classifier = _dense(ninp, num_classes, generator)
            self.head_param_keys = ("classifier.weight", "classifier.bias")
        elif self.tie_weights:
            self.decoder_bias = nn.Parameter(torch.zeros(ntokens))
            self.head_param_keys = ("embedding", "decoder_bias")
        else:
            self.decoder = _dense(ninp, ntokens, generator, kernel_bound=0.1)
            self.head_param_keys = ("decoder.weight", "decoder.bias")
        self.imprint_block = None
        layers = [f"layer{i}" for i in range(nlayers)]
        self.registry = dict(
            embedding="embedding",
            pos_embedding="pos_embedding" if positional_embedding != "fixed" else None,
            decoder="decoder" if hasattr(self, "decoder") else None,
            decoder_bias="decoder_bias" if self.tie_weights else "decoder.bias",
            attention_qkv=[f"{layer}.attn_qkv" for layer in layers],
            attention_out=[f"{layer}.attn_out" for layer in layers],
            ff_first=[f"{layer}.linear1" for layer in layers],
            ff_second=[f"{layer}.linear2" for layer in layers],
            norms=[f"{layer}.{norm}" for layer in layers for norm in ("norm1", "norm2")],
            nlayers=nlayers,
            kernel_layout="out_in",
        )

    def flax_entries(self, prefix: str):
        yield "params/embedding", self.embedding, None
        if self.positional_embedding != "fixed":
            yield "params/pos_embedding", self.pos_embedding, None
        if self.tie_weights:
            yield "params/decoder_bias", self.decoder_bias, None

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        h = _embed(x, self.embedding)
        if self.imprint_block is not None:
            h = self.imprint_block(h, train=train)
        tokens = h.shape[1]
        if self.positional_embedding == "fixed":
            key = (h.device, h.dtype)
            if key not in self._tables:
                self._tables[key] = self._tables[None].to(h)
            h = h + self._tables[key][:tokens]
        else:
            h = h + self.pos_embedding[:tokens]
        for i in range(self.nlayers):
            h = getattr(self, f"layer{i}")(h, capture, f"layer{i}")
        if capture is not None:
            capture["features"] = h
        if features:
            return h
        if hasattr(self, "classifier"):
            return self.classifier(h[:, 0, :])
        if self.tie_weights:
            return h @ self.embedding.T + self.decoder_bias
        return self.decoder(h)


def _orthogonal_(tensor: torch.Tensor, generator) -> None:
    """flax's ``orthogonal`` initializer on a square (in, out) kernel: the Q factor of a
    standard normal matrix, with the signs of R's diagonal."""
    q, r = torch.linalg.qr(torch.randn(tensor.shape, generator=generator))
    with torch.no_grad():
        tensor.copy_(q * torch.sign(torch.diagonal(r)))


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` over a whole sequence, kernels in flax's (in, out)
    layout: ``i{i,f,g,o}`` on the input without bias, ``h{i,f,g,o}`` on the hidden
    state with bias (``hi_bias``), named ``lstm/<gate>/kernel`` in the flat layout."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, ninp: int, nhid: int, generator=None):
        super().__init__()
        self.nhid = nhid
        for gate in self.GATES:
            kernel = nn.Parameter(torch.empty(ninp, nhid))
            lecun_normal_(kernel, ninp, generator)
            self.register_parameter(f"i{gate}", kernel)
        for gate in self.GATES:
            kernel = nn.Parameter(torch.empty(nhid, nhid))
            _orthogonal_(kernel, generator)
            self.register_parameter(f"h{gate}", kernel)
            self.register_parameter(f"h{gate}_bias", nn.Parameter(torch.zeros(nhid)))

    def flax_entries(self, prefix: str):
        for gate in self.GATES:
            yield f"params/{prefix}/i{gate}/kernel", getattr(self, f"i{gate}"), None
            yield f"params/{prefix}/h{gate}/kernel", getattr(self, f"h{gate}"), None
            yield f"params/{prefix}/h{gate}/bias", getattr(self, f"h{gate}_bias"), None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, ninp) -> the hidden states (B, T, nhid) from a zero carry."""
        input_kernel = torch.cat([getattr(self, f"i{g}") for g in self.GATES], dim=1)
        hidden_kernel = torch.cat([getattr(self, f"h{g}") for g in self.GATES], dim=1)
        hidden_bias = torch.cat([getattr(self, f"h{g}_bias") for g in self.GATES])
        from_input = x @ input_kernel
        c = h = x.new_zeros(x.shape[0], self.nhid)
        outputs = []
        for t in range(x.shape[1]):
            i, f, g, o = ((h @ hidden_kernel + hidden_bias) + from_input[:, t]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outputs.append(h)
        return torch.stack(outputs, dim=1)


class LSTMModel(nn.Module):
    def __init__(self, ntokens: int, ninp: int = 96, nhid: int = 96, tie_weights: bool = True, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(ntokens, ninp))
        with torch.no_grad():
            self.embedding.uniform_(-0.1, 0.1, generator=generator)
        self.lstm = LSTMCell(ninp, nhid, generator)
        self.tied = tie_weights and nhid == ninp
        if self.tied:
            self.decoder_bias = nn.Parameter(torch.zeros(ntokens))
            self.head_param_keys = ("embedding", "decoder_bias")
        else:
            self.decoder = _dense(nhid, ntokens, generator)
            self.head_param_keys = ("decoder.weight", "decoder.bias")
        # the JAX package's registry names the untied decoder's bias for every LSTM
        self.registry = dict(embedding="embedding", decoder_bias="decoder.bias")

    def flax_entries(self, prefix: str):
        yield "params/embedding", self.embedding, None
        if self.tied:
            yield "params/decoder_bias", self.decoder_bias, None

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        outputs = self.lstm(_embed(x, self.embedding))
        if capture is not None:
            capture["features"] = outputs
        if features:
            return outputs
        if self.tied:
            return outputs @ self.embedding.T + self.decoder_bias
        return self.decoder(outputs)


class LinearLM(nn.Module):
    def __init__(self, ntokens: int, ninp: int = 200, generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(ntokens, ninp))
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.1, generator=generator)
        self.decoder = _dense(ninp, ntokens, generator)
        self.head_param_keys = ("decoder.weight", "decoder.bias")
        self.registry = dict(embedding="embedding", decoder_bias="decoder.bias")

    def flax_entries(self, prefix: str):
        yield "params/embedding", self.embedding, None

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        h = _embed(x, self.embedding)
        if capture is not None:
            capture["features"] = h
        return h if features else self.decoder(h)


HF_NAMES = ("gpt2S", "bert-sanity-check")


def _gpt2_registry(nlayers):
    """The JAX package's ``_gpt2_registry`` in the port's names: GPT-2's Conv1D weights
    are (out, in) as every weight of the port is, and the fused ``c_attn`` holds rows
    [q; k; v]."""
    h = lambda i, rest: f"transformer.h.{i}.{rest}"
    return dict(
        embedding="transformer.wte.weight",
        pos_embedding="transformer.wpe.weight",
        decoder_bias=None,  # GPT-2's LM head is tied and has no bias
        attention_qkv=[h(i, "attn.c_attn") for i in range(nlayers)],
        attention_out=[h(i, "attn.c_proj") for i in range(nlayers)],
        ff_first=[h(i, "mlp.c_fc") for i in range(nlayers)],
        ff_second=[h(i, "mlp.c_proj") for i in range(nlayers)],
        norms=[h(i, n) for i in range(nlayers) for n in ("ln_1", "ln_2")],
        first_ff_norm="transformer.h.0.ln_2",  # pre-LN: the FF input
        kernel_layout="out_in",
        nlayers=nlayers,
    )


def _encoder_registry(trunk, nlayers, decoder_bias):
    """The JAX package's ``_bert_registry`` and ``_roberta_registry``: separate query, key
    and value modules, post-LN, the embedding LayerNorm in front of the first block."""
    l = lambda i, rest: f"{trunk}.encoder.layer.{i}.{rest}"
    return dict(
        embedding=f"{trunk}.embeddings.word_embeddings.weight",
        pos_embedding=f"{trunk}.embeddings.position_embeddings.weight",
        type_embedding=f"{trunk}.embeddings.token_type_embeddings.weight",
        decoder_bias=decoder_bias,
        attention_qkv=[{n: l(i, f"attention.self.{n}") for n in ("query", "key", "value")} for i in range(nlayers)],
        attention_out=[l(i, "attention.output.dense") for i in range(nlayers)],
        ff_first=[l(i, "intermediate.dense") for i in range(nlayers)],
        ff_second=[l(i, "output.dense") for i in range(nlayers)],
        first_ff_norm=l(0, "attention.output.LayerNorm"),
        embedding_norm=f"{trunk}.embeddings.LayerNorm",
        kernel_layout="out_in",
        nlayers=nlayers,
    )


def _bert_registry(nlayers):
    return _encoder_registry("bert", nlayers, "cls.predictions.bias")


def _roberta_registry(nlayers):
    return dict(_encoder_registry("roberta", nlayers, "lm_head.bias"), pos_offset=2)  # positions from pad + 1


def _distilbert_registry(nlayers):
    """The JAX package's ``_distilbert_registry``: q_lin, k_lin, v_lin, out_lin and
    ffn.lin1, ffn.lin2, post-LN, a tied ``vocab_projector``."""
    l = lambda i, rest: f"distilbert.transformer.layer.{i}.{rest}"
    return dict(
        embedding="distilbert.embeddings.word_embeddings.weight",
        pos_embedding="distilbert.embeddings.position_embeddings.weight",
        decoder_bias="vocab_projector.bias",
        attention_qkv=[dict(query=l(i, "attention.q_lin"), key=l(i, "attention.k_lin"), value=l(i, "attention.v_lin"))
                       for i in range(nlayers)],
        attention_out=[l(i, "attention.out_lin") for i in range(nlayers)],
        ff_first=[l(i, "ffn.lin1") for i in range(nlayers)],
        ff_second=[l(i, "ffn.lin2") for i in range(nlayers)],
        first_ff_norm=l(0, "sa_layer_norm"),
        embedding_norm="distilbert.embeddings.LayerNorm",
        kernel_layout="out_in",
        nlayers=nlayers,
    )


REGISTRIES = dict(gpt2=_gpt2_registry, bert=_bert_registry, roberta=_roberta_registry,
                  distilbert=_distilbert_registry)


def construct_hf_model(name: str, cfg_data, generator=None):
    """A HuggingFace architecture (``hf_models.HFModel``) for ``gpt2S``,
    ``bert-sanity-check`` or an ``hf-`` name, with its registry; named as the JAX package
    names it (``hf-gpt2S``, ``hf-bert-tiny``), which is also the name of its pretrained
    npz."""
    from .hf_models import HFModel, hf_config

    hf_name = name if name in HF_NAMES else name[len("hf-"):]
    task = cfg_data.get("task", None)
    classes = int(cfg_data.classes) if task == "classification" else None
    config = hf_config(hf_name, int(cfg_data.vocab_size), int(cfg_data.shape[0]), num_labels=classes)
    model = HFModel(config, generator=generator)
    model.registry = REGISTRIES[config.family](config.layers)
    model.name = f"hf-{hf_name}"
    return model


def construct_text_model(cfg_model, cfg_data, generator=None):
    """(model, loss class) for every name of the JAX package's text factory
    (``construct_text_model``): ``transformer3f``, ``transformer3``, ``transformer3t``,
    ``transformer1``, ``transformerS``, ``LSTM``, ``linear``, ``gpt2-tiny``, ``bert-tiny``,
    the HuggingFace architectures (``gpt2S``, ``bert-sanity-check``, ``hf-gpt2``,
    ``hf-bert``, ``hf-roberta*``, ``hf-distilbert``, each with ``-tiny``;
    ``construct_hf_model``), and any other name holding ``gpt2`` (768 wide, 12 layers and
    heads, 3,072 FF, pre-LN, tied) or ``bert`` (the same widths, post-LN, untied).
    ``task=classification`` puts the classifier head on a transformer or on an encoder's
    HuggingFace architecture."""
    from .losses import LOSSES, CausalLoss

    name = str(cfg_model)
    vocab = int(cfg_data.vocab_size)
    task = cfg_data.get("task", None)
    classes = int(cfg_data.classes) if task == "classification" else None
    kwargs = dict(num_classes=classes, generator=generator)
    small = (vocab, 96, 8, 1536, 3)
    if name in HF_NAMES or name.startswith("hf-"):
        model = construct_hf_model(name, cfg_data, generator=generator)
    elif name == "transformer3f":
        model = TransformerModel(*small, positional_embedding="fixed", **kwargs)
    elif name in ("transformer3", "bert-tiny"):
        model = TransformerModel(*small, positional_embedding="learnable", **kwargs)
    elif name == "transformer3t":
        model = TransformerModel(*small, positional_embedding="learnable", tie_weights=True, **kwargs)
    elif name == "transformer1":
        model = TransformerModel(vocab, 200, 1, 200, 1, **kwargs)
    elif name == "transformerS":
        model = TransformerModel(vocab, 512, 1, 512, 1, **kwargs)
    elif name == "gpt2-tiny":
        model = TransformerModel(*small, positional_embedding="learnable", norm_first=True, tie_weights=True,
                                 **kwargs)
    elif name in ("LSTM", "linear"):
        if classes is not None:
            raise ValueError(f"task=classification needs a transformer model, got {name}.")
        model = LSTMModel(vocab, generator=generator) if name == "LSTM" else LinearLM(vocab, generator=generator)
    elif "gpt2" in name.lower():
        model = TransformerModel(vocab, 768, 12, 3072, 12, positional_embedding="learnable", norm_first=True,
                                 tie_weights=True, **kwargs)
    elif "bert" in name.lower():
        model = TransformerModel(vocab, 768, 12, 3072, 12, positional_embedding="learnable", **kwargs)
    else:
        raise ValueError(f"Unknown text model {cfg_model}.")
    model.modality = "text"
    return model, LOSSES.get(task or "causal-lm", CausalLoss)
