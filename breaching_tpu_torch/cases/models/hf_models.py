"""The HuggingFace text architectures, written in PyTorch without ``transformers``
(counterpart of ``breaching_tpu/cases/models/language_models.py:392-616`` and of the Flax
classes it builds there): the GPT-2 LM head, BERT, RoBERTa and DistilBERT masked-LM
heads, and the sequence-classification heads of the three encoders.

Each model is built from an ``HFConfig`` and names its parameters by the Flax tree's
paths, dotted (``transformer.h.0.attn.c_attn.weight``,
``bert.encoder.layer.0.attention.self.query.weight``), so that a registry, the weight
bridge (``model_preparation.load_flat_state``) and the tests read one name for one leaf.
``flax_entries`` gives the bridge each leaf's Flax key and layout: an ``Embed``'s table
is ``<name>/embedding``, a LayerNorm's ``scale`` and ``bias``, a ``Dense`` kernel
``<name>/kernel`` in flax's (in, out), transposed into the (out, in) weight here, and
GPT-2's ``FlaxConv1D`` kernel, which Flax already stores (out, in), not transposed.

What the forward keeps of the Flax models:

- dropout is off (the JAX package calls them with ``deterministic=True``);
- attention is matmul, softmax, matmul, the query scaled by 1/sqrt(head_dim) before the
  product (``flax.linen.dot_product_attention_weights``); GPT-2 adds a causal bias of
  ``finfo(dtype).min`` above the diagonal before the softmax, the encoders attend
  everywhere (an all-ones mask is a zero bias). The attacks differentiate the
  gradient, and fused attention has no double backward;
- a float (B, T, D) input replaces the word embedding's output only; positions, token
  type 0 and the embedding LayerNorm still apply (HF's ``inputs_embeds``). RoBERTa's
  positions start at ``pad_token_id + 1``;
- activations: ``gelu`` is the exact erf form, ``gelu_new`` the tanh form; RoBERTa's LM
  head applies exact GELU whatever ``hidden_act`` says, DistilBERT's classifier ReLU;
- the LM heads are tied to the word embedding: GPT-2 without a bias, the others with
  one (``cls.predictions.bias``, ``lm_head.bias``, ``vocab_projector.bias``);
- a forward given a ``capture`` dict records each block's feed-forward input under
  ``layer<i>/ff_input`` (GPT-2's ``ln_2`` output, BERT's and RoBERTa's
  ``attention.output.LayerNorm`` output, DistilBERT's ``sa_layer_norm`` output) and the
  pre-head ``features`` (GPT-2's ``ln_f`` output, else the last block's
  ``ff_input``), which ``features=True`` returns.

Random initialization is HF's ``_init_weights``: N(0, 0.02) for dense kernels and tables,
zero biases, LayerNorm 1 and 0, drawn from the explicit generator (tensors on the
``meta`` device are left undrawn, so that a full-width model can be counted there).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm

ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu, "gelu_new": partial(F.gelu, approximate="tanh")}


@dataclass(frozen=True)
class HFConfig:
    """The widths and options of one HuggingFace architecture (the JAX package's
    ``GPT2Config``, ``BertConfig``, ``RobertaConfig`` or ``DistilBertConfig``)."""

    family: str  # gpt2, bert, roberta or distilbert
    vocab_size: int
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    activation: str = "gelu"
    eps: float = 1e-12
    type_vocab: int = 2
    pad_token_id: int = 0
    num_labels: int | None = None  # a sequence-classification head with this many classes


def hf_config(name: str, vocab: int, seq_len: int, num_labels: int | None = None) -> HFConfig:
    """The JAX package's configuration of ``name`` (``gpt2S``, ``bert-sanity-check``, or an
    ``hf-`` name without its prefix; ``-tiny`` for the test scales), ``roberta`` and
    ``distilbert`` told apart before ``bert``."""
    tiny = dict(hidden=96, layers=3, heads=8, intermediate=384)
    small = name.endswith("-tiny")
    if "gpt2" in name:
        activation = "relu" if name == "gpt2S" else "gelu_new"
        config = HFConfig("gpt2", vocab, max_positions=64 if small else 1024, activation=activation, eps=1e-5,
                          **(tiny if small else {}))
    elif "roberta" in name:
        positions = seq_len + 4 if small else max(514, seq_len + 4)
        config = HFConfig("roberta", vocab, max_positions=positions, pad_token_id=1, **(tiny if small else {}))
    elif "distilbert" in name:
        config = HFConfig("distilbert", vocab, layers=3 if small else 6, hidden=96 if small else 768,
                          heads=8 if small else 12, intermediate=384 if small else 3072,
                          max_positions=64 if small else 512)
    elif "bert" in name:
        if small:
            config = HFConfig("bert", vocab, max_positions=64, **tiny)
        else:
            config = HFConfig("bert", vocab, activation="relu" if name == "bert-sanity-check" else "gelu")
    else:
        raise ValueError(f"Unsupported HuggingFace model {name}.")
    if num_labels is not None:
        if config.family == "gpt2":
            raise ValueError(f"No sequence-classification head for {name} (transformers ships none for gpt2).")
        config = dataclasses.replace(config, num_labels=num_labels)
    return config


def _normal_(tensor: torch.Tensor, generator) -> torch.Tensor:
    if not tensor.is_meta:
        with torch.no_grad():
            tensor.normal_(0.0, 0.02, generator=generator)
    return tensor


class Embed(nn.Module):
    """flax's ``nn.Embed``: a table ``weight`` (num, dim), ``<name>/embedding`` in Flax."""

    def __init__(self, num: int, dim: int, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_normal_(torch.empty(num, dim), generator))

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/embedding", self.weight, None


class Dense(nn.Module):
    """x W^T + b with W (out, in): flax's ``nn.Dense`` (kernel (in, out) in Flax) or, with
    ``conv1d``, GPT-2's ``FlaxConv1D`` (kernel (out, in) in Flax)."""

    def __init__(self, in_features: int, out_features: int, generator=None, conv1d: bool = False):
        super().__init__()
        self.conv1d = conv1d
        self.weight = nn.Parameter(_normal_(torch.empty(out_features, in_features), generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/kernel", self.weight, None if self.conv1d else np.transpose
        yield f"params/{prefix}/bias", self.bias, None


class Node(nn.Module):
    """A named level of the Flax tree that holds submodules."""

    def __init__(*args, **children: nn.Module):
        node, = args  # positional only: a child may be called "self" (BERT's attention.self)
        super(Node, node).__init__()
        for name, child in children.items():
            node.add_module(name, child)


class BiasedNode(Node):
    """A level that holds a ``bias`` leaf of its own beside its submodules: an LM head's
    output bias (``cls.predictions.bias``, ``lm_head.bias``, ``vocab_projector.bias``)."""

    def __init__(self, features: int, **children: nn.Module):
        super().__init__(**children)
        self.bias = nn.Parameter(torch.zeros(features))

    def flax_entries(self, prefix: str):
        yield f"params/{prefix}/bias", self.bias, None


def _embed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Token ids through the table; float embeddings as they are (HF's ``inputs_embeds``)."""
    return table[x] if not torch.is_floating_point(x) else x


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, causal: bool = False) -> torch.Tensor:
    """Multi-head attention over (B, T, D) projections, written out: the query scaled
    before the product, with ``causal`` the bias finfo(dtype).min above the diagonal."""
    batch, tokens, dim = q.shape
    head_dim = dim // heads
    q, k, v = (t.reshape(batch, tokens, heads, head_dim).transpose(1, 2) for t in (q, k, v))
    scores = (q / math.sqrt(head_dim)) @ k.transpose(-1, -2)
    if causal:
        scores = scores + torch.full((tokens, tokens), torch.finfo(scores.dtype).min, dtype=scores.dtype,
                                     device=scores.device).triu(1)
    return (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(batch, tokens, dim)


def _tap(capture: dict | None, i: int, ff_input: torch.Tensor) -> None:
    if capture is not None:  # Decepticon's calibration probe
        capture[f"layer{i}/ff_input"] = ff_input


# ------------------------------------------------------------------ GPT-2


class GPT2Block(nn.Module):
    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        d = c.hidden
        self.heads, self.act = c.heads, ACTIVATIONS[c.activation]
        self.ln_1 = LayerNorm(d, c.eps)
        self.attn = Node(c_attn=Dense(d, 3 * d, generator, conv1d=True), c_proj=Dense(d, d, generator, conv1d=True))
        self.ln_2 = LayerNorm(d, c.eps)
        self.mlp = Node(c_fc=Dense(d, c.intermediate, generator, conv1d=True),
                        c_proj=Dense(c.intermediate, d, generator, conv1d=True))

    def forward(self, x: torch.Tensor, capture: dict | None, i: int) -> torch.Tensor:
        q, k, v = self.attn.c_attn(self.ln_1(x)).chunk(3, dim=-1)
        x = x + self.attn.c_proj(attend(q, k, v, self.heads, causal=True))
        ff_input = self.ln_2(x)
        _tap(capture, i, ff_input)
        return x + self.mlp.c_proj(self.act(self.mlp.c_fc(ff_input)))


class GPT2Trunk(nn.Module):
    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        self.wte = Embed(c.vocab_size, c.hidden, generator)
        self.wpe = Embed(c.max_positions, c.hidden, generator)
        self.h = nn.ModuleList([GPT2Block(c, generator) for _ in range(c.layers)])
        self.ln_f = LayerNorm(c.hidden, c.eps)

    def forward(self, x: torch.Tensor, capture: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
        h = _embed(x, self.wte.weight) + self.wpe.weight[: x.shape[1]]
        for i, block in enumerate(self.h):
            h = block(h, capture, i)
        h = self.ln_f(h)
        return h, h


# ------------------------------------------------------------------ BERT and RoBERTa


class BertLayer(nn.Module):
    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        d = c.hidden
        self.heads, self.act = c.heads, ACTIVATIONS[c.activation]
        self.attention = Node(**{
            "self": Node(query=Dense(d, d, generator), key=Dense(d, d, generator), value=Dense(d, d, generator)),
            "output": Node(dense=Dense(d, d, generator), LayerNorm=LayerNorm(d, c.eps))})
        self.intermediate = Node(dense=Dense(d, c.intermediate, generator))
        self.output = Node(dense=Dense(c.intermediate, d, generator), LayerNorm=LayerNorm(d, c.eps))

    def forward(self, x: torch.Tensor, capture: dict | None, i: int) -> torch.Tensor:
        qkv, out = getattr(self.attention, "self"), self.attention.output
        context = attend(qkv.query(x), qkv.key(x), qkv.value(x), self.heads)
        ff_input = out.LayerNorm(out.dense(context) + x)
        _tap(capture, i, ff_input)
        return self.output.LayerNorm(self.output.dense(self.act(self.intermediate.dense(ff_input))) + ff_input)


class BertTrunk(nn.Module):
    """BERT's and RoBERTa's embeddings and encoder, with BERT's pooler under its classifier."""

    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        self.pos_offset = c.pad_token_id + 1 if c.family == "roberta" else 0
        self.embeddings = Node(word_embeddings=Embed(c.vocab_size, c.hidden, generator),
                               position_embeddings=Embed(c.max_positions, c.hidden, generator),
                               token_type_embeddings=Embed(c.type_vocab, c.hidden, generator),
                               LayerNorm=LayerNorm(c.hidden, c.eps))
        self.encoder = Node(layer=nn.ModuleList([BertLayer(c, generator) for _ in range(c.layers)]))
        if c.family == "bert" and c.num_labels is not None:
            self.pooler = Node(dense=Dense(c.hidden, c.hidden, generator))

    def forward(self, x: torch.Tensor, capture: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
        e, start = self.embeddings, self.pos_offset
        h = (_embed(x, e.word_embeddings.weight) + e.token_type_embeddings.weight[0]
             + e.position_embeddings.weight[start:start + x.shape[1]])
        h = e.LayerNorm(h)
        taps = {}
        for i, layer in enumerate(self.encoder.layer):
            h = layer(h, taps, i)
        if capture is not None:
            capture.update(taps)
        return h, taps[f"layer{len(self.encoder.layer) - 1}/ff_input"]


# ------------------------------------------------------------------ DistilBERT


class DistilBertBlock(nn.Module):
    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        d = c.hidden
        self.heads, self.act = c.heads, ACTIVATIONS[c.activation]
        self.attention = Node(q_lin=Dense(d, d, generator), k_lin=Dense(d, d, generator),
                              v_lin=Dense(d, d, generator), out_lin=Dense(d, d, generator))
        self.sa_layer_norm = LayerNorm(d, 1e-12)
        self.ffn = Node(lin1=Dense(d, c.intermediate, generator), lin2=Dense(c.intermediate, d, generator))
        self.output_layer_norm = LayerNorm(d, 1e-12)

    def forward(self, x: torch.Tensor, capture: dict | None, i: int) -> torch.Tensor:
        a = self.attention
        ff_input = self.sa_layer_norm(a.out_lin(attend(a.q_lin(x), a.k_lin(x), a.v_lin(x), self.heads)) + x)
        _tap(capture, i, ff_input)
        return self.output_layer_norm(self.ffn.lin2(self.act(self.ffn.lin1(ff_input))) + ff_input)


class DistilBertTrunk(nn.Module):
    def __init__(self, c: HFConfig, generator=None):
        super().__init__()
        self.embeddings = Node(word_embeddings=Embed(c.vocab_size, c.hidden, generator),
                               position_embeddings=Embed(c.max_positions, c.hidden, generator),
                               LayerNorm=LayerNorm(c.hidden, 1e-12))
        self.transformer = Node(layer=nn.ModuleList([DistilBertBlock(c, generator) for _ in range(c.layers)]))

    def forward(self, x: torch.Tensor, capture: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
        e = self.embeddings
        h = e.LayerNorm(_embed(x, e.word_embeddings.weight) + e.position_embeddings.weight[: x.shape[1]])
        taps = {}
        for i, layer in enumerate(self.transformer.layer):
            h = layer(h, taps, i)
        if capture is not None:
            capture.update(taps)
        return h, taps[f"layer{len(self.transformer.layer) - 1}/ff_input"]


# ------------------------------------------------------------------ the models with their heads

TRUNKS = dict(gpt2=("transformer", GPT2Trunk), bert=("bert", BertTrunk), roberta=("roberta", BertTrunk),
              distilbert=("distilbert", DistilBertTrunk))


class HFModel(nn.Module):
    """One HuggingFace architecture with its LM head or, with ``config.num_labels``, its
    sequence-classification head. ``forward(x, train, features, capture)`` takes token
    ids (B, T) or embeddings (B, T, D) and gives logits (B, T, V) or (B, classes)."""

    def __init__(self, config: HFConfig, generator=None):
        super().__init__()
        c = self.config = config
        self.ninp, self.nhid, self.nlayers = c.hidden, c.intermediate, c.layers
        trunk_name, trunk_cls = TRUNKS[c.family]
        self.trunk_name = trunk_name
        self.add_module(trunk_name, trunk_cls(c, generator))
        d = c.hidden
        if c.num_labels is not None:
            if c.family == "bert":
                self.classifier = Dense(d, c.num_labels, generator)
                self.head_param_keys = ("classifier.weight", "classifier.bias")
            elif c.family == "roberta":
                self.classifier = Node(dense=Dense(d, d, generator), out_proj=Dense(d, c.num_labels, generator))
                self.head_param_keys = ("classifier.out_proj.weight", "classifier.out_proj.bias")
            else:
                self.pre_classifier = Dense(d, d, generator)
                self.classifier = Dense(d, c.num_labels, generator)
                self.head_param_keys = ("classifier.weight", "classifier.bias")
        else:
            # tied heads: the weight is the word embedding; the JAX package's head_grads
            # gives a zero bias for each of them
            self.head_param_keys = (f"{trunk_name}.{self._word_embedding_path()}.weight", None)
            if c.family == "bert":
                self.cls = Node(predictions=BiasedNode(c.vocab_size, transform=Node(
                    dense=Dense(d, d, generator), LayerNorm=LayerNorm(d, c.eps))))
            elif c.family == "roberta":
                self.lm_head = BiasedNode(c.vocab_size, dense=Dense(d, d, generator), layer_norm=LayerNorm(d, c.eps))
            elif c.family == "distilbert":
                self.vocab_transform = Dense(d, d, generator)
                self.vocab_layer_norm = LayerNorm(d, 1e-12)
                self.vocab_projector = BiasedNode(c.vocab_size)

    def _word_embedding_path(self) -> str:
        return "wte" if self.config.family == "gpt2" else "embeddings.word_embeddings"

    @property
    def word_embedding(self) -> torch.Tensor:
        return getattr(self, self.trunk_name).get_submodule(self._word_embedding_path()).weight

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False,
                capture: dict | None = None) -> torch.Tensor:
        c = self.config
        hidden, feats = getattr(self, self.trunk_name)(x, capture)
        if capture is not None:
            capture["features"] = feats
        if features:
            return feats
        if c.num_labels is not None:
            first = hidden[:, 0]
            if c.family == "bert":
                return self.classifier(torch.tanh(self.bert.pooler.dense(first)))
            if c.family == "roberta":
                return self.classifier.out_proj(torch.tanh(self.classifier.dense(first)))
            return self.classifier(F.relu(self.pre_classifier(first)))
        if c.family == "gpt2":
            return hidden @ self.word_embedding.T
        act = ACTIVATIONS[c.activation]
        if c.family == "bert":
            head = self.cls.predictions
            h = head.transform.LayerNorm(act(head.transform.dense(hidden)))
        elif c.family == "roberta":
            head = self.lm_head
            h = head.layer_norm(F.gelu(head.dense(hidden)))
        else:
            head = self.vocab_projector
            h = self.vocab_layer_norm(act(self.vocab_transform(hidden)))
        return h @ self.word_embedding.T + head.bias
