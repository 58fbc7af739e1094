"""Text datasets with federated partitions, a copy of
``breaching_tpu/cases/data/datasets_text.py`` on the port's tokenizers.

Without a ``<path>/<name>_<split>.npz`` file (``input_ids`` (N, T), optionally
``labels``) the corpus is synthetic, generated per index from the dataset's name, split
and index, token for token the JAX package's: Zipf-Mandelbrot unigrams (P(rank r) ~
1/(r + 2.7)^1.1) through ``searchsorted`` on the same CDF, where each position after the
first, with probability 0.3, steps 1-16 ids past its predecessor; ``random-tokens`` is
uniform. Labels follow the task: the ids (causal LM); for ``masked-lm`` the ids at a
``mlm_probability`` share of positions drawn per index and -100 elsewhere; for
``classification`` the npz's labels, or the parity of the count of ids below vocab / 8
modulo the classes. Each of ``default_clients`` users owns a contiguous range of
sequences; with ``<path>/<name>.sqlite`` in the TFF schema (stackoverflow, shakespeare)
a user is one of its clients, whose texts are tokenized and grouped into blocks.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from .datasets_vision import _stable_seed

_ZM_CDF_CACHE: dict = {}


def _zipf_mandelbrot_cdf(vocab_size: int, a: float = 1.1, b: float = 2.7) -> np.ndarray:
    """Cumulative rank-frequency distribution P(r) ~ 1/(r+b)^a over the vocab."""
    key = (vocab_size, a, b)
    if key not in _ZM_CDF_CACHE:
        w = 1.0 / (np.arange(1, vocab_size + 1) + b) ** a
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        _ZM_CDF_CACHE[key] = cdf
    return _ZM_CDF_CACHE[key]


class CharTokenizer:
    """Character-level tokenizer: printable ASCII 32..126 -> 1..95 (clamped to
    vocab-1), everything else -> 0 (<unk>)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)

    def encode(self, text: str):
        ids = [min(ord(c) - 31, self.vocab_size - 1) if 32 <= ord(c) <= 126 else 0 for c in text]
        return SimpleNamespace(ids=ids)

    def decode(self, ids) -> str:
        return "".join(chr(int(i) + 31) if 1 <= int(i) <= 95 else "?" for i in ids)

    def get_vocab_size(self) -> int:
        return self.vocab_size


class CanineTokenizer:
    """``transformers``' ``CanineTokenizer`` as the JAX package calls it
    (``add_special_tokens=False``): a token is a Unicode code point, ``decode`` their
    characters; the vocabulary is every code point (0x110000)."""

    vocab_size = 0x110000

    def encode(self, text: str):
        return SimpleNamespace(ids=[ord(c) for c in text])

    def decode(self, ids) -> str:
        return "".join(chr(int(i)) for i in ids)

    def get_vocab_size(self) -> int:
        return self.vocab_size


def tokenizer_for(cfg_data, lines=None):
    """``cfg.data.tokenizer`` as an object with ``.encode(text).ids``: ``character``,
    ``canine`` (Unicode code points, ``CanineTokenizer``), or ``word-level``
    (``<path>/cache/word-tokenizer_<vocab>.json`` where present, else trained on ``lines``
    and saved there); any other name (``GPT-2``, ``bert-*``) needs a download, as in the
    JAX package."""
    name = str(cfg_data.tokenizer)
    if name == "character":
        return CharTokenizer(cfg_data.vocab_size)
    if name == "canine":
        return CanineTokenizer()
    if name == "word-level":
        from .wordlevel_tokenizer import WordLevelTokenizer, generate_word_level_tokenizer

        path = os.path.expanduser(os.path.join(str(cfg_data.path), "cache",
                                               f"word-tokenizer_{cfg_data.vocab_size}.json"))
        if os.path.isfile(path):
            return WordLevelTokenizer.load(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return generate_word_level_tokenizer(lines=lines, vocab_size=int(cfg_data.vocab_size), save_path=path)
    raise ValueError(f"Tokenizer {name} requires a network fetch; pre-tokenize "
                     f"to npz with prepare_text_data.py instead.")


class TextDataset:
    def __init__(self, cfg_data, split: str, indices=None):
        self._configure(cfg_data, split)
        self._raw, self._raw_labels = self._load_real(cfg_data, split)
        self._size = len(self._raw) if self._raw is not None else min(int(cfg_data.size), 200_000)
        self.indices = np.arange(self._size) if indices is None else np.asarray(indices)

    def _configure(self, cfg_data, split):
        self.cfg = cfg_data
        self.name = cfg_data.name
        self.split = split
        self.seq_len = int(cfg_data.shape[0])
        self.vocab_size = int(cfg_data.vocab_size)
        self.task = cfg_data.task
        self.mlm_probability = float(cfg_data.get("mlm_probability", 0.15) or 0.15)

    @staticmethod
    def _load_real(cfg_data, split):
        """(input_ids, labels or None) of ``<path>/<name>_<split>.npz``, read once."""
        path = os.path.expanduser(os.path.join(str(cfg_data.path), f"{cfg_data.name}_{split}.npz"))
        if os.path.exists(path):
            with np.load(path) as z:
                return z["input_ids"], (z["labels"] if "labels" in z.files else None)
        return None, None

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int):
        gidx = int(self.indices[idx])
        if self._raw is not None:
            ids = self._raw[gidx][: self.seq_len].astype(np.int64)
        else:
            ids = self._synthesize(gidx)
        return dict(input_ids=ids, labels=self._labels_for(ids, gidx))

    def _synthesize(self, gidx: int) -> np.ndarray:
        rng = np.random.default_rng(_stable_seed(self.name, self.split, gidx))
        if self.name == "random-tokens":
            return rng.integers(0, self.vocab_size, self.seq_len, dtype=np.int64)
        cdf = _zipf_mandelbrot_cdf(self.vocab_size)
        ids = np.searchsorted(cdf, rng.uniform(size=self.seq_len)).astype(np.int64)
        for t in range(1, self.seq_len):
            if rng.uniform() < 0.3:
                ids[t] = (ids[t - 1] + rng.integers(1, 17)) % self.vocab_size
        return ids

    def _labels_for(self, ids: np.ndarray, gidx: int):
        if self.task == "classification":
            if self._raw is not None and self._raw_labels is not None:
                return np.int64(self._raw_labels[gidx])
            classes = int(self.cfg.get("classes", 2) or 2)
            return np.int64(int((ids < self.vocab_size // 8).sum()) % classes)
        if self.task == "masked-lm" and not self.cfg.get("disable_mlm", False):
            rng = np.random.default_rng(_stable_seed("mlm", self.name, gidx))
            labels = np.full_like(ids, -100)
            mask = rng.uniform(size=len(ids)) < self.mlm_probability
            labels[mask] = ids[mask]
            return labels
        return ids.copy()

    def subset(self, indices):
        view = TextDataset.__new__(TextDataset)
        view.__dict__.update(self.__dict__)
        view.indices = self.indices[np.asarray(indices)]
        return view

    @classmethod
    def from_input_ids(cls, cfg_data, split: str, input_ids: np.ndarray):
        """Wrap an in-memory (N, T) token array (a TFF client's blocks)."""
        self = cls.__new__(cls)
        self._configure(cfg_data, split)
        self._raw = np.asarray(input_ids, np.int64)
        self._raw_labels = None
        self._size = len(self._raw)
        self.indices = np.arange(self._size)
        return self


def _build_tff_dataset(cfg_data, db_path: str, user_idx, return_full_dataset: bool):
    """A TFF client's texts as a dataset (the full dataset: the first 250 clients)."""
    from .prepare_text_data import tokenize_and_group
    from .tff_sqlite import TFF_TEXT_FIELDS, client_ids, load_client_texts, tff_split_name

    split = cfg_data.examples_from_split
    split_name = tff_split_name(cfg_data.name, split)
    field = TFF_TEXT_FIELDS[cfg_data.name]
    if return_full_dataset:
        texts = []
        for idx in range(min(len(client_ids(db_path, split_name)), 250)):
            texts.extend(load_client_texts(db_path, idx, split_name, field))
    else:
        texts = load_client_texts(db_path, int(user_idx or 0), split_name, field)
    if not texts:
        raise ValueError(f"This user does not exist or has no data in {db_path}.")
    ids = tokenize_and_group(texts, tokenizer_for(cfg_data, texts), int(cfg_data.shape[0]))
    return TextDataset.from_input_ids(cfg_data, split, ids)


def build_text_dataset(cfg_data, user_idx, return_full_dataset: bool = False):
    db_path = os.path.expanduser(os.path.join(str(cfg_data.path), f"{cfg_data.name}.sqlite"))
    if cfg_data.name in ("stackoverflow", "shakespeare") and os.path.exists(db_path):
        return _build_tff_dataset(cfg_data, db_path, user_idx, return_full_dataset)
    full = TextDataset(cfg_data, split=cfg_data.examples_from_split)
    if return_full_dataset:
        return full
    num_users = int(cfg_data.default_clients)
    per_user = max(len(full) // num_users, 1)
    user_idx = 0 if user_idx is None else user_idx
    if user_idx >= num_users or user_idx * per_user >= len(full):
        raise ValueError(f"user_idx {user_idx} exceeds the {num_users} text users.")
    return full.subset(np.arange(user_idx * per_user, min((user_idx + 1) * per_user, len(full))))
