"""A word-level tokenizer in plain Python (counterpart of
``breaching_tpu/cases/data/wordlevel_tokenizer.py``, which trains the ``tokenizers``
library's ``WordLevel`` model; the port depends on no tokenizer library).

Training follows that library's ``WordLevelTrainer`` under a ``Whitespace``
pre-tokenizer: each line splits into the runs of ``\\w+|[^\\w\\s]+``, the words are
counted, and the vocabulary is the special tokens (``<unk>``, ``<pad>``, ``<bos>``,
``<eos>``), then the words by count, most frequent first, ties in string order, with
duplicates dropped, cut at ``vocab_size``; ids in that order. A word outside the
vocabulary encodes as ``<unk>``. ``save`` and ``load`` keep the vocabulary in a JSON
file of the port's own.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from types import SimpleNamespace

SPECIAL_TOKENS = ("<unk>", "<pad>", "<bos>", "<eos>")
_WHITESPACE_SPLIT = re.compile(r"\w+|[^\w\s]+")


def pre_tokenize(text: str) -> list[str]:
    return _WHITESPACE_SPLIT.findall(text)


class WordLevelTokenizer:
    def __init__(self, vocab: dict, unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.unk_token = unk_token
        self._inverse = {i: w for w, i in self.vocab.items()}

    @classmethod
    def train(cls, lines, vocab_size: int, special_tokens=SPECIAL_TOKENS):
        counts = Counter(word for line in lines for word in pre_tokenize(line))
        ordered = sorted(counts.items(), key=lambda item: (-item[1], item[0]))
        vocab = {}
        for word in list(special_tokens) + [w for w, _ in ordered]:
            if len(vocab) == vocab_size:
                break
            vocab.setdefault(word, len(vocab))
        return cls(vocab)

    def encode(self, text: str):
        unk = self.vocab[self.unk_token]
        return SimpleNamespace(ids=[self.vocab.get(word, unk) for word in pre_tokenize(text)])

    def decode(self, ids) -> str:
        return " ".join(self._inverse.get(int(i), self.unk_token) for i in ids)

    def get_vocab(self) -> dict:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(dict(model=dict(type="WordLevel", vocab=self.vocab, unk_token=self.unk_token),
                           pre_tokenizer=dict(type="Whitespace")), fh)

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            model = json.load(fh)["model"]
        return cls(model["vocab"], model["unk_token"])


def generate_word_level_tokenizer(lines=None, vocab_size: int = 10_004, save_path=None) -> WordLevelTokenizer:
    """Train on ``lines`` (without them, on the JAX package's synthetic corpus: 2,000 lines
    of 16 words drawn from ``word0``, ..., by numpy's generator of seed 0) and save to
    ``save_path`` if given."""
    if lines is None:
        import numpy as np

        rng = np.random.default_rng(0)
        words = [f"word{i}" for i in range(vocab_size * 2)]
        lines = [" ".join(rng.choice(words, size=16)) for _ in range(2000)]
    tokenizer = WordLevelTokenizer.train(lines, vocab_size)
    if save_path:
        tokenizer.save(str(save_path))
    return tokenizer
