"""Pre-tokenized text datasets on disk (counterpart of
``breaching_tpu/cases/data/prepare_text_data.py``, on the port's word-level tokenizer).

The loaders of ``datasets_text.py`` read ``<path>/<name>_<split>.npz`` with an
``input_ids`` (N, T) array; this module writes that file from raw text: tokenize,
concatenate, drop the remainder, split into blocks of ``seq_len``.

    python3 -m breaching_tpu_torch.cases.data.prepare_text_data corpus.txt \\
        --out ~/data --name wikitext --split training --seq-len 32 --vocab 1024
"""

from __future__ import annotations

import os

import numpy as np


def tokenize_and_group(lines, tokenizer, seq_len: int):
    """Tokenize the non-empty lines, concatenate all ids, and split them into
    (N, seq_len) blocks; the ragged remainder is dropped."""
    all_ids: list[int] = []
    for line in lines:
        line = line.strip()
        if line:
            all_ids.extend(tokenizer.encode(line).ids)
    total = (len(all_ids) // seq_len) * seq_len
    if total == 0:
        raise ValueError(f"Corpus too small: {len(all_ids)} tokens < seq_len {seq_len}.")
    return np.asarray(all_ids[:total], np.int64).reshape(-1, seq_len)


def prepare_text_npz(lines, out_dir, name: str, split: str = "training", seq_len: int = 32,
                     vocab_size: int = 1024, tokenizer_path=None):
    """Train (or load) a word-level tokenizer on the corpus, group it into blocks and
    write ``<out_dir>/<name>_<split>.npz``. Returns (the npz's path, the tokenizer)."""
    from .wordlevel_tokenizer import WordLevelTokenizer, generate_word_level_tokenizer

    out_dir = os.path.expanduser(str(out_dir))
    os.makedirs(os.path.join(out_dir, "cache"), exist_ok=True)
    lines = list(lines)
    tok_file = tokenizer_path or os.path.join(out_dir, "cache", f"word-tokenizer_{vocab_size}.json")
    if os.path.exists(tok_file):
        tokenizer = WordLevelTokenizer.load(tok_file)
    else:
        tokenizer = generate_word_level_tokenizer(lines=lines, vocab_size=vocab_size, save_path=tok_file)
    path = os.path.join(out_dir, f"{name}_{split}.npz")
    np.savez(path, input_ids=tokenize_and_group(lines, tokenizer, seq_len))
    return path, tokenizer


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("corpus", nargs="+", help="raw text file(s), one doc per line")
    parser.add_argument("--out", default="~/data", help="output directory (= cfg.data.path)")
    parser.add_argument("--name", default="wikitext", help="dataset name (= cfg.data.name)")
    parser.add_argument("--split", default="training")
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--vocab", type=int, default=1024)
    args = parser.parse_args(argv)
    lines = []
    for fname in args.corpus:
        with open(os.path.expanduser(fname)) as fh:
            lines.extend(fh.readlines())
    path, tokenizer = prepare_text_npz(lines, args.out, args.name, split=args.split, seq_len=args.seq_len,
                                       vocab_size=args.vocab)
    with np.load(path) as blob:
        shape = list(blob["input_ids"].shape)
    print(f"Wrote {path}: input_ids{shape}, vocab {tokenizer.get_vocab_size()}.")


if __name__ == "__main__":
    main()
