"""The port's text data against the JAX package's, on the CPU: the synthetic corpus, its
masked-LM and classification labels and its user partition token for token, the npz
corpus, the TFF sqlite databases (both packages read what either writes, with the same
client partition), the word-level tokenizer (against the ``tokenizers`` library the JAX
package trains with, where it is installed), ``prepare_text_npz``, the fedSGD user's
exchange on token ids, and the users' printing. Token ids and vocabularies compare
exactly; the user's gradient within 1e-4 of each leaf's largest entry (float32, sums in
other orders).
"""

import os

import jax
import numpy as np
import pytest
import torch

import breaching_tpu as jax_breaching
from breaching_tpu.cases.data import datasets_text as jax_text
from breaching_tpu.cases.data import prepare_text_data as jax_prepare
from breaching_tpu.cases.data import tff_sqlite as jax_tff
import breaching_tpu_torch as breaching
from breaching_tpu_torch.cases.data import datasets_text, prepare_text_data, tff_sqlite
from breaching_tpu_torch.cases.data.wordlevel_tokenizer import WordLevelTokenizer, generate_word_level_tokenizer
from breaching_tpu_torch.cases.models.model_preparation import _flat_entries, load_flat_state

torch.set_num_threads(1)
CASE10 = ["case=10_causal_lang_training", "case.model=transformer1", "case.data.vocab_size=128",
          "case.data.shape=[12]", "seed=0"]


def _data_cfg(overrides):
    return breaching.get_config(overrides).case.data, jax_breaching.get_config(overrides).case.data


@pytest.mark.parametrize("overrides", [
    [],
    ["case.data.vocab_size=50257", "case.data.shape=[32]"],
    ["case=9_bert_training", "case.data.vocab_size=128", "case.data.shape=[12]"],
    ["case.data.task=classification", "case.data.classes=3"],
    ["case/data=random-tokens", "case.data.vocab_size=128", "case.data.shape=[12]"],
], ids=["causal", "gpt2-vocab", "masked", "classification", "random-tokens"])
def test_synthetic_corpus_and_labels_are_the_jax_packages(overrides):
    cfg, jax_cfg = _data_cfg(CASE10 + overrides)
    dataset = datasets_text.TextDataset(cfg, split="training")
    reference = jax_text.TextDataset(jax_cfg, split="training")
    assert len(dataset) == len(reference)
    for idx in (0, 1, 17, min(12_345, len(dataset) - 2), len(dataset) - 1):
        got, want = dataset[idx], reference[idx]
        assert set(got) == set(want) == {"input_ids", "labels"}
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["input_ids"].dtype == np.int64
    if "case=9_bert_training" in overrides:  # some positions masked, the rest ignored
        labels = np.stack([dataset[i]["labels"] for i in range(50)])
        assert 0 < (labels != -100).mean() < 0.5


def test_user_partition_and_dataloader_are_the_jax_packages():
    cfg, jax_cfg = _data_cfg(CASE10 + ["case.data.default_clients=100"])
    for user_idx in (0, 3, 99):
        got = breaching.cases.construct_dataloader(cfg, breaching.get_config(CASE10).case.impl, user_idx=user_idx)
        want = jax_breaching.cases.construct_dataloader(jax_cfg, jax_breaching.get_config(CASE10).case.impl,
                                                        user_idx=user_idx)
        for got_batch, want_batch in zip(got, want):
            np.testing.assert_array_equal(got_batch["input_ids"], want_batch["input_ids"])
            np.testing.assert_array_equal(got_batch["labels"], want_batch["labels"])
    with pytest.raises(ValueError, match="exceeds the 100 text users"):
        datasets_text.build_text_dataset(cfg, 100)


def test_npz_corpus_is_read_as_the_jax_package_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "cola_training.npz", input_ids=rng.integers(0, 128, (40, 16)),
             labels=rng.integers(0, 2, 40))
    overrides = CASE10 + ["case.data.name=cola", f"case.data.path={tmp_path}", "case.data.task=classification",
                          "case.data.classes=2", "case.data.default_clients=4"]
    cfg, jax_cfg = _data_cfg(overrides)
    for user_idx in (0, 3):
        got = datasets_text.build_text_dataset(cfg, user_idx)
        want = jax_text.build_text_dataset(jax_cfg, user_idx)
        assert len(got) == len(want) == 10
        for i in range(len(got)):
            for key in ("input_ids", "labels"):
                np.testing.assert_array_equal(got[i][key], want[i][key])


def _tff_rows():
    rng = np.random.default_rng(1)
    words = ["the", "cat", "sat", "on", "a", "mat", "déjà", "vu", "!", "?"]
    rows = []
    for client in ("c2", "c0", "c1"):
        for _ in range(3):
            text = " ".join(rng.choice(words, size=int(rng.integers(4, 12))))
            rows.append((client, "train", {"tokens": [text], "title": ["t"], "score": [int(rng.integers(-5, 5))],
                                           "weight": [float(rng.uniform())]}))
        rows.append((client, "test", {"tokens": ["held out text"]}))
    return rows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tff_sqlite_round_trip_and_client_partition(tmp_path, writer):
    path = str(tmp_path / "stackoverflow.sqlite")
    (tff_sqlite if writer == "port" else jax_tff).create_tff_database(path, _tff_rows())
    assert tff_sqlite.client_ids(path, "train") == jax_tff.client_ids(path, "train") == ["c2", "c0", "c1"]
    for idx in range(3):
        assert tff_sqlite.load_client_texts(path, idx, "train", "tokens") == \
            jax_tff.load_client_texts(path, idx, "train", "tokens")
    example = jax_tff.encode_tf_example({"tokens": ["a b"], "n": [3, -2], "f": [0.5]})
    assert tff_sqlite.encode_tf_example({"tokens": ["a b"], "n": [3, -2], "f": [0.5]}) == example
    assert tff_sqlite.parse_tf_example(example) == jax_tff.parse_tf_example(example)
    overrides = CASE10 + ["case.data.name=stackoverflow", f"case.data.path={tmp_path}",
                          "case.data.tokenizer=character", "case.data.shape=[8]"]
    cfg, jax_cfg = _data_cfg(overrides)
    for user_idx in (0, 2):
        got = datasets_text.build_text_dataset(cfg, user_idx)
        want = jax_text.build_text_dataset(jax_cfg, user_idx)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(np.stack([got[i]["input_ids"] for i in range(len(got))]),
                                      np.stack([want[i]["input_ids"] for i in range(len(want))]))
    full = datasets_text.build_text_dataset(cfg, None, return_full_dataset=True)
    assert len(full) == len(jax_text.build_text_dataset(jax_cfg, None, return_full_dataset=True))
    with pytest.raises(ValueError, match="larger than number of clients"):
        datasets_text.build_text_dataset(cfg, 3)


LINES = ["The cat sat on the mat.", "the dog, the cat -- and the bird!", "Zebra zebra ZEBRA 123 4.5",
         "naïve café déjà-vu", "  ", "tie1 tie2 tie3 tie1 tie2 tie3 b a", "emoji 🙂 🙂 ok?!"]


@pytest.mark.parametrize("vocab_size", [6, 12, 40])
def test_word_level_trainer_matches_the_tokenizers_library(vocab_size, tmp_path):
    pytest.importorskip("tokenizers")
    from breaching_tpu.cases.data.wordlevel_tokenizer import generate_word_level_tokenizer as jax_generate

    want = jax_generate(lines=LINES, vocab_size=vocab_size, save_path=str(tmp_path / "hf.json"))
    got = generate_word_level_tokenizer(lines=LINES, vocab_size=vocab_size, save_path=str(tmp_path / "port.json"))
    assert got.get_vocab() == want.get_vocab()
    for line in LINES + ["unseen words the cat", "ZEBRA!!"]:
        assert got.encode(line).ids == want.encode(line).ids
    assert WordLevelTokenizer.load(str(tmp_path / "port.json")).get_vocab() == want.get_vocab()


def test_word_level_trainer_default_corpus_matches_the_jax_package():
    pytest.importorskip("tokenizers")
    from breaching_tpu.cases.data.wordlevel_tokenizer import generate_word_level_tokenizer as jax_generate

    assert generate_word_level_tokenizer(vocab_size=50).get_vocab() == jax_generate(vocab_size=50).get_vocab()


def test_prepare_text_npz_writes_the_jax_packages_blocks(tmp_path):
    pytest.importorskip("tokenizers")
    corpus = LINES * 5
    path, tokenizer = prepare_text_data.prepare_text_npz(corpus, tmp_path / "port", "wikitext", seq_len=6,
                                                         vocab_size=20)
    jax_path, _ = jax_prepare.prepare_text_npz(corpus, tmp_path / "jax", "wikitext", seq_len=6, vocab_size=20)
    with np.load(path) as got, np.load(jax_path) as want:
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    # a second call reads the tokenizer it saved
    again, loaded = prepare_text_data.prepare_text_npz(corpus, tmp_path / "port", "wikitext", seq_len=6,
                                                       vocab_size=20)
    assert loaded.get_vocab() == tokenizer.get_vocab()
    with pytest.raises(ValueError, match="Corpus too small"):
        prepare_text_data.tokenize_and_group(["a b"], tokenizer, 6)


def test_tokenizers_the_port_refuses(tmp_path):
    """The tokenizers that need a download are refused; ``canine`` no longer is (its
    cases below), ``character`` and ``word-level`` are built."""
    cfg, _ = _data_cfg(CASE10 + [f"case.data.path={tmp_path}"])
    cfg.tokenizer = "canine"
    assert datasets_text.tokenizer_for(cfg).encode("Hi!").ids == [72, 105, 33]
    for name in ("GPT-2", "bert-base-uncased"):
        cfg.tokenizer = name
        with pytest.raises(ValueError, match="requires a network fetch"):
            datasets_text.tokenizer_for(cfg)
    cfg.tokenizer = "character"
    assert datasets_text.tokenizer_for(cfg).encode("Hi!").ids == [41, 74, 2]
    cfg.tokenizer, cfg.vocab_size = "word-level", 30
    tokenizer = datasets_text.tokenizer_for(cfg, LINES)
    assert os.path.isfile(tmp_path / "cache" / "word-tokenizer_30.json")
    assert datasets_text.tokenizer_for(cfg).get_vocab() == tokenizer.get_vocab()


CANINE_TEXTS = {"ascii": "Hello , world! it 's 42.", "accented": "Crème brûlée à l'œuvre, ñandú",
                "cjk": "東京で日本語を話す 한국어 中文", "emoji": "ok 🙂👍🏽 🇩🇪 x\u200dy"}


@pytest.mark.parametrize("text", sorted(CANINE_TEXTS))
def test_canine_tokenizer_matches_the_jax_packages(text, tmp_path):
    """The port's plain-Python canine tokenizer against the JAX package's, which is
    ``transformers``' ``CanineTokenizer`` with ``add_special_tokens=False``: ids, decode
    and the vocabulary size."""
    pytest.importorskip("transformers")
    cfg, j_cfg = _data_cfg(CASE10 + [f"case.data.path={tmp_path}"])
    cfg.tokenizer = j_cfg.tokenizer = "canine"
    ours, theirs = datasets_text.tokenizer_for(cfg), jax_text.tokenizer_for(j_cfg)
    ids = ours.encode(CANINE_TEXTS[text]).ids
    assert ids == list(theirs.encode(CANINE_TEXTS[text]).ids)
    assert ours.decode(ids) == theirs.decode(ids) == CANINE_TEXTS[text]
    assert ours.vocab_size == theirs.vocab_size == 1_114_112


def _flat(params):
    return {"params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("overrides", [[], ["case=9_bert_training", "case.model=bert-tiny"]], ids=["causal", "masked"])
def test_text_users_exchange_matches_jax(overrides):
    """The fedSGD user on token ids: int64 ids, ``data_key`` ``input_ids``, the shared
    labels sorted, and its gradient the JAX user's on the same weights."""
    cfg_overrides = CASE10 + overrides + ["case.user.num_data_points=2", "case.user.provide_labels=True"]
    cfg, jax_cfg = breaching.get_config(cfg_overrides), jax_breaching.get_config(cfg_overrides)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, server, model, _ = breaching.cases.construct_case(cfg.case, setup)
    jax_setup = jax_breaching.utils.system_startup(cfg=jax_cfg)
    j_user, j_server, j_model, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_setup)
    load_flat_state(model, _flat(j_model.params), strict=True)
    shared, _, true = server.run_protocol(user)
    j_shared, _, j_true = j_server.run_protocol(j_user)
    assert true["data"].dtype == torch.int64 and true["data"].shape == (2, 12)
    np.testing.assert_array_equal(true["data"].numpy(), np.asarray(j_true["data"]))
    np.testing.assert_array_equal(true["labels"].numpy(), np.asarray(j_true["labels"]))
    metadata, j_metadata = shared[0]["metadata"], j_shared[0]["metadata"]
    assert metadata["data_key"] == j_metadata["data_key"] == "input_ids"
    np.testing.assert_array_equal(metadata["labels"].numpy(), np.asarray(j_metadata["labels"]))
    want = _flat(j_shared[0]["gradients"])
    gradients = shared[0]["gradients"]
    names = {id(p): n for n, p in model.named_parameters()}
    for key, tensor, transform in _flat_entries(model):
        expected = transform(want["params/" + key[7:]]) if transform is not None else want["params/" + key[7:]]
        got = gradients[names[id(tensor)]].numpy()
        np.testing.assert_allclose(got, expected, rtol=0, atol=1e-4 * max(np.abs(expected).max(), 1e-30),
                                   err_msg=key)


def test_users_print_token_ids_as_the_jax_package_does(capsys):
    cfg, jax_cfg = breaching.get_config(CASE10), jax_breaching.get_config(CASE10)
    setup = breaching.utils.system_startup(cfg=cfg, device="cpu")
    user, _, _, _ = breaching.cases.construct_case(cfg.case, setup)
    j_user, _, _, _ = jax_breaching.cases.construct_case(jax_cfg.case, jax_breaching.utils.system_startup(cfg=jax_cfg))
    data = np.asarray([[5, 6, 7], [8, 9, 10]])
    truth = np.asarray([[5, 0, 7], [1, 9, 10]])
    confidence = np.asarray([[0.5, 1.0, 0.25], [0.1, 0.2, 0.3]], np.float32)
    tokenizer = datasets_text.CharTokenizer(128)
    outputs = []
    for who, d, t in ((user, torch.from_numpy(data), torch.from_numpy(truth)), (j_user, data, truth)):
        who.print(dict(data=d))
        who.print_with_confidence(dict(data=d, confidence=confidence))
        who.print_and_mark_correct(dict(data=d), dict(data=t))
        who.print(dict(data=d), tokenizer=tokenizer)
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "5✓ 6✗ 7✓" in outputs[0] and "5[0.50]" in outputs[0]
