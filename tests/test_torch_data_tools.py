"""The port's data path vs the JAX package, on the CPU.

Tokenizers: the GPT-2 byte-level BPE gives the JAX tokenizer's ids on
the hand-built fixture of tests/test_data.py and on a vocabulary learned
in the test from text with accents, CJK, digits, contractions and odd
whitespace (its pre-tokenizer is a scanner where the JAX one uses the
`regex` module: their pieces must agree); HFTokenizer gives the same ids
as the JAX one on a tokenizer built in code with `tokenizers` and saved
to tmp_path (nothing is downloaded); build_tokenizer takes the JAX
aliases. SentencePiece is untested here: the `sentencepiece` package is
on neither machine.

Tools: preprocess_data (GPT-2 BPE with 2 workers, and null with the
multi-key layout) and merge_datasets write .bin/.idx byte-identical to
the JAX tools'. Index builders: the port's native module (its own copy of
the C++ source, built into megatron_tpu_torch/build/) equals the JAX
package's native module on all four builders, and its Python versions.
"""

import _torch_threads  # noqa: F401  (first: one torch thread)

import json
import os

import numpy as np
import pytest

from megatron_tpu.data import helpers as jhelpers
from megatron_tpu.tokenizer import gpt2_bpe as jbpe
from megatron_tpu.tokenizer import tokenizer as jtok
from megatron_tpu_torch.data import helpers as thelpers
from megatron_tpu_torch.tokenizer import gpt2_bpe as tbpe
from megatron_tpu_torch.tokenizer import tokenizer as ttok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "Hello world!  It's 2024, a naïve café — 東京 ½ x² \n\n tab\tend  ",
    "they'll've it's 're \x1cfoo\x1f   nbsp here don't",
    "a\n\nb  c   \n  ",
    "  ",
    "Numbers 123 456.789 and CamelCase_words, (parens) [brackets]?!",
    "Ünïcödé ÀÉÎÕÜ ß ğ İ ı 한국어 العربية עברית हिन्दी 😀👍 ~~~",
]


def _write_bpe(tmp_path, texts, merges=80):
    vocab, m = tbpe.train_vocab(texts, merges)
    vf, mf = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    tbpe.write_vocab(vocab, m, vf, mf)
    return vf, mf


def test_gpt2_bpe_hand_built_fixture_matches_jax(tmp_path):
    """tests/test_data.py's fixture: "hello world!" over a 9-symbol vocab
    with three merges."""
    b2u = jbpe.bytes_to_unicode()
    assert tbpe.bytes_to_unicode() == b2u
    chars = sorted({b2u[b] for b in "hello world!".encode()})
    vocab = {c: i for i, c in enumerate(chars)}
    vocab["he"] = len(vocab)
    vocab["llo"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh e\nl l\nll o")
    args = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    t, j = tbpe.GPT2BPE(*args), jbpe.GPT2BPE(*args)
    for text in ("hello world!", "hello", "world hello  hello!!"):
        assert t.encode(text) == j.encode(text)
        assert t.decode(t.encode(text)) == text
    assert len(t.encode("hello")) == 2


def test_pretokenizer_matches_the_regex_pattern():
    import regex

    pattern = regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
        r"""|\s+(?!\S)|\s+""")
    rng = np.random.default_rng(0)
    alphabet = list("ab Z9'\n\t.,-_ é東²½ \x1c") + ["'s", "'ll", "  "]
    texts = TEXTS + ["".join(rng.choice(alphabet, size=40))
                     for _ in range(200)]
    for text in texts:
        assert tbpe.pretokenize(text) == pattern.findall(text), repr(text)


def test_gpt2_bpe_learned_vocab_matches_jax(tmp_path):
    vf, mf = _write_bpe(tmp_path, TEXTS * 3)
    t = ttok.build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                             merges_file=mf)
    j = jtok.build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                             merges_file=mf)
    assert t.vocab_size == j.vocab_size and t.eod == j.eod == t.pad
    for text in TEXTS:
        ids = t.tokenize(text)
        assert ids == j.tokenize(text)
        assert t.detokenize(ids) == j.detokenize(ids) == text
    with pytest.raises(ValueError, match="vocab_file and merges_file"):
        ttok.build_tokenizer("gpt2", vocab_file=vf)


def test_build_tokenizer_aliases_and_padding():
    for name in ("null", "NullTokenizer"):
        t = ttok.build_tokenizer(name, vocab_size=100)
        assert isinstance(t, ttok.NullTokenizer)
        assert t.tokenize("5 10 99") == [5, 10, 99] and t.eod == 100
    with pytest.raises(ValueError, match="unknown tokenizer_type"):
        ttok.build_tokenizer("wordpiece")
    for args in ((32000, 128, 1), (32001, 128, 1), (50257, 128, 8),
                 (50257, 128, 1)):
        assert ttok.pad_vocab_size(*args) == jtok.pad_vocab_size(*args)


def test_hf_tokenizer_matches_jax(tmp_path):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(TEXTS * 5, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<unk>", "<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        unk_token="<unk>").save_pretrained(str(tmp_path))
    for name in ("HFTokenizer", "hf", "AutoTokenizer"):
        t = ttok.build_tokenizer(name, name_or_path=str(tmp_path))
        j = jtok.build_tokenizer(name, name_or_path=str(tmp_path))
        assert (t.vocab_size, t.eod, t.bos, t.pad) == \
            (j.vocab_size, j.eod, j.bos, j.pad)
        for text in TEXTS:
            assert t.tokenize(text) == j.tokenize(text)
            assert t.detokenize(t.tokenize(text)) == \
                j.detokenize(j.tokenize(text))


def _jsonl(path, rng, n=60, keys=("text",)):
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(n):
            doc = {}
            for k in keys:
                ids = rng.integers(0, 90, int(rng.integers(3, 30)))
                words = [TEXTS[int(rng.integers(len(TEXTS)))][:20],
                         " ".join(str(int(x)) for x in ids)]
                doc[k] = " ".join(words) if k == "text" else words[1]
            f.write(json.dumps(doc) + "\n")


def _run_tool(args):
    """Run one tool's main() in this process: the port's by module name,
    the JAX package's (tools/*.py) from its file."""
    import importlib
    import importlib.util

    if args[0] == "-m":
        mod = importlib.import_module(args[1])
        return mod.main(args[2:])
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + os.path.basename(args[0])[:-3],
        os.path.join(REPO, args[0]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(args[1:])


def _same_bytes(a, b):
    for ext in (".bin", ".idx"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


def test_preprocess_and_merge_are_byte_identical_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    src = str(tmp_path / "docs.jsonl")
    _jsonl(src, rng)
    vf, mf = _write_bpe(tmp_path, TEXTS * 3)
    common = ["--input", src, "--tokenizer_type", "GPT2BPETokenizer",
              "--vocab_file", vf, "--merges_file", mf, "--append_eod"]
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    _run_tool(["-m", "megatron_tpu_torch.tools.preprocess_data", *common,
               "--output_prefix", t_out, "--workers", "2"])
    _run_tool(["tools/preprocess_data.py", *common, "--output_prefix", j_out])
    _same_bytes(t_out, j_out)

    multi = str(tmp_path / "multi.jsonl")
    _jsonl(multi, rng, n=40, keys=("text", "ids"))
    common = ["--input", multi, "--tokenizer_type", "null",
              "--vocab_size", "97", "--json_keys", "ids"]
    _run_tool(["-m", "megatron_tpu_torch.tools.preprocess_data", *common,
               "--output_prefix", t_out + "n"])
    _run_tool(["tools/preprocess_data.py", *common,
               "--output_prefix", j_out + "n"])
    _same_bytes(t_out + "n", j_out + "n")

    _run_tool(["-m", "megatron_tpu_torch.tools.merge_datasets", "--input",
               t_out, t_out + "n", "--output", t_out + "m"])
    _run_tool(["tools/merge_datasets.py", "--input", j_out, j_out + "n",
               "--output", j_out + "m"])
    _same_bytes(t_out + "m", j_out + "m")


def test_native_builders_match_jax_native_and_python():
    assert thelpers.native_helpers() is not None
    assert jhelpers.native_helpers() is not None
    out = thelpers.library_path()
    assert out.parent.name == "build" and out.parent.parent.name == \
        "megatron_tpu_torch" and out.exists()
    rng = np.random.default_rng(2)
    sizes = rng.integers(3, 120, 300).astype(np.int32)
    doc_idx = np.concatenate([rng.permutation(300) for _ in range(3)])
    tokens = int(sizes.sum())
    before = dict(thelpers.calls)
    got = thelpers.build_sample_idx(sizes, doc_idx, 64, 3, tokens)
    np.testing.assert_array_equal(
        got, jhelpers.build_sample_idx(sizes, doc_idx, 64, 3, tokens))
    np.testing.assert_array_equal(
        got, thelpers.build_sample_idx(sizes, doc_idx, 64, 3, tokens,
                                       native=False))
    assert thelpers.calls["build_sample_idx", "native"] == \
        before.get(("build_sample_idx", "native"), 0) + 1

    weights = np.array([0.5, 0.3, 0.2])
    for native in (True, False):
        ti, ts = thelpers.build_blending_indices(weights, 1000,
                                                 native=native)
        ji, js = jhelpers.build_blending_indices(weights, 1000)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)

    n_docs = 40
    sents = rng.integers(1, 8, n_docs)
    docs = np.concatenate([[0], np.cumsum(sents)]).astype(np.int64)
    sent_sizes = rng.integers(4, 60, int(docs[-1])).astype(np.int32)
    args = (docs, sent_sizes, 2, 500, 128, 0.1, 7)
    np.testing.assert_array_equal(thelpers.build_mapping(*args),
                                  jhelpers.build_mapping(*args))
    titles = rng.integers(1, 10, n_docs).astype(np.int32)
    for one_sent in (False, True):
        args = (docs, sent_sizes, titles, 2, 300, 96, 11)
        np.testing.assert_array_equal(
            thelpers.build_blocks_mapping(*args,
                                          use_one_sent_blocks=one_sent),
            jhelpers.build_blocks_mapping(*args,
                                          use_one_sent_blocks=one_sent))


# code points that `regex`'s tables assign and Python 3.12's Unicode 15.0
# leaves unassigned (U+A7CB, U+A7CC, U+A7DA: Latin letters; U+1E5D0..:
# Ol Onal letters, U+1E5F1: an Ol Onal digit)
NEWER_CODE_POINTS = "ꟋꟌꟚ\U0001E5D0\U0001E5D1\U0001E5F1"


def test_pretokenize_takes_the_jax_pattern_on_newer_code_points(tmp_path):
    """' Ɤa' (U+A7CB) is one piece under the JAX package's `regex`
    pattern; the port's GPT-2 tokenizer pre-tokenizes with that pattern
    and so gives the JAX ids, on it and on other newly assigned code
    points."""
    import unicodedata

    assert all(unicodedata.category(c) == "Cn" for c in NEWER_CODE_POINTS)
    assert tbpe.pretokenize(" Ɤa") == [" Ɤa"]
    assert tbpe._scan_pretokenize(" Ɤa") != [" Ɤa"]
    texts = [" Ɤa", "x" + NEWER_CODE_POINTS + " 1\U0001E5F1 z"] + [
        f"a {c}b {c}1 ,{c}" for c in NEWER_CODE_POINTS]
    vf, mf = _write_bpe(tmp_path, TEXTS + texts)
    t = ttok.build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                             merges_file=mf)
    j = jtok.build_tokenizer("GPT2BPETokenizer", vocab_file=vf,
                             merges_file=mf)
    for text in texts:
        assert tbpe.pretokenize(text) == jbpe._PRETOKENIZE.findall(text)
        assert t.tokenize(text) == j.tokenize(text), repr(text)


def test_scanner_fallback_matches_the_pattern_on_assigned_text():
    """Without `regex` the scanner stands in: on text whose code points
    Python's Unicode database assigns, it gives the pattern's pieces."""
    import unicodedata

    rng = np.random.default_rng(1)
    alphabet = list("ab Z9'\n\t.,-_ é東²½ \x1cß한😀  ")
    texts = TEXTS + ["".join(rng.choice(alphabet, size=48))
                     for _ in range(300)]
    for text in texts:
        assert all(unicodedata.category(c) != "Cn" for c in text)
        assert (tbpe._scan_pretokenize(text)
                == jbpe._PRETOKENIZE.findall(text)), repr(text)
