"""Tokenizer dispatch (counterpart of megatron_tpu/tokenizer/tokenizer.py).

A copy of the JAX package's NullTokenizer and the null branch of
build_tokenizer; the other backends need tokenizer files and are not
ported yet.
"""

from __future__ import annotations

from typing import List, Optional


class NullTokenizer:
    """ints-in, ints-out; id `vocab_size` is EOD (for tests/benches)."""

    name = "null"

    def __init__(self, vocab_size: int):
        self._vs = int(vocab_size) + 1

    @property
    def vocab_size(self) -> int:
        return self._vs

    def tokenize(self, text: str) -> List[int]:
        return [int(t) for t in text.split()]

    def detokenize(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)

    @property
    def eod(self) -> int:
        return self._vs - 1

    @property
    def pad(self) -> int:
        return self._vs - 1

    @property
    def bos(self) -> Optional[int]:
        return None


def build_tokenizer(tokenizer_type: str, *,
                    vocab_size: Optional[int] = None) -> NullTokenizer:
    t = tokenizer_type.lower()
    if t in ("nulltokenizer", "null"):
        if vocab_size is None:
            raise ValueError("NullTokenizer needs vocab_size")
        return NullTokenizer(vocab_size)
    raise ValueError(
        f"tokenizer_type {tokenizer_type!r} is not ported; only 'null' is. "
        "The GPT-2 BPE (tokenizer/gpt2_bpe.py), SentencePiece and HF "
        "tokenizers wait in ROADMAP.md, queue A (the rest of the loop and "
        "the data)")
