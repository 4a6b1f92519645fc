"""Tokenizer dispatch and vocab padding (counterpart of
megatron_tpu/tokenizer/tokenizer.py, a copy with its imports rewritten).

Backends:

  * SentencePieceTokenizer: llama-family .model files, loaded through HF
    transformers' LlamaTokenizerFast, special-token aware.
  * HFTokenizer: any HF repo or directory through AutoTokenizer.
  * GPT2BPETokenizer: the port's own byte-level BPE (gpt2_bpe.py).
  * NullTokenizer: identity int tokenizer for tests and benchmarks
    (vocab_size given; "tokens" are space-separated ints).

`transformers` is imported inside the two HF classes only, so the GPT-2
BPE and null tokenizers run where it is not installed.
"""

from __future__ import annotations

import abc
from typing import List, Optional


def pad_vocab_size(orig_vocab_size: int, make_vocab_size_divisible_by: int = 128,
                   tensor_parallel: int = 1) -> int:
    """Pad so the vocab divides evenly across TP shards
    (ref: _vocab_size_with_padding)."""
    mult = make_vocab_size_divisible_by * tensor_parallel
    return mult * ((orig_vocab_size + mult - 1) // mult)


class AbstractTokenizer(abc.ABC):
    name: str = "abstract"

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @abc.abstractmethod
    def tokenize(self, text: str) -> List[int]: ...

    def detokenize(self, ids) -> str:
        raise NotImplementedError

    @property
    def eod(self) -> int:
        raise NotImplementedError

    @property
    def pad(self) -> int:
        raise NotImplementedError

    @property
    def bos(self) -> Optional[int]:
        return None


class _HFBase(AbstractTokenizer):
    def __init__(self, hf_tokenizer):
        self._t = hf_tokenizer

    @property
    def vocab_size(self) -> int:
        return len(self._t)

    def tokenize(self, text: str) -> List[int]:
        return self._t.encode(text, add_special_tokens=False)

    def detokenize(self, ids) -> str:
        return self._t.decode(list(map(int, ids)), skip_special_tokens=False)

    @property
    def eod(self) -> int:
        t = self._t
        if t.eos_token_id is not None:
            return t.eos_token_id
        raise ValueError("tokenizer has no eos token")

    @property
    def bos(self) -> Optional[int]:
        return self._t.bos_token_id

    @property
    def pad(self) -> int:
        t = self._t
        return t.pad_token_id if t.pad_token_id is not None else self.eod


class SentencePieceTokenizer(_HFBase):
    """Llama-family sentencepiece model (ref: _SentencePieceTokenizer,
    incl. --vocab_extra_ids / new-token handling via HF's additional
    special tokens)."""

    name = "sentencepiece"

    def __init__(self, model_file: str, vocab_extra_ids: int = 0,
                 new_tokens: bool = True):
        from transformers import LlamaTokenizerFast

        t = LlamaTokenizerFast(vocab_file=model_file, legacy=False)
        if vocab_extra_ids and new_tokens:
            t.add_special_tokens({"additional_special_tokens": [
                f"<extra_id_{i}>" for i in range(vocab_extra_ids)]})
        super().__init__(t)


class HFTokenizer(_HFBase):
    """AutoTokenizer wrapper (ref: _FalconTokenizer)."""

    name = "hf"

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        super().__init__(AutoTokenizer.from_pretrained(name_or_path))


class GPT2BPETokenizer(AbstractTokenizer):
    name = "gpt2"

    def __init__(self, vocab_file: str, merges_file: str):
        from megatron_tpu_torch.tokenizer.gpt2_bpe import GPT2BPE

        self._t = GPT2BPE(vocab_file, merges_file)
        self._eod = self._t.encoder.get("<|endoftext|>")

    @property
    def vocab_size(self) -> int:
        return len(self._t.encoder)

    def tokenize(self, text: str) -> List[int]:
        return self._t.encode(text)

    def detokenize(self, ids) -> str:
        return self._t.decode(ids)

    @property
    def eod(self) -> int:
        return self._eod

    @property
    def pad(self) -> int:
        return self._eod


class NullTokenizer(AbstractTokenizer):
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


def build_tokenizer(
    tokenizer_type: str,
    *,
    vocab_file: Optional[str] = None,
    merges_file: Optional[str] = None,
    tokenizer_model: Optional[str] = None,
    name_or_path: Optional[str] = None,
    vocab_size: Optional[int] = None,
    vocab_extra_ids: int = 0,
    new_tokens: bool = True,
) -> AbstractTokenizer:
    """Dispatch by type name (ref: build_tokenizer, tokenizer.py:12-44).
    Reference type names are accepted as aliases."""
    t = tokenizer_type.lower()
    if t in ("sentencepiecetokenizer", "sentencepiece"):
        return SentencePieceTokenizer(tokenizer_model or vocab_file,
                                      vocab_extra_ids, new_tokens)
    if t in ("falcontokenizer", "hftokenizer", "hf", "autotokenizer"):
        return HFTokenizer(name_or_path or vocab_file or "tiiuae/falcon-7b")
    if t in ("gpt2bpetokenizer", "gpt2"):
        if not (vocab_file and merges_file):
            raise ValueError("GPT2 BPE needs vocab_file and merges_file")
        return GPT2BPETokenizer(vocab_file, merges_file)
    if t in ("nulltokenizer", "null"):
        if vocab_size is None:
            raise ValueError("NullTokenizer needs vocab_size")
        return NullTokenizer(vocab_size)
    raise ValueError(f"unknown tokenizer_type {tokenizer_type!r}")
