"""Byte-level BPE, GPT-2 style (counterpart of
megatron_tpu/tokenizer/gpt2_bpe.py).

The standard algorithm, as in the JAX package: a reversible
byte<->unicode mapping, greedy lowest-rank pair merges, and GPT-2's
pre-tokenization. Files: vocab.json (token -> id) and merges.txt (one
merge per line).

The JAX package pre-tokenizes with the third-party `regex` module's
pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

which the standard library's `re` cannot express (no \\p{...} classes),
and the card's machine has no `regex`. pretokenize() below is a scanner
with that pattern's semantics (leftmost match, alternatives in order,
greedy runs, the lookahead's backtrack by one whitespace character),
classifying characters with unicodedata: letters are categories L*,
numbers N*, whitespace str.isspace() less U+001C..U+001F (which `regex`
does not count as \\s). It gives the same pieces as the pattern wherever
the two Unicode databases agree.
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@lru_cache(maxsize=65536)
def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch.isspace() and ch not in _NOT_SPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def pretokenize(text: str) -> List[str]:
    """GPT-2's pre-tokenization of `text` (see the module docstring)."""
    out: List[str] = []
    cls = [_char_class(c) for c in text]
    n = len(text)
    i = 0
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS
                        if text.startswith(c, i)), None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        k = cls[i]
        start = i
        if text[i] == " " and i + 1 < n and cls[i + 1] != "S":
            # ` ?\p{L}+`, ` ?\p{N}+`, ` ?[^\s\p{L}\p{N}]+`
            k = cls[i + 1]
            i += 1
        if k != "S":
            while i < n and cls[i] == k:
                i += 1
            out.append(text[start:i])
            continue
        j = i
        while j < n and cls[j] == "S":
            j += 1
        if j < n and j - i >= 2:
            # `\s+(?!\S)` backs off one character before a non-space
            j -= 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a printable unicode char (reversible)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


class GPT2BPE:
    def __init__(self, vocab_file: str, merges_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = _pairs(word)
        while pairs:
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in pretokenize(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")


def train_vocab(texts, num_merges: int,
                special: Tuple[str, ...] = ("<|endoftext|>",)
                ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A byte-level vocabulary learned from `texts`: the 256 byte
    symbols, up to `num_merges` merges (the most frequent adjacent pair
    over the pre-tokenized words, ties to the smallest pair), then the
    special tokens. Returns (vocab, merges) in the shapes vocab.json and
    merges.txt hold (write_vocab writes them), so a corpus can be
    tokenized without a downloaded vocabulary."""
    b2u = bytes_to_unicode()
    freq: Dict[Tuple[str, ...], int] = {}
    for text in texts:
        for piece in pretokenize(text):
            word = tuple(b2u[b] for b in piece.encode("utf-8"))
            freq[word] = freq.get(word, 0) + 1
    vocab = {b2u[b]: i for i, b in enumerate(range(256))}
    merges: List[Tuple[str, str]] = []
    words = [list(w) for w in freq]
    counts_of = list(freq.values())
    pairs: Dict[Tuple[str, str], int] = {}
    where: Dict[Tuple[str, str], set] = {}

    def tally(i, sign):
        w = words[i]
        for pair in zip(w[:-1], w[1:]):
            pairs[pair] = pairs.get(pair, 0) + sign * counts_of[i]
            if sign > 0:
                where.setdefault(pair, set()).add(i)

    for i in range(len(words)):
        tally(i, 1)
    for _ in range(num_merges):
        live = [p for p, n in pairs.items() if n > 0]
        if not live:
            break
        best = min(live, key=lambda p: (-pairs[p], p))
        merges.append(best)
        joined = best[0] + best[1]
        vocab.setdefault(joined, len(vocab))
        for i in sorted(where.pop(best, ())):
            w = words[i]
            tally(i, -1)
            out, k = [], 0
            while k < len(w):
                if k + 1 < len(w) and w[k] == best[0] and w[k + 1] == best[1]:
                    out.append(joined)
                    k += 2
                else:
                    out.append(w[k])
                    k += 1
            words[i] = out
            tally(i, 1)
    for tok in special:
        vocab.setdefault(tok, len(vocab))
    return vocab, merges


def write_vocab(vocab: Dict[str, int], merges: List[Tuple[str, str]],
                vocab_file: str, merges_file: str) -> None:
    with open(vocab_file, "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(merges_file, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n"
                + "".join(f"{a} {b}\n" for a, b in merges))
