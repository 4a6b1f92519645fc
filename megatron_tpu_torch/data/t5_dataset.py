"""T5 span-corruption pretraining dataset (a copy of
megatron_tpu/data/t5_dataset.py: the same numpy draws, so an item is the
JAX package's item bit for bit).

The reference's megatron/data/t5_dataset.py: samples are built from
sentence-level indexed data via the native build_mapping helper, then
span-corrupted T5-style — geometric span lengths (max 10, the reference's
create_masked_lm_predictions(max_ngrams=10, geometric_dist=True,
masking_style="t5"), dataset_utils.py:187), ~masked_lm_prob of tokens
masked, each span replaced by one sentinel token on the encoder side and
expanded as [sentinel, span...] on the decoder side, with BOS prepended to
the decoder input and EOS appended to the target
(t5_dataset.py pad_and_convert_to_numpy:147-216).

Batch layout matches models/t5.t5_loss: enc_tokens,
enc_padding_mask, dec_tokens, labels, loss_mask (the reference's 2-D
enc/dec/enc-dec attention-mask tensors collapse to 1-D padding masks —
causality is the model's job, not the dataset's, on this stack).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from megatron_tpu_torch.data import helpers
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset


def t5_span_corrupt(
    tokens: np.ndarray,
    rng: np.random.RandomState,
    masked_lm_prob: float,
    sentinel_tokens: Sequence[int],
    max_ngrams: int = 10,
) -> tuple:
    """Pick non-overlapping spans (geometric lengths) covering ~prob of the
    tokens. Returns (enc_tokens, dec_spans) where dec_spans is a list of
    (sentinel, span_tokens) in order."""
    n = len(tokens)
    budget = min(max(1, int(round(n * masked_lm_prob))), max(n - 1, 1))
    pvals = 0.2 * 0.8 ** np.arange(max_ngrams)
    pvals /= pvals.sum()
    starts = np.arange(n)
    rng.shuffle(starts)
    covered = np.zeros(n + 1, bool)  # +1 sentinel slot for adjacency check
    spans = []
    masked = 0
    for s in starts:
        if masked >= budget or len(spans) >= len(sentinel_tokens):
            break
        ln = int(rng.choice(np.arange(1, max_ngrams + 1), p=pvals))
        ln = min(ln, budget - masked)
        e = min(s + ln, n)
        if e <= s:
            continue
        # keep spans non-adjacent so each sentinel marks a distinct gap
        if covered[max(0, s - 1):min(n + 1, e + 1)].any():
            continue
        covered[s:e] = True
        spans.append((int(s), int(e)))
        masked += e - s
    spans.sort()

    enc = []
    dec_spans = []
    prev = 0
    for i, (s, e) in enumerate(spans):
        sent = int(sentinel_tokens[i])
        enc.extend(tokens[prev:s].tolist())
        enc.append(sent)
        dec_spans.append((sent, tokens[s:e].tolist()))
        prev = e
    enc.extend(tokens[prev:].tolist())
    return np.asarray(enc, np.int64), dec_spans


class T5Dataset:
    def __init__(
        self,
        indexed: MMapIndexedDataset,   # sentence-level sequences + doc bounds
        num_samples: int,
        max_seq_length: int,
        max_seq_length_dec: int,
        bos_token: int,
        eos_token: int,
        pad_token: int,
        sentinel_tokens: Sequence[int],
        seed: int = 1234,
        masked_lm_prob: float = 0.15,
        short_seq_prob: float = 0.1,
    ):
        if not len(sentinel_tokens):
            raise ValueError(
                "T5 span corruption needs sentinel tokens (the reference's "
                "--vocab_extra_ids 100, tokenizer additional special ids)")
        self.indexed = indexed
        self.max_seq_length = max_seq_length
        self.max_seq_length_dec = max_seq_length_dec
        self.bos, self.eos, self.pad = bos_token, eos_token, pad_token
        self.sentinels = list(sentinel_tokens)
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.mapping = helpers.build_mapping(
            indexed.doc_idx, indexed.sizes,
            num_epochs=_epochs_for(indexed, num_samples),
            max_num_samples=num_samples,
            max_seq_length=max_seq_length - 2,  # room for added tokens
            short_seq_prob=short_seq_prob, seed=seed, min_num_sent=1)

    def __len__(self) -> int:
        return self.mapping.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        start, end, target_len = (int(v) for v in self.mapping[idx])
        rng = np.random.RandomState((self.seed + idx) & 0x7FFFFFFF)
        tokens = np.concatenate([
            np.asarray(self.indexed[i], np.int64) for i in range(start, end)])
        tokens = tokens[:target_len]

        enc, dec_spans = t5_span_corrupt(
            tokens, rng, self.masked_lm_prob, self.sentinels)

        dec_in = [self.bos]
        dec_out = []
        for sent, span in dec_spans:
            dec_in.append(sent)
            dec_in.extend(span)
            dec_out.append(sent)
            dec_out.extend(span)
        dec_out.append(self.eos)
        # truncate decoder to budget (keeps in/out aligned: out is in
        # shifted left one with eos appended)
        dec_in = dec_in[: self.max_seq_length_dec]
        dec_out = dec_out[: self.max_seq_length_dec]

        enc_tokens = np.full(self.max_seq_length, self.pad, np.int64)
        enc_tokens[: len(enc)] = enc[: self.max_seq_length]
        enc_mask = np.zeros(self.max_seq_length, np.float32)
        enc_mask[: len(enc)] = 1.0

        dec_tokens = np.full(self.max_seq_length_dec, self.pad, np.int64)
        dec_tokens[: len(dec_in)] = dec_in
        labels = np.full(self.max_seq_length_dec, self.pad, np.int64)
        labels[: len(dec_out)] = dec_out
        loss_mask = np.zeros(self.max_seq_length_dec, np.float32)
        loss_mask[: len(dec_out)] = 1.0

        return {
            "enc_tokens": enc_tokens,
            "enc_padding_mask": enc_mask,
            "dec_tokens": dec_tokens,
            "labels": labels,
            "loss_mask": loss_mask,
            "truncated": np.int64(len(tokens) > target_len),
        }


def _epochs_for(indexed: MMapIndexedDataset, num_samples: int) -> int:
    n_docs = max(len(indexed.doc_idx) - 1, 1)
    return max(1, int(np.ceil(num_samples / n_docs)) + 1)
