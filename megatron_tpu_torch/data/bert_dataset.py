"""BERT pretraining dataset: sentence pairs + masked-LM creation (a copy
of megatron_tpu/data/bert_dataset.py: the same numpy draws, so an item is
the JAX package's item bit for bit).

The reference's megatron/data/bert_dataset.py +
dataset_utils.create_masked_lm_predictions: samples are
[CLS] A [SEP] B [SEP] with random-next B (NSP) or swapped halves, 15%
token masking (80% [MASK] / 10% random / 10% keep). The sample map comes
from the native helper build_mapping over sentence-level indexed data
(documents delimited by doc_idx).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from megatron_tpu_torch.data import helpers
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset


class BertDataset:
    def __init__(
        self,
        indexed: MMapIndexedDataset,   # sentence-level sequences + doc bounds
        num_samples: int,
        max_seq_length: int,
        mask_token: int,
        cls_token: int,
        sep_token: int,
        pad_token: int,
        vocab_size: int,
        seed: int = 1234,
        masked_lm_prob: float = 0.15,
        short_seq_prob: float = 0.1,
        binary_head: bool = True,
    ):
        self.indexed = indexed
        self.max_seq_length = max_seq_length
        self.mask_token, self.cls, self.sep, self.pad = (
            mask_token, cls_token, sep_token, pad_token)
        self.vocab_size = vocab_size
        self.seed = seed
        self.masked_lm_prob = masked_lm_prob
        self.binary_head = binary_head
        # sentence budget leaves room for [CLS] + 2x[SEP]
        self.mapping = helpers.build_mapping(
            indexed.doc_idx, indexed.sizes,
            num_epochs=_epochs_for(indexed, num_samples),
            max_num_samples=num_samples,
            max_seq_length=max_seq_length - 3,
            short_seq_prob=short_seq_prob, seed=seed, min_num_sent=2)

    def __len__(self) -> int:
        return self.mapping.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        start, end, target_len = (int(v) for v in self.mapping[idx])
        rng = np.random.RandomState((self.seed + idx) & 0x7FFFFFFF)
        sents = [np.asarray(self.indexed[i], np.int64)
                 for i in range(start, end)]

        # split sentences into A / B; NSP-style: half the time swap order
        # (sentence-order prediction, as the reference's binary head trains)
        split = rng.randint(1, len(sents)) if len(sents) > 1 else 1
        a = np.concatenate(sents[:split]) if split > 0 else sents[0]
        b = (np.concatenate(sents[split:]) if split < len(sents)
             else np.asarray([], np.int64))
        is_random = 0
        if self.binary_head and len(b) and rng.random() < 0.5:
            a, b = b, a
            is_random = 1

        budget = target_len
        while len(a) + len(b) > budget:
            longer = a if len(a) > len(b) else b
            # trim front or back at random (ref: truncate_segments)
            if rng.random() < 0.5:
                longer = longer[1:]
            else:
                longer = longer[:-1]
            if len(a) > len(b):
                a = longer
            else:
                b = longer

        tokens = np.concatenate([
            [self.cls], a, [self.sep],
            b, [self.sep] if len(b) else np.asarray([], np.int64),
        ]).astype(np.int64)
        tokentypes = np.concatenate([
            np.zeros(len(a) + 2, np.int64),
            np.ones(len(tokens) - len(a) - 2, np.int64),
        ])

        # masked-LM creation (ref: create_masked_lm_predictions)
        labels = np.full(self.max_seq_length, self.pad, np.int64)
        loss_mask = np.zeros(self.max_seq_length, np.float32)
        maskable = [i for i, t in enumerate(tokens)
                    if t not in (self.cls, self.sep)]
        rng.shuffle(maskable)
        n_mask = max(1, int(round(len(maskable) * self.masked_lm_prob)))
        out_tokens = tokens.copy()
        for i in maskable[:n_mask]:
            labels[i] = tokens[i]
            loss_mask[i] = 1.0
            r = rng.random()
            if r < 0.8:
                out_tokens[i] = self.mask_token
            elif r < 0.9:
                out_tokens[i] = rng.randint(0, self.vocab_size)
            # else keep original

        padded = np.full(self.max_seq_length, self.pad, np.int64)
        padded[:len(out_tokens)] = out_tokens
        tt = np.zeros(self.max_seq_length, np.int64)
        tt[:len(tokentypes)] = tokentypes
        pad_mask = np.zeros(self.max_seq_length, np.float32)
        pad_mask[:len(out_tokens)] = 1.0

        return {
            "tokens": padded,
            "tokentype_ids": tt,
            "labels": labels,
            "loss_mask": loss_mask,
            "padding_mask": pad_mask,
            "is_random": np.int64(is_random),
        }


def _epochs_for(indexed: MMapIndexedDataset, num_samples: int) -> int:
    n_docs = max(len(indexed.doc_idx) - 1, 1)
    # ~1 sample per doc per epoch is conservative; build_mapping stops at
    # max_num_samples anyway
    return max(1, int(np.ceil(num_samples / n_docs)) + 1)
