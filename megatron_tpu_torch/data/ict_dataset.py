"""Inverse-Cloze-Task dataset for biencoder/REALM pretraining (a copy of
megatron_tpu/data/ict_dataset.py: the same draws, so an item is the JAX
package's item bit for bit).

The reference's megatron/data/ict_dataset.py: blocks of consecutive
sentences come from the native build_blocks_mapping helper
(csrc/data_helpers.cpp); each sample
picks a random sentence of the block as the pseudo-query and uses the
block — with the query sentence REMOVED except query_in_block_prob of the
time (ict_dataset.py:95-100) — as the context, optionally prefixed with
the document title. Query = [CLS] q [SEP]; context = [CLS] title [SEP]
block [SEP] (concat_and_pad_tokens:145-158).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from megatron_tpu_torch.data import helpers
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset


class ICTDataset:
    def __init__(
        self,
        block_dataset: MMapIndexedDataset,   # sentence-level + doc bounds
        title_dataset: Optional[MMapIndexedDataset],
        num_samples: Optional[int],   # None = exactly one epoch of blocks
        max_seq_length: int,
        cls_token: int,
        sep_token: int,
        pad_token: int,
        seed: int = 1234,
        query_in_block_prob: float = 0.1,
        use_titles: bool = True,
        use_one_sent_docs: bool = False,
    ):
        self.block = block_dataset
        self.titles = title_dataset if use_titles else None
        self.max_seq_length = max_seq_length
        self.cls, self.sep, self.pad = cls_token, sep_token, pad_token
        self.seed = seed
        self.query_in_block_prob = query_in_block_prob
        title_sizes = (title_dataset.sizes if self.titles is not None
                       else np.zeros(len(block_dataset.doc_idx) - 1, np.int32))
        n_docs = max(len(block_dataset.doc_idx) - 1, 1)
        if num_samples is None:
            # one epoch: each block appears exactly once (indexer pass)
            num_epochs, max_num = 1, 2**62
        else:
            num_epochs = max(1, int(np.ceil(num_samples / n_docs)) + 1)
            max_num = num_samples
        self.mapping = helpers.build_blocks_mapping(
            block_dataset.doc_idx, block_dataset.sizes, title_sizes,
            num_epochs=num_epochs,
            max_num_samples=max_num,
            max_seq_length=max_seq_length - 3, seed=seed,
            use_one_sent_blocks=use_one_sent_docs)

    def __len__(self) -> int:
        return self.mapping.shape[0]

    def _pad(self, tokens, title=None) -> "tuple[np.ndarray, np.ndarray]":
        toks = [self.cls]
        if title is not None:
            toks += list(title) + [self.sep]
        toks += list(tokens) + [self.sep]
        toks = toks[: self.max_seq_length]
        out = np.full(self.max_seq_length, self.pad, np.int64)
        out[: len(toks)] = toks
        mask = np.zeros(self.max_seq_length, np.float32)
        mask[: len(toks)] = 1.0
        return out, mask

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        start, end, doc, block_idx = (int(v) for v in self.mapping[idx])
        rng = random.Random((self.seed + idx) & 0x7FFFFFFF)
        sents = [np.asarray(self.block[i], np.int64)
                 for i in range(start, end)]
        rand_sent = rng.randint(0, len(sents) - 1)
        if rng.random() < self.query_in_block_prob:
            query = sents[rand_sent]
        else:
            query = sents.pop(rand_sent) if len(sents) > 1 else sents[rand_sent]

        title = (np.asarray(self.titles[doc], np.int64)
                 if self.titles is not None else None)
        title_off = 3 + (len(title) if title is not None else -1)
        query = query[: self.max_seq_length - 2]
        block = (np.concatenate(sents) if sents else np.asarray([], np.int64))
        block = block[: self.max_seq_length - title_off]

        q_toks, q_mask = self._pad(query)
        c_toks, c_mask = self._pad(block, title)
        return {
            "query_tokens": q_toks,
            "query_pad_mask": q_mask,
            "context_tokens": c_toks,
            "context_pad_mask": c_mask,
            "block_data": np.asarray([start, end, doc, block_idx], np.int64),
        }
