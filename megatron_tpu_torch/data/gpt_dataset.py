"""GPT pretraining dataset: document packing into fixed-length samples.

(A copy of megatron_tpu/data/gpt_dataset.py with its imports rewritten.)

Re-implementation of megatron/data/gpt_dataset.py (513 LoC): documents are
packed across epoch boundaries into seq_length+1-token samples through three
memoized numpy index maps —

  doc_idx    : documents repeated num_epochs times, shuffled
  sample_idx : (doc position, token offset) where each sample starts,
               built by the native helper (helpers build_sample_idx)
  shuffle_idx: sample-order permutation, with the reference's
               separate-last-epoch handling (gpt_dataset.py:306-341) so a
               partially-consumed final epoch is shuffled independently

Maps are cached as .npy keyed by (prefix, num docs, epochs, seed, seqlen) and
memoized on disk exactly like the reference; unlike the reference there is
no rank-0-builds + double-allreduce barrier (gpt_dataset.py:378-386) — in a
multi-host launch each host builds or mmap-loads the same deterministic
files.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from megatron_tpu_torch.data import helpers
from megatron_tpu_torch.data.indexed_dataset import MMapIndexedDataset, make_dataset


def get_train_valid_test_split_(splits_string: str, size: int):
    """'969,30,1' or '98,2,0' -> three [start, end) index bounds
    (ref: dataset_utils.get_train_valid_test_split_)."""
    splits = [float(s) for s in splits_string.replace("/", ",").split(",")]
    while len(splits) < 3:
        splits.append(0.0)
    splits = splits[:3]
    total = sum(splits)
    if total <= 0:
        raise ValueError(f"bad splits {splits_string!r}")
    fracs = [s / total for s in splits]
    idx = [0]
    for f in fracs:
        idx.append(idx[-1] + int(round(f * size)))
    idx[-1] = size
    return [(idx[i], idx[i + 1]) for i in range(3)]


def _num_epochs(tokens_per_epoch: int, seq_length: int, num_samples: int) -> int:
    epochs, tokens = 0, 0
    while True:
        epochs += 1
        tokens += tokens_per_epoch
        if (tokens - 1) // seq_length >= num_samples:
            return epochs


def _build_doc_idx(documents: np.ndarray, num_epochs: int,
                   rng: np.random.RandomState, separate_last_epoch: bool) -> np.ndarray:
    if separate_last_epoch:
        head = _build_doc_idx(documents, num_epochs - 1, rng, False)
        tail = _build_doc_idx(documents, 1, rng, False)
        return np.concatenate([head, tail])
    doc_idx = np.tile(documents, num_epochs).astype(np.int32)
    rng.shuffle(doc_idx)
    return doc_idx


def _build_shuffle_idx(num_samples: int, total_size: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Permute [0, num_samples) and [num_samples, total_size) separately
    (ref: _build_shuffle_idx)."""
    dtype = np.int64 if total_size >= (np.iinfo(np.uint32).max - 1) else np.uint32
    head = np.arange(num_samples, dtype=dtype)
    rng.shuffle(head)
    if num_samples == total_size:
        return head
    tail = np.arange(num_samples, total_size, dtype=dtype)
    rng.shuffle(tail)
    return np.concatenate([head, tail])


class GPTDataset:
    def __init__(
        self,
        name: str,
        indexed: MMapIndexedDataset,
        documents: np.ndarray,
        num_samples: int,
        seq_length: int,
        seed: int,
        cache_dir: Optional[str] = None,
    ):
        self.name = name
        self.indexed = indexed
        self.seq_length = seq_length
        if documents.size == 0:
            raise ValueError(f"dataset split {name!r} has no documents")
        self.doc_idx, self.sample_idx, self.shuffle_idx = self._build_index_maps(
            documents, num_samples, seed, cache_dir)

    def _build_index_maps(self, documents, num_samples, seed, cache_dir):
        sizes = self.indexed.sizes
        tokens_per_epoch = int(np.sum(sizes[documents]))
        num_epochs = _num_epochs(tokens_per_epoch, self.seq_length, num_samples)

        if num_epochs == 1:
            separate_last_epoch = False
        else:
            # ref heuristic (gpt_dataset.py:306-328): shuffle the last epoch
            # separately unless ~all of it is consumed
            samples_wo_last = ((num_epochs - 1) * tokens_per_epoch - 1) // self.seq_length
            samples_last = ((num_epochs * tokens_per_epoch - 1) // self.seq_length
                            - samples_wo_last)
            separate_last_epoch = (num_samples - samples_wo_last) <= int(
                0.80 * samples_last)

        key = hashlib.md5("-".join(map(str, [
            self.name, documents.size, int(documents[0]), int(documents[-1]),
            num_epochs, num_samples, self.seq_length, seed,
            separate_last_epoch])).encode()).hexdigest()[:16]

        paths = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            paths = {k: os.path.join(cache_dir, f"{self.name}_{key}_{k}.npy")
                     for k in ("doc", "sample", "shuffle")}
            if all(os.path.exists(p) for p in paths.values()):
                return (np.load(paths["doc"], mmap_mode="r"),
                        np.load(paths["sample"], mmap_mode="r"),
                        np.load(paths["shuffle"], mmap_mode="r"))

        rng = np.random.RandomState(seed)
        doc_idx = _build_doc_idx(documents, num_epochs, rng, separate_last_epoch)
        sample_idx = helpers.build_sample_idx(
            sizes, doc_idx, self.seq_length, num_epochs, tokens_per_epoch)
        if separate_last_epoch:
            samples_wo_last = ((num_epochs - 1) * tokens_per_epoch - 1) // self.seq_length
            shuffle_idx = _build_shuffle_idx(
                samples_wo_last, sample_idx.shape[0] - 1, rng)
        else:
            shuffle_idx = _build_shuffle_idx(
                sample_idx.shape[0] - 1, sample_idx.shape[0] - 1, rng)

        if paths:
            np.save(paths["doc"], doc_idx, allow_pickle=False)
            np.save(paths["sample"], sample_idx, allow_pickle=False)
            np.save(paths["shuffle"], shuffle_idx, allow_pickle=False)
        return doc_idx, sample_idx, shuffle_idx

    def __len__(self) -> int:
        return self.shuffle_idx.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """seq_length+1 tokens (ref: GPTDataset.__getitem__ — one extra
        token so input/label views overlap)."""
        idx = int(self.shuffle_idx[idx])
        doc_f, offset_f = self.sample_idx[idx]
        doc_l, offset_l = self.sample_idx[idx + 1]
        if doc_f == doc_l:
            sample = self.indexed.get(int(self.doc_idx[doc_f]), int(offset_f),
                                      int(offset_l) - int(offset_f) + 1)
        else:
            parts = [self.indexed.get(int(self.doc_idx[doc_f]), int(offset_f))]
            for d in range(int(doc_f) + 1, int(doc_l)):
                parts.append(self.indexed.get(int(self.doc_idx[d])))
            parts.append(self.indexed.get(int(self.doc_idx[doc_l]),
                                          length=int(offset_l) + 1))
            sample = np.concatenate(parts)
        return {"text": sample.astype(np.int64)}


def build_gpt_datasets(
    data_prefix: Sequence,
    splits_string: str,
    seq_length: int,
    train_valid_test_num_samples: Tuple[int, int, int],
    seed: int,
    cache_dir: Optional[str] = None,
):
    """(train, valid, test) datasets; multi-corpus prefixes with weights
    blend via BlendableDataset (ref: build_train_valid_test_datasets +
    BlendableDataset)."""
    from megatron_tpu_torch.data.blendable_dataset import BlendableDataset

    if len(data_prefix) == 1:
        return _single_prefix_datasets(
            data_prefix[0], splits_string, seq_length,
            train_valid_test_num_samples, seed, cache_dir)

    if len(data_prefix) % 2:
        raise ValueError("multi-corpus data_prefix must be weight,prefix pairs")
    weights = np.asarray([float(w) for w in data_prefix[0::2]], np.float64)
    weights = weights / weights.sum()
    prefixes = list(data_prefix[1::2])

    per_split = [[], [], []]
    for w, prefix in zip(weights, prefixes):
        n = tuple(int(np.ceil(w * s * 1.005)) for s in train_valid_test_num_samples)
        ds = _single_prefix_datasets(prefix, splits_string, seq_length, n,
                                     seed, cache_dir)
        for i in range(3):
            per_split[i].append(ds[i])
    out = []
    for i, n in enumerate(train_valid_test_num_samples):
        members = [d for d in per_split[i] if d is not None]
        out.append(BlendableDataset(members, weights, n) if members else None)
    return tuple(out)


def _single_prefix_datasets(prefix, splits_string, seq_length, nums, seed,
                            cache_dir):
    indexed = make_dataset(prefix)
    total_docs = indexed.doc_idx.shape[0] - 1
    splits = get_train_valid_test_split_(splits_string, total_docs)
    names = ["train", "valid", "test"]
    out = []
    for (start, end), name, n in zip(splits, names, nums):
        if end - start == 0 or n == 0:
            out.append(None)
            continue
        documents = np.arange(start, end, dtype=np.int32)
        out.append(GPTDataset(name, indexed, documents, n, seq_length, seed,
                              cache_dir))
    return tuple(out)
