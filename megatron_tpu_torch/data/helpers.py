"""Dataset index builders (counterpart of megatron_tpu/data/helpers.py).

The JAX package compiles a native C++ module for these loops and keeps
numpy/Python versions beside it as the semantics' source of truth; the
port carries only those Python versions (the native module is not
ported yet). They give the native module's exact results, more slowly:
fine for the corpora the port's tests and smoke run build.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _py_build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray,
                         seq_length: int, num_epochs: int,
                         tokens_per_epoch: int) -> np.ndarray:
    total_tokens = num_epochs * tokens_per_epoch
    num_samples = (total_tokens - 1) // seq_length
    sample_idx = np.zeros((num_samples + 1, 2), np.int32)
    doc_pos, offset = 0, 0
    for i in range(1, num_samples + 1):
        remaining = seq_length
        while remaining > 0:
            doc_len = sizes[doc_idx[doc_pos]] - offset
            if doc_len > remaining:
                offset += remaining
                remaining = 0
            else:
                remaining -= doc_len
                doc_pos += 1
                offset = 0
        sample_idx[i] = (doc_pos, offset)
    return sample_idx


def _py_build_blending_indices(dataset_index: np.ndarray,
                               dataset_sample_index: np.ndarray,
                               weights: np.ndarray, num_datasets: int,
                               size: int, verbose: bool) -> None:
    current = np.zeros(num_datasets, np.int64)
    for i in range(size):
        errors = weights * (i + 1) - current
        d = int(np.argmax(errors))
        dataset_index[i] = d
        dataset_sample_index[i] = current[d]
        current[d] += 1


def build_sample_idx(sizes: np.ndarray, doc_idx: np.ndarray, seq_length: int,
                     num_epochs: int, tokens_per_epoch: int) -> np.ndarray:
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    return _py_build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
                                tokens_per_epoch)


def build_blending_indices(weights: np.ndarray, size: int,
                           verbose: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray]:
    weights = np.ascontiguousarray(weights, np.float64)
    dataset_index = np.zeros(size, np.uint8)
    dataset_sample_index = np.zeros(size, np.int64)
    _py_build_blending_indices(dataset_index, dataset_sample_index, weights,
                               len(weights), size, verbose)
    return dataset_index, dataset_sample_index
