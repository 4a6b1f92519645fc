"""Memory-mapped indexed token dataset — the `.bin`/`.idx` format.

(A copy of megatron_tpu/data/indexed_dataset.py with its imports rewritten.)

Re-implementation of the mmap variant of megatron/data/indexed_dataset.py
(585 LoC; itself fairseq-derived). The ON-DISK FORMAT IS IDENTICAL so
datasets preprocessed for the reference load here unchanged and vice versa
(SURVEY.md §7 point 4: keep the binary format verbatim to inherit
determinism):

  .idx:  magic "MMIDIDX\\x00\\x00" | version u64=1 | dtype-code u8 |
         n_sequences i64 | n_docs i64 | sizes i32[n] | pointers i64[n] |
         doc_idx i64[n_docs]
  .bin:  raw token array, dtype per the code table

The reference's lazy/cached legacy variants (IndexedDataset pre-mmap) are
not carried over — mmap is strictly better on every axis and is what its
own preprocessing emits by default.

Dtype auto-pick matches the reference: uint16 when vocab < 65500
(indexed_dataset.py:24-28).
"""

from __future__ import annotations

import os
import shutil
import struct
from typing import List, Optional, Sequence

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

# dtype codes shared with the reference (indexed_dataset.py dtypes table)
DTYPES = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float32,
    7: np.float64,
    8: np.uint16,
}
_CODES = {np.dtype(v): k for k, v in DTYPES.items()}


def best_dtype(vocab_size: Optional[int]) -> np.dtype:
    if vocab_size is not None and vocab_size < 65500:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDataset:
    """Read-only mmap view over (.bin, .idx)."""

    def __init__(self, path_prefix: str):
        self._path = path_prefix
        with open(index_file_path(path_prefix), "rb") as f:
            magic = f.read(9)
            if magic != _MAGIC:
                raise ValueError(
                    f"{index_file_path(path_prefix)}: bad magic {magic!r} — "
                    "not an indexed dataset")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            (code,) = struct.unpack("<B", f.read(1))
            self._dtype = np.dtype(DTYPES[code])
            (count,) = struct.unpack("<q", f.read(8))
            (doc_count,) = struct.unpack("<q", f.read(8))
            offset = f.tell()

        self._index_buf = np.memmap(index_file_path(path_prefix), mode="r",
                                    order="C")
        self.sizes = np.frombuffer(self._index_buf, np.int32, count, offset)
        offset += count * 4
        self._pointers = np.frombuffer(self._index_buf, np.int64, count, offset)
        offset += count * 8
        self.doc_idx = np.frombuffer(self._index_buf, np.int64, doc_count, offset)
        self._data = np.memmap(data_file_path(path_prefix), mode="r", order="C")

    def __len__(self) -> int:
        return len(self.sizes)

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        """Read tokens from sequence idx starting at `offset`
        (ref: MMapIndexedDataset.get, used by GPTDataset packing)."""
        size = int(self.sizes[idx])
        if length is None:
            length = size - offset
        ptr = int(self._pointers[idx]) + offset * self._dtype.itemsize
        return np.frombuffer(self._data, self._dtype, length, ptr)

    def __getitem__(self, idx):
        return self.get(idx)

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return (os.path.exists(index_file_path(path_prefix))
                and os.path.exists(data_file_path(path_prefix)))


class MMapIndexedDatasetBuilder:
    """Streaming writer (ref: MMapIndexedDatasetBuilder + Index.writer)."""

    def __init__(self, out_file: str, dtype=np.int32):
        self._data_file = open(out_file, "wb")
        self._dtype = np.dtype(dtype)
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data_file.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def add_doc(self, tokens: Sequence[int]) -> None:
        self.add_item(tokens)
        self.end_document()

    def merge_file_(self, another_prefix: str) -> None:
        """Append another dataset (parallel preprocessing merge,
        ref indexed_dataset.py merge_file_)."""
        index = MMapIndexedDataset(another_prefix)
        if index.dtype != self._dtype:
            raise ValueError("dtype mismatch in merge")
        base = len(self._sizes)
        self._sizes.extend(int(s) for s in index.sizes)
        self._doc_idx.extend(base + int(d) for d in index.doc_idx[1:])
        with open(data_file_path(another_prefix), "rb") as f:
            shutil.copyfileobj(f, self._data_file)

    def finalize(self, index_file: str) -> None:
        self._data_file.close()
        sizes = np.asarray(self._sizes, np.int32)
        itemsize = self._dtype.itemsize
        pointers = np.zeros(len(sizes), np.int64)
        if len(sizes):
            np.cumsum(sizes[:-1] * itemsize, out=pointers[1:])
        doc_idx = np.asarray(self._doc_idx, np.int64)
        with open(index_file, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _CODES[self._dtype]))
            f.write(struct.pack("<q", len(sizes)))
            f.write(struct.pack("<q", len(doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(doc_idx.tobytes(order="C"))


def make_builder(out_prefix: str, vocab_size: Optional[int] = None,
                 dtype=None) -> MMapIndexedDatasetBuilder:
    return MMapIndexedDatasetBuilder(
        data_file_path(out_prefix),
        dtype=dtype or best_dtype(vocab_size))


def make_dataset(path_prefix: str) -> MMapIndexedDataset:
    if not MMapIndexedDataset.exists(path_prefix):
        raise FileNotFoundError(f"no indexed dataset at {path_prefix}(.bin/.idx)")
    return MMapIndexedDataset(path_prefix)
