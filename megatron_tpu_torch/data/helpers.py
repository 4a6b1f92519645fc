"""Dataset index builders: the native module and its Python versions
(counterpart of megatron_tpu/data/helpers.py).

megatron_tpu_torch/csrc/data_helpers.cpp is compiled at first use with
g++ against the CPython and NumPy headers (no pybind11) into
megatron_tpu_torch/build/, under a name that carries a hash of the
source, the compiler flags, the Python ABI and the NumPy headers, so an
edited source never loads a stale library; the build writes a temporary
file and renames it into place, so concurrent processes never load a
torn one. Without a compiler the numpy/Python versions below run
instead, with one warning: they define the semantics and give the native
module's exact results, more slowly. build_mapping and
build_blocks_mapping (BERT and ICT data) are native only, as in the JAX
package.

`calls` counts, per builder, the calls the native module answered
("native") and those the Python versions did ("python").
"""

from __future__ import annotations

import collections
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "data_helpers.cpp"
BUILD_DIR = _PKG / "build"
MODULE = "_data_helpers"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

calls: collections.Counter = collections.Counter()
_lock = threading.Lock()
_native = None
_native_tried = False


def library_path() -> Path:
    """Where the build lands: a name carrying a hash of everything that
    shapes the binary."""
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(ext.encode())
    h.update(np.get_include().encode())
    h.update(np.__version__.encode())
    return BUILD_DIR / f"{MODULE}-{h.hexdigest()[:12]}{ext}"


def _build_native():
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *CXX_FLAGS,
                 f"-I{sysconfig.get_paths()['include']}",
                 f"-I{np.get_include()}", str(SOURCE), "-o", tmp],
                check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    spec = importlib.util.spec_from_file_location(MODULE, out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def native_helpers() -> Optional[object]:
    """The compiled module, built on first use; None if it cannot be
    built here (warned once)."""
    global _native, _native_tried
    with _lock:
        if not _native_tried:
            _native_tried = True
            try:
                _native = _build_native()
            except (OSError, subprocess.CalledProcessError,
                    ImportError) as e:
                detail = getattr(e, "stderr", "") or ""
                warnings.warn(f"native dataset helpers unavailable ({e}"
                              f"{'; ' + detail.strip() if detail else ''});"
                              " using the slower Python versions")
                _native = None
        return _native


# ---------------------------------------------------------------------------
# Python versions (the semantics' source of truth)
# ---------------------------------------------------------------------------


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
                     num_epochs: int, tokens_per_epoch: int,
                     native: bool = True) -> np.ndarray:
    """native=False runs the Python version (tests and the smoke hold
    the two against each other)."""
    sizes = np.ascontiguousarray(sizes, np.int32)
    doc_idx = np.ascontiguousarray(doc_idx, np.int32)
    mod = native_helpers() if native else None
    if mod is not None:
        calls["build_sample_idx", "native"] += 1
        return mod.build_sample_idx(sizes, doc_idx, int(seq_length),
                                    int(num_epochs), int(tokens_per_epoch))
    calls["build_sample_idx", "python"] += 1
    return _py_build_sample_idx(sizes, doc_idx, seq_length, num_epochs,
                                tokens_per_epoch)


def build_blending_indices(weights: np.ndarray, size: int,
                           verbose: bool = False, native: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    weights = np.ascontiguousarray(weights, np.float64)
    dataset_index = np.zeros(size, np.uint8)
    dataset_sample_index = np.zeros(size, np.int64)
    mod = native_helpers() if native else None
    if mod is not None:
        calls["build_blending_indices", "native"] += 1
        mod.build_blending_indices(dataset_index, dataset_sample_index,
                                   weights, len(weights), int(size),
                                   int(verbose))
    else:
        calls["build_blending_indices", "python"] += 1
        _py_build_blending_indices(dataset_index, dataset_sample_index,
                                   weights, len(weights), size, verbose)
    return dataset_index, dataset_sample_index


def _require_native(name: str):
    mod = native_helpers()
    if mod is None:
        raise RuntimeError(f"{name} requires the native helpers module")
    calls[name, "native"] += 1
    return mod


def build_mapping(docs: np.ndarray, sizes: np.ndarray, num_epochs: int,
                  max_num_samples: int, max_seq_length: int,
                  short_seq_prob: float, seed: int, verbose: bool = False,
                  min_num_sent: int = 2) -> np.ndarray:
    """BERT sentence-pair map; native only."""
    return _require_native("build_mapping").build_mapping(
        np.ascontiguousarray(docs, np.int64),
        np.ascontiguousarray(sizes, np.int32),
        int(num_epochs), int(max_num_samples), int(max_seq_length),
        float(short_seq_prob), int(seed), int(verbose), int(min_num_sent))


def build_blocks_mapping(docs: np.ndarray, sizes: np.ndarray,
                         titles: np.ndarray, num_epochs: int,
                         max_num_samples: int, max_seq_length: int,
                         seed: int, verbose: bool = False,
                         use_one_sent_blocks: bool = False) -> np.ndarray:
    """ICT block map; native only."""
    return _require_native("build_blocks_mapping").build_blocks_mapping(
        np.ascontiguousarray(docs, np.int64),
        np.ascontiguousarray(sizes, np.int32),
        np.ascontiguousarray(titles, np.int32),
        int(num_epochs), int(max_num_samples), int(max_seq_length),
        int(seed), int(verbose), int(use_one_sent_blocks))
