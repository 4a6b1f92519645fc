"""Block-visibility predicates shared by the flash kernels
(counterpart of megatron_tpu/ops/pallas/masks.py).

One position model answers both questions every attention tile asks:
which (q, k) pairs are visible (the element mask), and can a whole kv
tile be skipped (the block predicate). Each query row has a global
position q_pos and each key column a position k_pos:

  * causal visibility is ``k_pos <= q_pos``;
  * a sliding window of width W adds ``k_pos > q_pos - W``.

Prefill tiles place q at ``qi*BQ + row + delta`` and k at
``ki*BK + col``; decode row r of a slot with valid prefix kv_len is
query j = r // G at ``kv_len - 1 + j``. csrc/masks.cuh carries the same
arithmetic as __device__ helpers, and the kernels turn the block
predicates into loop bounds (first and last live kv tile) rather than a
skip inside a full grid.

Everything here works on Python ints, numpy arrays and torch tensors
alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: Finite -inf stand-in: NEG_INF - NEG_INF stays finite in the online
#: softmax update, where a true -inf would give NaN.
NEG_INF = float(-1e30)


def visible(q_pos, k_pos, *, causal: bool = True,
            window: Optional[int] = None):
    """Element visibility of key position(s) to query position(s)."""
    m = (k_pos <= q_pos) if causal else (k_pos == k_pos)
    if window is not None:
        m = m & (k_pos > q_pos - window)
    return m


def prefill_positions(qi, ki, block_q: int, block_k: int, delta=0):
    """(q_pos, k_pos) [BQ, BK] grids for a prefill tile pair; delta is
    the q-vs-k global offset of the two tiles' origins."""
    q_pos = qi * block_q + np.arange(block_q)[:, None] + delta
    k_pos = ki * block_k + np.arange(block_k)[None, :]
    return (np.broadcast_to(q_pos, (block_q, block_k)),
            np.broadcast_to(k_pos, (block_q, block_k)))


def decode_positions(ki, block_k: int, kv_len, groups: int, rows: int):
    """(q_pos, k_pos) [rows, BK] grids for a decode tile: row r is query
    j = r // groups at global position kv_len - 1 + j."""
    q_idx = np.arange(rows)[:, None] // groups
    k_pos = ki * block_k + np.arange(block_k)[None, :]
    return (np.broadcast_to(kv_len - 1 + q_idx, (rows, block_k)),
            np.broadcast_to(k_pos, (rows, block_k)))


def block_live(ki, block_k: int, q_lo, q_hi, *, causal: bool = True,
               window: Optional[int] = None):
    """True iff kv tile ki holds ANY position visible to queries spanning
    global positions [q_lo, q_hi]: the union of their visible bands is
    (q_lo - W, q_hi]."""
    live = (ki * block_k <= q_hi) if causal else (ki == ki)
    if window is not None:
        live = live & ((ki + 1) * block_k - 1 > q_lo - window)
    return live


def decode_block_live(ki, block_k: int, kv_len, sq: int, *,
                      window: Optional[int] = None):
    """Decode queries span [kv_len - 1, kv_len + sq - 2]."""
    return block_live(ki, block_k, kv_len - 1, kv_len + sq - 2,
                      causal=True, window=window)


def prefill_block_live(qi, ki, block_q: int, block_k: int, *,
                       causal: bool = True, window: Optional[int] = None,
                       delta=0):
    """Prefill queries span [qi*BQ + delta, qi*BQ + BQ - 1 + delta]."""
    return block_live(ki, block_k, qi * block_q + delta,
                      qi * block_q + block_q - 1 + delta,
                      causal=causal, window=window)


def live_tile_range(block_k: int, n_k: int, q_lo: int, q_hi: int, *,
                    causal: bool = True, window: Optional[int] = None):
    """[first, last) kv tiles for which block_live holds, over n_k tiles:
    the loop bounds the CUDA kernels compute (masks.cuh
    live_tile_range). Empty when first >= last."""
    # causal edge: ki * BK <= q_hi  <=>  ki <= floor(q_hi / BK)
    hi = min(n_k, max(0, q_hi // block_k + 1)) if causal else n_k
    lo = 0
    if window is not None:
        # window edge: (ki + 1) * BK - 1 >= q_lo - W + 1 (the first
        # visible position)  <=>  ki >= floor((q_lo - W + 1) / BK)
        lo = max(0, (q_lo - window + 1) // block_k)
    return lo, hi


def live_q_tile_range(block_q: int, n_q: int, k_lo: int, k_hi: int, *,
                      causal: bool = True, window: Optional[int] = None,
                      delta: int = 0):
    """The inverse of live_tile_range: [first, last) q tiles (query row i
    at global position i + delta) holding any row that can see a key in
    [k_lo, k_hi] — the loop bounds of the dk/dv kernel (masks.cuh
    live_q_tile_range). Tile qi is in it exactly when
    prefill_block_live(qi, ...) holds for a kv tile spanning [k_lo, k_hi].
    Empty when first >= last."""
    # causal edge: qi*BQ + BQ - 1 + delta >= k_lo
    #   <=>  qi >= floor((k_lo - delta) / BQ)
    lo = max(0, (k_lo - delta) // block_q) if causal else 0
    hi = n_q
    if window is not None:
        # window edge: the tile's first row still sees k_hi,
        # k_hi > qi*BQ + delta - W  <=>  qi*BQ + delta <= k_hi + W - 1
        #   <=>  qi <= floor((k_hi + W - 1 - delta) / BQ)
        hi = min(n_q, max(0, (k_hi + window - 1 - delta) // block_q + 1))
    return lo, hi
