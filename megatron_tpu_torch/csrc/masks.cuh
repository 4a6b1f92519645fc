// Block-visibility arithmetic shared by the flash kernels: the __device__
// form of ops/flash/masks.py (itself the counterpart of the JAX package's
// megatron_tpu/ops/pallas/masks.py). One position model: causal
// visibility is k_pos <= q_pos, a sliding window of width W (W > 0) adds
// k_pos > q_pos - W. The block predicates become loop bounds: a kernel
// walks kv tiles [lo, hi) and never touches a tile outside the visible
// band of its queries.
#pragma once

namespace mtt {

// Finite -inf stand-in: NEG_INF - NEG_INF stays finite in the online
// softmax update (a true -inf would give NaN).
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool visible(int q_pos, int k_pos, bool causal,
                                        int window) {
  bool m = causal ? (k_pos <= q_pos) : true;
  if (window > 0) m = m && (k_pos > q_pos - window);
  return m;
}

// floor(a / b) for b > 0 and any sign of a (C++ division truncates).
__device__ __forceinline__ int floor_div(int a, int b) {
  return (a >= 0) ? a / b : -((-a + b - 1) / b);
}

// [lo, hi) kv tiles holding any position visible to queries spanning
// global positions [q_lo, q_hi] (masks.py live_tile_range).
__device__ __forceinline__ void live_tile_range(int block_k, int n_k,
                                                int q_lo, int q_hi,
                                                bool causal, int window,
                                                int* lo, int* hi) {
  int h = n_k;
  if (causal) {
    h = floor_div(q_hi, block_k) + 1;
    h = h < 0 ? 0 : (h > n_k ? n_k : h);
  }
  int l = 0;
  if (window > 0) {
    l = floor_div(q_lo - window + 1, block_k);
    l = l < 0 ? 0 : l;
  }
  *lo = l;
  *hi = h;
}

// What a (q tile, kv tile) pair needs (masks.py tile_class). The tile is
// query rows [q0, q0 + bq) (row i at position i + delta) against key
// columns [k0, k0 + bk); a pair counts when its row < Sq, its column < Skv
// and `visible` holds. FULL: every pair of the tile counts, so no
// per-element mask. DEAD: none does. EDGE: anything else.
enum { TILE_DEAD = 0, TILE_EDGE = 1, TILE_FULL = 2 };

__device__ __forceinline__ int tile_class(int q0, int bq, int k0, int bk,
                                          int Sq, int Skv, bool causal,
                                          int window, int delta) {
  const int q_end = q0 + bq < Sq ? q0 + bq : Sq;
  const int k_end = k0 + bk < Skv ? k0 + bk : Skv;
  if (q_end <= q0 || k_end <= k0) return TILE_DEAD;
  // the union of the valid rows' bands is (p_lo - W, p_hi]
  const int p_lo = q0 + delta, p_hi = q_end - 1 + delta;
  if (causal && k0 > p_hi) return TILE_DEAD;
  if (window > 0 && k_end - 1 <= p_lo - window) return TILE_DEAD;
  const bool full = q0 + bq <= Sq && k0 + bk <= Skv &&
                    (!causal || k0 + bk - 1 <= p_lo) &&
                    (window <= 0 || k0 > p_hi - window);
  return full ? TILE_FULL : TILE_EDGE;
}

// The inverse range: [lo, hi) q tiles of block_q rows (query row i at
// global position i + delta) holding any row that can see a key in
// [k_lo, k_hi] — the loop bounds of the dk/dv kernel (masks.py
// live_q_tile_range).
__device__ __forceinline__ void live_q_tile_range(int block_q, int n_q,
                                                  int k_lo, int k_hi,
                                                  bool causal, int window,
                                                  int delta, int* lo,
                                                  int* hi) {
  // causal edge: the tile's last row reaches k_lo
  int l = causal ? floor_div(k_lo - delta, block_q) : 0;
  l = l < 0 ? 0 : l;
  int h = n_q;
  if (window > 0) {
    // window edge: the tile's first row still sees k_hi
    h = floor_div(k_hi + window - 1 - delta, block_q) + 1;
    h = h < 0 ? 0 : (h > n_q ? n_q : h);
  }
  *lo = l;
  *hi = h;
}

// The split-K decode schedule (masks.py decode_live_splits,
// decode_split_range). A slot's live kv tiles [lo, hi) are cut into fixed
// runs of split_tiles tiles from lo; split s owns [lo + s * split_tiles,
// + split_tiles) clipped to hi. At least one split is live, so a slot with
// no live tile still writes its (zero) output.
__device__ __forceinline__ int decode_live_splits(int lo, int hi,
                                                  int split_tiles) {
  return hi > lo ? (hi - lo + split_tiles - 1) / split_tiles : 1;
}

__device__ __forceinline__ void decode_split_range(int split,
                                                   int split_tiles, int lo,
                                                   int hi, int* first,
                                                   int* last) {
  const int f = lo + split * split_tiles;
  const int l = f + split_tiles < hi ? f + split_tiles : hi;
  *first = f;
  *last = l > f ? l : f;
}

}  // namespace mtt
