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

}  // namespace mtt
