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

}  // namespace mtt
