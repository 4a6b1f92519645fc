// flash_decode: Sq-small attention over a per-slot KV cache for Hopper
// (sm_90a), bf16 in/out — one decode tick of the continuous-batching
// engine (Sq = 1), and the speculative verify pass later (Sq = k + 1).
// Two launches of one kernel body, as in the TPU package:
//
//  * dense (PAGED = false): the [B, S, Hkv, D] slot cache. Replaces
//    megatron_tpu/ops/pallas/flash_template.py _decode_kernel in its dense
//    launch (_decode_call with no page table). Plain version:
//    ops/flash/flash_template.py flash_decode_reference.
//  * paged (PAGED = true): the shared page pools [P, ps, Hkv, D] and a
//    [B, max_pages] int32 page table; row b's logical position pos lives
//    at pool[table[b, pos / ps], pos % ps]. Replaces the same
//    _decode_kernel in its paged launch (_with_page_table, _decode_call
//    with a page table). Plain version: paged_flash_decode_reference.
//
// What bounds it: bytes. Every visible cache position is read once as
// K and V (2 * Hkv * D * 2 bytes) for 4 * Sq * G * D FLOPs, about one
// FLOP per byte at G = 1, far below the card's ~295 FLOP/byte ridge. So
// the kernel reads only the visible prefix of each slot, once, with
// 16-byte coalesced loads, and does its arithmetic with plain fp32 FMAs
// from shared memory. Simple first: no split-K over the sequence (one
// block walks a slot's whole prefix), no cp.async/TMA double buffering —
// those are later work.
//
// Design, against the TPU kernel:
//  * One thread block per (slot, kv head) holds all R = Sq * G query rows
//    of that kv head (GQA without replicating K/V). Row r is query
//    j = r / G at position kv_len - 1 + j and sees k_pos < kv_len + j.
//  * The block loops over kv tiles only from the window's first live tile
//    to ceil((kv_len + Sq - 1) / BK) (masks.cuh live_tile_range): the TPU
//    kernel's decode_block_live predicate as loop bounds, so a young slot
//    in a long cache pays only for its own prefix.
//  * The cache is read in its stored [B, S, Hkv, D] layout through
//    strides. The TPU launch transposed the whole cache to [B, Hkv, S, D]
//    on every call, a full copy of the cache per tick.
//  * Paged: the TPU grid fetched one page per step through the scalar-
//    prefetched table. Here a kv tile is still BK positions, which may
//    span several pages (ps < BK) or part of one (ps > BK), and pages
//    that are consecutive in a row are scattered in the pool (LIFO free
//    list, shared prefixes). So every thread resolves the physical page
//    of each row it loads from the table (one int32 read, shared through
//    L1 by the row's 16 loaders) and addresses it in int64 from the
//    layer's pool pointer: one layer's pool passes 2^31 bytes at
//    serving sizes. ps must be a power of two (the position splits into
//    page and row with a shift and a mask). The table and kv_lengths
//    are read on the device: nothing syncs with the host per layer, so
//    the wrapper cannot check the entries; the kernel reads an entry
//    outside [0, P) as the scratch page instead of outside the pool.
//  * Masked scores take the finite NEG_INF and l is clamped at 1e-30, as
//    in the TPU kernel; p, l and acc stay fp32. Scratch-page entries
//    (idle rows, pages released behind a sliding window) hold finite
//    values and are masked to p = 0, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;

template <int D>
struct DecSmem {
  // bf16 K/V row stride: D + 2 elements is an odd number of 4-byte words,
  // so threads reading different rows at the same column hit distinct
  // banks in the score loop
  static constexpr int LDK = D + 2;
  static size_t bytes(int R) {
    return (size_t(2) * R * D + size_t(R) * BK + size_t(3) * R) * 4 +
           size_t(2) * BK * LDK * 2;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dense: k/v strides are (slot, position, head). Paged: (page, row in
// page, head), S = max_pages << page_shift, page_table [B, max_pages]
// with entries in [0, n_pages).
template <int D, bool PAGED>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ kv_lengths,
                        const int* __restrict__ page_table, int n_pages,
                        int max_pages, int page_shift,
                        bf16* __restrict__ o, int Sq, int S, int Hq, int Hkv,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int window) {
  constexpr int LDK = DecSmem<D>::LDK;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [R][D], unscaled
  float* Acc = Qs + R * D;                     // [R][D]
  float* Ss = Acc + R * D;                     // [R][BK] scores, then p
  float* m_s = Ss + R * BK;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  bf16* Ks = reinterpret_cast<bf16*>(a_s + R);  // [BK][LDK]
  bf16* Vs = Ks + BK * LDK;

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int j = r / G, g = r % G;
    Qs[i] = __bfloat162float(
        q[b * q_sb + j * q_ss + (long long)(h * G + g) * q_sh + d]);
    Acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = mtt::NEG_INF;
    l_s[r] = 0.f;
  }
  const int kv_len = kv_lengths[b];
  // queries sit at [kv_len - 1, kv_len + Sq - 2]; positions past the
  // deepest query (or past the cache) are never read
  const int k_end = min(S, kv_len + Sq - 1);
  int lo, hi;
  mtt::live_tile_range(BK, (S + BK - 1) / BK, kv_len - 1, kv_len + Sq - 2,
                       true, window, &lo, &hi);
  __syncthreads();

  const bf16* kb = k + h * k_sh;
  const bf16* vb = v + h * v_sh;
  if constexpr (!PAGED) {
    kb += b * k_sb;
    vb += b * v_sb;
  }
  const int* table = PAGED ? page_table + (long long)b * max_pages : nullptr;
  const int row_mask = (1 << page_shift) - 1;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int ITER = BK * VPR / THREADS;

  for (int ki = lo; ki < hi; ++ki) {
    const int k0 = ki * BK;
    // K/V tile: issue every load before the first store
    uint4 kr[ITER], vr[ITER];
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / VPR, c = (i % VPR) * 8;
      const int kp = k0 + r;
      const bool ok = kp < k_end;
      long long ko = (long long)kp * k_ss, vo = (long long)kp * v_ss;
      if constexpr (PAGED) {
        // this row's physical page, resolved per row: a tile may span
        // several scattered pages
        int page = ok ? __ldg(table + (kp >> page_shift)) : 0;
        page = (unsigned)page < (unsigned)n_pages ? page : 0;
        const long long rp = kp & row_mask;
        ko = (long long)page * k_sb + rp * k_ss;
        vo = (long long)page * v_sb + rp * v_ss;
      }
      kr[it] = ok ? __ldg(reinterpret_cast<const uint4*>(kb + ko + c))
                  : make_uint4(0u, 0u, 0u, 0u);
      vr[it] = ok ? __ldg(reinterpret_cast<const uint4*>(vb + vo + c))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / VPR, c = (i % VPR) * 8;
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * LDK + c);
      uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + r * LDK + c);
      kd[0] = kr[it].x; kd[1] = kr[it].y; kd[2] = kr[it].z; kd[3] = kr[it].w;
      vd[0] = vr[it].x; vd[1] = vr[it].y; vd[2] = vr[it].z; vd[3] = vr[it].w;
    }
    __syncthreads();

    // scores s[r][j] = q[r] . k[j] * scale
    for (int i = tid; i < R * BK; i += THREADS) {
      const int r = i / BK, j = i % BK;
      const float* qr = Qs + r * D;
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(Ks + j * LDK);
      float acc = 0.f;
#pragma unroll 16
      for (int d2 = 0; d2 < D / 2; ++d2) {
        const float2 kf = __bfloat1622float2(krow[d2]);
        acc = fmaf(qr[2 * d2], kf.x, acc);
        acc = fmaf(qr[2 * d2 + 1], kf.y, acc);
      }
      Ss[i] = acc * scale;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += WARPS) {
      const int q_pos = kv_len - 1 + r / G;
      float sv[2];
      bool mk[2];
      float mx = mtt::NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const int k_pos = k0 + j;
        mk[c] = k_pos < S && mtt::visible(q_pos, k_pos, true, window);
        sv[c] = mk[c] ? Ss[r * BK + j] : mtt::NEG_INF;
        mx = fmaxf(mx, sv[c]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = mk[c] ? __expf(sv[c] - m_new) : 0.f;
        psum += p;
        Ss[r * BK + lane + 32 * c] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = __expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_j p[r][j] * v[j][d]
    for (int i = tid; i < R * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const float* pr = Ss + r * BK;
      float a = Acc[i] * a_s[r];
#pragma unroll 16
      for (int j = 0; j < BK; ++j)
        a = fmaf(pr[j], __bfloat162float(Vs[j * LDK + d]), a);
      Acc[i] = a;
    }
    __syncthreads();  // K/V/S are reused by the next tile
  }

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int j = r / G, g = r % G;
    const float l = fmaxf(l_s[r], 1e-30f);
    o[b * o_sb + j * o_ss + (long long)(h * G + g) * o_sh + d] =
        __float2bfloat16(Acc[i] / l);
  }
}

template <int D, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lengths, const int* page_table,
                   int n_pages, int max_pages, int page_shift, void* o,
                   int B, int Sq,
                   int S, int Hq, int Hkv, const long long* qs,
                   const long long* ks, const long long* vs,
                   const long long* os, float scale, int window,
                   cudaStream_t stream) {
  const int R = Sq * (Hq / Hkv);
  const size_t smem = DecSmem<D>::bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  flash_decode_kernel<D, PAGED><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_lengths, page_table, n_pages,
      max_pages, page_shift, static_cast<bf16*>(o), Sq, S, Hq, Hkv, qs[0], qs[1], qs[2],
      ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os[0], os[1], os[2], scale,
      window);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v,
             const void* kv_lengths, const void* page_table, int n_pages,
             int max_pages, int page_shift, void* o, int B, int Sq, int S,
             int Hq, int Hkv,
             int D, const long long* qs, const long long* ks,
             const long long* vs, const long long* os, float scale,
             int window, void* stream) {
  if (B < 1 || Sq < 1 || S < 1 || Hkv < 1 || Hq % Hkv ||
      Sq * (Hq / Hkv) > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(kv_lengths);
  const int* table = static_cast<const int*>(page_table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128, PAGED>(q, k, v, lens, table, n_pages, max_pages,
                                   page_shift, o, B, Sq, S, Hq, Hkv, qs, ks,
                                   vs, os, scale, window, st);
  if (D == 64)
    return (int)launch<64, PAGED>(q, k, v, lens, table, n_pages, max_pages,
                                  page_shift, o, B, Sq, S, Hq, Hkv, qs, ks,
                                  vs, os, scale, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of the launch.
//
// Dense: q/o are [B, Sq, Hq, D], k/v [B, S, Hkv, D], kv_lengths [B] int32
// on the device; strides in elements as (batch, seq, head), head dim
// contiguous. window <= 0 means no sliding window.
extern "C" int mtt_flash_decode_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_lengths,
                                     void* o, int B, int Sq, int S, int Hq,
                                     int Hkv, int D, long long q_sb,
                                     long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss,
                                     long long k_sh, long long v_sb,
                                     long long v_ss, long long v_sh,
                                     long long o_sb, long long o_ss,
                                     long long o_sh, float scale, int window,
                                     void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const long long os[3] = {o_sb, o_ss, o_sh};
  return dispatch<false>(q, k, v, kv_lengths, nullptr, 0, 0, 0, o, B, Sq, S,
                         Hq, Hkv, D, qs, ks, vs, os, scale, window, stream);
}

// Paged: k/v are one layer's page pools [P, ps, Hkv, D] (P = n_pages)
// with strides in elements as (page, row in page, head), page_table
// [B, max_pages] int32 contiguous on the device (entries in [0, P); 0 is
// the scratch page), ps = 1 << page_shift.
extern "C" int mtt_paged_flash_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_lengths, void* o, int B, int Sq,
    int n_pages, int max_pages, int page_shift, int Hq, int Hkv, int D,
    long long q_sb,
    long long q_ss, long long q_sh, long long k_sp, long long k_sr,
    long long k_sh, long long v_sp, long long v_sr, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int window,
    void* stream) {
  cudaGetLastError();
  if (n_pages < 1 || max_pages < 1 || page_shift < 0 || page_shift > 20)
    return (int)cudaErrorInvalidValue;
  const long long S = (long long)max_pages << page_shift;
  if (S > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sp, k_sr, k_sh};
  const long long vs[3] = {v_sp, v_sr, v_sh};
  const long long os[3] = {o_sb, o_ss, o_sh};
  return dispatch<true>(q, k_pages, v_pages, kv_lengths, page_table,
                        n_pages, max_pages, page_shift, o, B, Sq, (int)S, Hq,
                        Hkv, D, qs, ks, vs, os, scale, window, stream);
}
