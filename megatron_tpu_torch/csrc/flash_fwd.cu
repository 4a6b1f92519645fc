// flash_fwd: FlashAttention-2 forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernel megatron_tpu/ops/pallas/flash_template.py
// _fwd_kernel (launched by _fwd): causal / bidirectional masking, sliding
// window, a runtime q-vs-k position offset `delta`, online softmax with
// fp32 m/l/acc, and the lse side output. Plain version:
// ops/flash/flash_template.py flash_fwd_reference.
//
// What bounds it: serving prefill at Llama-2-7B widths (H=32, D=128,
// S up to 2047) is operation-bound: 4*D FLOPs per visible (q, k) pair
// against 2*D bytes per row of q/k/v/o, far above the card's ~295
// FLOP/byte ridge. So the products run on the tensor cores (WMMA
// m16n16k16 bf16, fp32 accumulate) and K/V tiles are reused by all 64
// query rows of a block. Simple first: no wgmma, no TMA, no pipelining
// of the next tile's loads — those are later work.
//
// Design, against the TPU kernel:
//  * The Pallas grid walked kv tiles sequentially with m/l/acc in VMEM
//    scratch; here one thread block owns (batch, q head, 64-row q tile)
//    and LOOPS over kv tiles, bounded by the causal frontier and the
//    window's lower edge (masks.cuh live_tile_range), so dead tiles are
//    never loaded.
//  * Each of the 4 warps owns 16 query rows end to end (scores, softmax,
//    rescale, P·V), so only the shared K/V tile loads need block barriers.
//    acc lives in shared memory in fp32 because WMMA fragments do not
//    expose which row an element belongs to, and rescaling by the
//    per-row alpha needs that.
//  * GQA reads K/V at kv head h / G instead of materialising the
//    repeated copy the TPU launch builds with jnp.repeat.
//  * q/k/v/o are read and written in the framework layout [B, S, H, D]
//    through strides (last dim contiguous): no transposes.
//  * Any S >= 1: the ragged last q and kv tiles are masked in-kernel (the
//    TPU launch needed blocks % 128).
//  * Masked scores take the finite NEG_INF and l is clamped at 1e-30, as
//    in the TPU kernel, so a fully masked row emits 0 and lse ~ NEG_INF.
//  * P is rounded to bf16 for the tensor-core P·V product (the TPU kernel
//    keeps p in fp32); l is summed from the fp32 p.
//  * lse is written as plain [B, H, S] fp32 (the TPU kernel lane-padded
//    it to 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "masks.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <int D>
struct FwdSmem {
  // leading dimensions (elements), padded against bank conflicts and kept
  // at multiples WMMA accepts (8 for 16-bit types, 4 for float)
  static constexpr int LDQ = D + 8;   // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDA = D + 4;   // fp32 accumulator
  static constexpr size_t q_bytes = size_t(BQ) * LDQ * 2;
  static constexpr size_t kv_bytes = size_t(BK) * LDQ * 2;
  static constexpr size_t s_bytes = size_t(BQ) * LDS * 4;
  static constexpr size_t p_bytes = size_t(BQ) * LDP * 2;
  static constexpr size_t acc_bytes = size_t(BQ) * LDA * 4;
  static constexpr size_t stat_bytes = size_t(3) * BQ * 4;
  static constexpr size_t total =
      q_bytes + 2 * kv_bytes + s_bytes + p_bytes + acc_bytes + stat_bytes;
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

// rows [row0, row0 + 64) of a [rows, D] bf16 matrix with row stride
// `row_stride` (elements) into shared memory; rows >= nrows read as 0.
// All loads are issued before any store so they overlap in flight.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld,
                                          const bf16* __restrict__ base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  constexpr int ITER = 64 * VPR / THREADS;
  uint4 reg[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    const int gr = row0 + r;
    reg[it] = gr < nrows
                  ? __ldg(reinterpret_cast<const uint4*>(
                        base + (long long)gr * row_stride + c))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = reg[it];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     float scale, int causal, int window, int delta) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::q_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::q_bytes + L::kv_bytes);
  float* Ss = reinterpret_cast<float*>(smem + L::q_bytes + 2 * L::kv_bytes);
  bf16* Ps = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Ss) +
                                     L::s_bytes);
  float* Acc = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ps) +
                                        L::p_bytes);
  float* m_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Acc) + L::acc_bytes);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_causal = causal != 0;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  load_tile<D>(Qs, L::LDQ, qb, q_ss, q0, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += THREADS) Acc[i] = 0.f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = mtt::NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // kv tiles the block's valid query rows can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int lo, hi;
  mtt::live_tile_range(BK, (Skv + BK - 1) / BK, q0 + delta, q_last + delta,
                       is_causal, window, &lo, &hi);

  const int row0 = warp * 16;
  for (int ki = lo; ki < hi; ++ki) {
    const int k0 = ki * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, L::LDQ, kb, k_ss, k0, Skv);
    load_tile<D>(Vs, L::LDQ, vb, v_ss, k0, Skv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(sf[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
        wmma::load_matrix_sync(qf, Qs + row0 * L::LDQ + kk * 16, L::LDQ);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K stored [kv, d] row-major is K^T [d, kv] column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              kf;
          wmma::load_matrix_sync(kf, Ks + (n * 16) * L::LDQ + kk * 16,
                                 L::LDQ);
          wmma::mma_sync(sf[n], qf, kf, sf[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + row0 * L::LDS + n * 16, sf[n], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int q_pos = q0 + r + delta;
      float sv[2];
      bool mk[2];
      float mx = mtt::NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const int k_pos = k0 + j;
        mk[c] = k_pos < Skv && mtt::visible(q_pos, k_pos, is_causal, window);
        sv[c] = mk[c] ? Ss[r * L::LDS + j] * scale : mtt::NEG_INF;
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
        Ps[r * L::LDP + lane + 32 * c] = __float2bfloat16(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = __expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncwarp();

    // acc *= alpha per row
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const float alpha = a_s[r];
      for (int c = lane; c < D; c += 32) Acc[r * L::LDA + c] *= alpha;
    }
    __syncwarp();

    // acc += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Acc + row0 * L::LDA + n * 16, L::LDA,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::load_matrix_sync(pf, Ps + row0 * L::LDP + kk * 16, L::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + (kk * 16) * L::LDQ + n * 16, L::LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Acc + row0 * L::LDA + n * 16, of, L::LDA,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // emit o = acc / l and lse = m + log(l) for this warp's valid rows
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row0 + rr;
    const int qrow = q0 + r;
    if (qrow >= Sq) break;
    const float l = fmaxf(l_s[r], 1e-30f);
    bf16* orow = o + b * o_sb + (long long)qrow * o_ss + h * o_sh;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(Acc[r * L::LDA + c] / l);
    if (lane == 0)
      lse[((long long)b * Hq + h) * Sq + qrow] = m_s[r] + logf(l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   const long long* qs, const long long* ks,
                   const long long* vs, const long long* os, float scale,
                   int causal, int window, int delta, cudaStream_t stream) {
  using L = FwdSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::total);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, L::total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], os[0], os[1], os[2], scale, causal,
      window, delta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Strides are in elements, (batch, seq, head)
// for each of q, k, v, o; the head dim must be contiguous. window <= 0
// means no sliding window. Returns the cudaError_t of the launch.
extern "C" int mtt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int D,
                                  long long q_sb, long long q_ss,
                                  long long q_sh, long long k_sb,
                                  long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss,
                                  long long v_sh, long long o_sb,
                                  long long o_ss, long long o_sh, float scale,
                                  int causal, int window, int delta,
                                  void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const long long os[3] = {o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, qs, ks, vs,
                            os, scale, causal, window, delta, st);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, qs, ks, vs,
                           os, scale, causal, window, delta, st);
  return (int)cudaErrorInvalidValue;
}
