// flash_bwd: the FlashAttention-2 recompute backward for Hopper (sm_90a),
// bf16 in/out, as two kernels:
//
//   flash_bwd_dq_kernel   replaces megatron_tpu/ops/pallas/flash_template.py
//                         _dq_kernel (launched by _bwd, :288)
//   flash_bwd_dkv_kernel  replaces the same file's _dkv_kernel (launched by
//                         _bwd, :313)
//
// Both recompute p = exp(q·kᵀ·scale − lse) from the forward's lse instead of
// storing the [S, S] probabilities, then
//   dp = do·vᵀ,  ds = p·(dp − dsum)  with dsum = rowsum(do·o) per query row,
//   dq = scale·Σ_k ds·k,  dk = scale·Σ_q dsᵀ·q,  dv = Σ_q pᵀ·do.
// Masking is the forward's: causal / bidirectional, sliding window, and a
// runtime q-vs-k position offset `delta`; p is 0 wherever `visible` is
// false (never exp of a huge number), so fully masked rows give zero
// gradients. Plain version: ops/flash/flash_template.py
// flash_bwd_reference.
//
// What bounds them: training attention at Llama-2-7B widths (H=32, D=128,
// S=4096 causal) is operation-bound: the dq kernel does 3 products of
// 2·D FLOPs per visible (q, k) pair (6·D), the dk/dv kernel 4 (8·D), against
// ~2·D bytes per row of each operand — far above the card's ~295 FLOP/byte
// ridge. So every product runs on the tensor cores (WMMA m16n16k16 bf16,
// fp32 accumulate) and each K/V (dq) or Q/dO (dk/dv) tile loaded into
// shared memory is reused by the block's 64 rows. Simple first: no wgmma,
// no TMA, no pipelining of the next tile's loads — those are later work.
//
// Design, against the TPU kernels:
//  * Pallas ran each as a sequential grid axis carrying dq (or dk/dv) in
//    VMEM scratch. Here a thread block owns its output tile and LOOPS:
//    the dq block (batch, q head, 64-row q tile) over its live kv tiles
//    (masks.cuh live_tile_range, the forward's bounds), the dk/dv block
//    (batch, kv head, 64-row kv tile) over its live q tiles
//    (masks.cuh live_q_tile_range, the inverse range).
//  * GQA: the dk/dv block loops over the G query heads of its kv head and
//    sums their contributions in its own fp32 accumulators. The TPU launch
//    repeated K/V per query head (jnp.repeat) and group-summed dk/dv in
//    the repeat's vjp; here no copy of K/V exists, and the group sum needs
//    no atomics, so it is deterministic. The dq block reads K/V at kv head
//    h / G through strides.
//  * Each of the 4 warps owns 16 rows of the block's output tile end to
//    end, so only the shared input tile loads need block barriers. The
//    accumulators live in shared memory in fp32 (as in flash_fwd.cu).
//  * The TPU kernel pre-scaled q in fp32 before its dk product; here q
//    stays bf16 for the tensor cores and the scale multiplies the fp32 dk
//    accumulator at the end — the same product without rounding q·scale
//    to bf16.
//  * p and ds are rounded to bf16 for the tensor-core products (the TPU
//    kernels keep them fp32); the rest is fp32.
//  * q/k/v/do/dq/dk/dv in the framework layout [B, S, H, D] through
//    strides (last dim contiguous); lse and dsum as plain [B, Hq, Sq] fp32.
//  * Any S >= 1: ragged last tiles are masked in-kernel (rows past Sq or
//    columns past Skv contribute nothing and are not written).

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

// Shared-memory plan. Leading dimensions (elements) are padded against
// bank conflicts and kept at multiples WMMA accepts (8 for 16-bit types,
// 4 for float); every section starts at a multiple of 32 bytes.
template <int D>
struct BwdSmem {
  static constexpr int LDT = D + 8;   // bf16 input tiles (64 rows)
  static constexpr int LDS = 64 + 4;  // fp32 score-shaped tiles [64, 64]
  static constexpr int LDP = 64 + 8;  // bf16 score-shaped tiles [64, 64]
  static constexpr int LDA = D + 4;   // fp32 accumulators [64, D]
  static constexpr size_t tile_bytes = size_t(64) * LDT * 2;
  static constexpr size_t s_bytes = size_t(64) * LDS * 4;
  static constexpr size_t p_bytes = size_t(64) * LDP * 2;
  static constexpr size_t acc_bytes = size_t(64) * LDA * 4;
  static constexpr size_t stat_bytes = size_t(2) * 64 * 4;
  // dq: Q, dO, K, V tiles; S, dP; dS; dQ accumulator; lse, dsum
  static constexpr size_t dq_total =
      4 * tile_bytes + 2 * s_bytes + p_bytes + acc_bytes + stat_bytes;
  // dk/dv: K, V, Q, dO tiles; Sᵀ, dPᵀ; Pᵀ, dSᵀ; dK, dV accumulators; stats
  static constexpr size_t dkv_total =
      4 * tile_bytes + 2 * s_bytes + 2 * p_bytes + 2 * acc_bytes + stat_bytes;
};

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

// out[16, 64] (fp32, ld LDS) = A[16, D] · B[64, D]ᵀ for one warp: A rows
// start at `a` (bf16, ld LDT), B's 64 rows at `b` (bf16, ld LDT).
template <int D>
__device__ __forceinline__ void warp_abt(float* out, const bf16* a,
                                         const bf16* b) {
  using L = BwdSmem<D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, L::LDT);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      // B stored [row, d] row-major is Bᵀ [d, row] column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, b + (n * 16) * L::LDT + kk * 16, L::LDT);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], L::LDS, wmma::mem_row_major);
}

// acc[16, D] (fp32, ld LDA) += A[16, 64] · B[64, D] for one warp: A is a
// bf16 score-shaped tile (ld LDP), B a bf16 input tile (ld LDT).
template <int D>
__device__ __forceinline__ void warp_acc_ab(float* acc, const bf16* a,
                                            const bf16* b) {
  using L = BwdSmem<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
    wmma::load_matrix_sync(cf, acc + n * 16, L::LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, a + kk * 16, L::LDP);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b + (kk * 16) * L::LDT + n * 16, L::LDT);
      wmma::mma_sync(cf, af, bf, cf);
    }
    wmma::store_matrix_sync(acc + n * 16, cf, L::LDA, wmma::mem_row_major);
  }
}

// one warp writes rows [row0, row0 + 16) of a fp32 accumulator, times
// `mul`, as bf16 rows of `out` (row stride `ss`), rows < nrows only
template <int D>
__device__ __forceinline__ void emit_rows(bf16* out, long long ss,
                                          const float* acc, int row0,
                                          int grow0, int nrows, float mul,
                                          int lane) {
  using L = BwdSmem<D>;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = row0 + rr;
    if (grow0 + r >= nrows) break;
    bf16* orow = out + (long long)(grow0 + r) * ss;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(acc[r * L::LDA + c] * mul);
  }
}

struct Strides {
  long long b, s, h;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, bf16* __restrict__ dq,
                        int Sq, int Skv, int Hq, int Hkv, Strides qs,
                        Strides ks, Strides vs, Strides dos, Strides dqs,
                        float scale, int causal, int window, int delta) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* Qs = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += L::tile_bytes;
  bf16* Ks = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  bf16* Vs = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  float* Ss = reinterpret_cast<float*>(p); p += L::s_bytes;
  float* dPs = reinterpret_cast<float*>(p); p += L::s_bytes;
  bf16* dSs = reinterpret_cast<bf16*>(p);  p += L::p_bytes;
  float* Acc = reinterpret_cast<float*>(p); p += L::acc_bytes;
  float* lse_s = reinterpret_cast<float*>(p);
  float* dsum_s = lse_s + BQ;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_causal = causal != 0;

  load_tile<D>(Qs, L::LDT, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<D>(dOs, L::LDT, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += THREADS) Acc[i] = 0.f;
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const long long at = ((long long)b * Hq + h) * Sq + row;
    lse_s[threadIdx.x] = row < Sq ? lse[at] : 0.f;
    dsum_s[threadIdx.x] = row < Sq ? dsum[at] : 0.f;
  }
  __syncthreads();

  // kv tiles the block's valid query rows can see (the forward's bounds)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int lo, hi;
  mtt::live_tile_range(BK, (Skv + BK - 1) / BK, q0 + delta, q_last + delta,
                       is_causal, window, &lo, &hi);

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const int row0 = warp * 16;
  for (int ki = lo; ki < hi; ++ki) {
    const int k0 = ki * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, L::LDT, kb, ks.s, k0, Skv);
    load_tile<D>(Vs, L::LDT, vb, vs.s, k0, Skv);
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows x 64 kv columns
    warp_abt<D>(Ss + row0 * L::LDS, Qs + row0 * L::LDT, Ks);
    warp_abt<D>(dPs + row0 * L::LDS, dOs + row0 * L::LDT, Vs);
    __syncwarp();

    // ds = p (dp - dsum), p = exp(s scale - lse) where visible, else 0
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const bool row_ok = q0 + r < Sq;
      const int q_pos = q0 + r + delta;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        const int k_pos = k0 + j;
        const bool vis = row_ok && k_pos < Skv &&
                         mtt::visible(q_pos, k_pos, is_causal, window);
        const float pr =
            vis ? __expf(Ss[r * L::LDS + j] * scale - lse_s[r]) : 0.f;
        dSs[r * L::LDP + j] =
            __float2bfloat16(pr * (dPs[r * L::LDS + j] - dsum_s[r]));
      }
    }
    __syncwarp();

    // dQ += dS K  (the scale is applied once, at the end)
    warp_acc_ab<D>(Acc + row0 * L::LDA, dSs + row0 * L::LDP, Ks);
    __syncwarp();
  }

  emit_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, Acc, row0, q0, Sq, scale,
               lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Skv, int Hq, int Hkv, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         float scale, int causal, int window, int delta) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* Ks = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  bf16* Vs = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(p);   p += L::tile_bytes;
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += L::tile_bytes;
  float* St = reinterpret_cast<float*>(p); p += L::s_bytes;
  float* dPt = reinterpret_cast<float*>(p); p += L::s_bytes;
  bf16* Pt = reinterpret_cast<bf16*>(p);   p += L::p_bytes;
  bf16* dSt = reinterpret_cast<bf16*>(p);  p += L::p_bytes;
  float* AccK = reinterpret_cast<float*>(p); p += L::acc_bytes;
  float* AccV = reinterpret_cast<float*>(p); p += L::acc_bytes;
  float* lse_s = reinterpret_cast<float*>(p);
  float* dsum_s = lse_s + BQ;

  const int kvi = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int k0 = kvi * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_causal = causal != 0;

  load_tile<D>(Ks, L::LDT, k + b * ks.b + hk * ks.h, ks.s, k0, Skv);
  load_tile<D>(Vs, L::LDT, v + b * vs.b + hk * vs.h, vs.s, k0, Skv);
  for (int i = threadIdx.x; i < BK * L::LDA; i += THREADS) {
    AccK[i] = 0.f;
    AccV[i] = 0.f;
  }

  // q tiles whose valid rows can see any of the block's valid kv columns
  const int k_last = min(k0 + BK, Skv) - 1;
  int lo, hi;
  mtt::live_q_tile_range(BQ, (Sq + BQ - 1) / BQ, k0, k_last, is_causal,
                         window, delta, &lo, &hi);
  __syncthreads();  // K/V tiles and zeroed accumulators visible to all

  const int row0 = warp * 16;  // this warp's 16 kv rows
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* dob = dout + b * dos.b + h * dos.h;
    const long long stat0 = ((long long)b * Hq + h) * Sq;
    for (int qi = lo; qi < hi; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D>(Qs, L::LDT, qb, qs.s, q0, Sq);
      load_tile<D>(dOs, L::LDT, dob, dos.s, q0, Sq);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lse[stat0 + row] : 0.f;
        dsum_s[threadIdx.x] = row < Sq ? dsum[stat0 + row] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for this warp's 16 kv rows x 64 q cols
      warp_abt<D>(St + row0 * L::LDS, Ks + row0 * L::LDT, Qs);
      warp_abt<D>(dPt + row0 * L::LDS, Vs + row0 * L::LDT, dOs);
      __syncwarp();

      for (int rr = 0; rr < 16; ++rr) {
        const int r = row0 + rr;
        const int k_pos = k0 + r;
        const bool col_ok = k_pos < Skv;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = lane + 32 * c;
          const int qrow = q0 + j;
          const bool vis = col_ok && qrow < Sq &&
                           mtt::visible(qrow + delta, k_pos, is_causal,
                                        window);
          const float pr =
              vis ? __expf(St[r * L::LDS + j] * scale - lse_s[j]) : 0.f;
          Pt[r * L::LDP + j] = __float2bfloat16(pr);
          dSt[r * L::LDP + j] =
              __float2bfloat16(pr * (dPt[r * L::LDS + j] - dsum_s[j]));
        }
      }
      __syncwarp();

      // dV += Pᵀ dO,  dK += dSᵀ Q  (dK's scale is applied at the end)
      warp_acc_ab<D>(AccV + row0 * L::LDA, Pt + row0 * L::LDP, dOs);
      warp_acc_ab<D>(AccK + row0 * L::LDA, dSt + row0 * L::LDP, Qs);
      __syncwarp();
    }
  }

  emit_rows<D>(dk + b * dks.b + hk * dks.h, dks.s, AccK, row0, k0, Skv,
               scale, lane);
  emit_rows<D>(dv + b * dvs.b + hk * dvs.h, dvs.s, AccV, row0, k0, Skv, 1.f,
               lane);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, int window,
                      int delta, cudaStream_t stream) {
  constexpr size_t bytes = BwdSmem<D>::dq_total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, qs, ks, vs, dos, dqs, scale,
      causal, window, delta);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                       int Hkv, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale,
                       int causal, int window, int delta,
                       cudaStream_t stream) {
  constexpr size_t bytes = BwdSmem<D>::dkv_total;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv, qs,
      ks, vs, dos, dks, dvs, scale, causal, window, delta);
  return cudaGetLastError();
}

bool bad_geometry(int B, int Sq, int Skv, int Hq, int Hkv) {
  return B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv;
}

}  // namespace

// Plain C entries for ctypes. Strides are in elements, (batch, seq, head)
// for each [B, S, H, D] tensor; the head dim must be contiguous. lse and
// dsum are contiguous [B, Hq, Sq] fp32. window <= 0 means no sliding
// window. Each returns the cudaError_t of its launch.
extern "C" int mtt_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, int causal, int window, int delta, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (bad_geometry(B, Sq, Skv, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh},
      dqs{dq_sb, dq_ss, dq_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, Hq,
                               Hkv, qs, ks, vs, dos, dqs, scale, causal,
                               window, delta, st);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, Hq,
                              Hkv, qs, ks, vs, dos, dqs, scale, causal,
                              window, delta, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mtt_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int delta, void* stream) {
  cudaGetLastError();
  if (bad_geometry(B, Sq, Skv, Hq, Hkv)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh},
      dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv,
                                Hq, Hkv, qs, ks, vs, dos, dks, dvs, scale,
                                causal, window, delta, st);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv,
                               Hq, Hkv, qs, ks, vs, dos, dks, dvs, scale,
                               causal, window, delta, st);
  return (int)cudaErrorInvalidValue;
}
