// flash_fwd: FlashAttention-2 forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernel megatron_tpu/ops/pallas/flash_template.py
// _fwd_kernel (launched by _fwd): causal / bidirectional masking, sliding
// window, a runtime q-vs-k position offset `delta`, online softmax with
// fp32 m/l/acc, and the lse side output. Plain version:
// ops/flash/flash_template.py flash_fwd_reference.
//
// What bounds it: at Llama-2-7B widths (H=32, D=128, S 2047 to 4096) it is
// operation-bound: 4*D FLOPs per visible (q, k) pair against 2*D bytes per
// row of q/k/v/o, far above the card's ~295 FLOP/byte ridge. So both
// products run as wgmma (the only instruction that reaches the tensor
// cores' full rate), every intermediate stays in registers, and the loads
// run on the TMA while the tensor cores work.
//
// Design, against the TPU kernel:
//  * The Pallas grid walked kv tiles sequentially with m/l/acc in VMEM
//    scratch; here one block owns (batch, q head, 128-row q tile) and
//    loops over its live kv tiles [lo, hi) (masks.cuh live_tile_range):
//    dead tiles are never loaded. blockIdx.z runs the q tiles backwards,
//    so under a causal mask the tiles with the most kv tiles start first.
//  * Warp specialisation: warpgroups 0 and 1 each own 64 of the q rows and
//    run the math (setmaxnreg 240); one warp of warpgroup 2 (setmaxnreg
//    24) loads Q once and K/V through a 2-stage ring by TMA, each stage
//    with a full and an empty mbarrier, so the next tile's loads overlap
//    this tile's products.
//  * S = Q·Kᵀ is a wgmma m64n128k16 with both operands K-major in shared
//    memory; the accumulator stays in registers. Each thread holds two
//    rows of S, so the row max and row sum are two 4-lane shuffles; the
//    softmax runs in the log2 domain (exp2f, scale·log2 e folded in).
//  * O += P·V is a wgmma with P as the register A operand (the fp32 S
//    accumulator packed to bf16 pairs: its layout is the A fragment's)
//    and V an MN-major B operand (transpose flag). O lives in registers
//    for the whole loop; the alpha rescale is a register multiply.
//  * Only tiles that masks.cuh tile_class does not call FULL (the causal
//    diagonal, the window's lower edge, the ragged last kv tile) test each
//    element, in registers, by (row, column) from the accumulator layout.
//    Masked scores become -inf, so p = 0 there with no extra select.
//  * GQA reads K/V at kv head h / G through the tensor maps; q/k/v/o are
//    the framework layout [B, S, H, D] through strides (4-d tensor maps
//    {D, H, S, B}); TMA fills rows past Sq/Skv with zeros (the column mask
//    still removes them: a zero row scores 0, not -inf).
//  * The finite NEG_INF and l clamped at 1e-30 as in the TPU kernel: a
//    fully masked row emits o = 0 and lse = NEG_INF. lse is written as
//    plain [B, H, S] fp32 (the TPU kernel lane-padded it to 128). o goes
//    out through shared memory (the warpgroup's own Q rows) in 16-byte
//    stores; rows >= Sq are never written.
//  * P is rounded to bf16 for the tensor-core P·V product (the TPU kernel
//    keeps p in fp32); l is summed from the fp32 p.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;  // q rows per block: 2 consumer warpgroups x 64
constexpr int BK = 128;  // kv rows per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory plan (byte offsets from a 1024-aligned base); tiles as in
// sm90.cuh: D / 64 column blocks of rows x 128 bytes.
template <int D>
struct FwdSmem {
  static constexpr int CB = D / 64;
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t kv_bytes = BK * D * 2;  // one K or V tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_bytes;  // + stage * kv_bytes
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  // mbarriers: q_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  static constexpr uint32_t total = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Skv, int Hq, int Hkv, long long o_sb, long long o_ss,
                     long long o_sh, float scale, int causal, int window,
                     int delta) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t q_full = base + L::bar_off;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + STAGES);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (Hq / Hkv);
  const bool is_causal = causal != 0;
  int lo, hi;
  mtt::live_tile_range(BK, (Skv + BK - 1) / BK, q0 + delta,
                       min(q0 + BQ, Sq) - 1 + delta, is_causal, window, &lo,
                       &hi);
  const int n = hi > lo ? hi - lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256 && n > 0) {
      sm90::mbar_arrive_expect_tx(q_full, L::q_bytes);
      for (int cb = 0; cb < L::CB; ++cb)
        sm90::tma_load_4d(base + L::q_off + cb * BQ * 128, &tq, q_full,
                          cb * 64, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)
          sm90::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        const int k0 = (lo + i) * BK;
        const uint32_t full = full0 + 8 * s;
        sm90::mbar_arrive_expect_tx(full, 2 * L::kv_bytes);
        for (int cb = 0; cb < L::CB; ++cb) {
          sm90::tma_load_4d(base + L::k_off + s * L::kv_bytes + cb * BK * 128,
                            &tk, full, cb * 64, hk, k0, b);
          sm90::tma_load_4d(base + L::v_off + s * L::kv_bytes + cb * BK * 128,
                            &tv, full, cb * 64, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows [q0 + 64 wg, + 64) ----
    sm90::reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);            // columns 8 j + c0 and + 1
    const float sl2 = scale * LOG2E;
    const int qpos = q0 + 64 * wg + r0 + delta;  // position of row r0
    const uint32_t q_wg = base + L::q_off + wg * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {mtt::NEG_INF, mtt::NEG_INF}, l[2] = {0.f, 0.f};

    if (n > 0) sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int k0 = (lo + i) * BK;
      sm90::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const uint32_t k_s = base + L::k_off + s * L::kv_bytes;
      const uint32_t v_s = base + L::v_off + s * L::kv_bytes;

      // S = Q Kᵀ: 64 rows x BK columns, k = D in steps of 16
      float sc[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BK>::ss(
            sc,
            sm90::desc_kmajor(q_wg + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            sm90::desc_kmajor(k_s + (kk / 4) * BK * 128 + (kk % 4) * 32),
            kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      if (mtt::tile_class(q0, BQ, k0, BK, Sq, Skv, is_causal, window,
                          delta) != mtt::TILE_FULL) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + c0 + (e & 1);
            if (!(col < Skv && mtt::visible(qpos + 8 * (e >> 1), col,
                                            is_causal, window)))
              sc[4 * j + e] = -INFINITY;
          }
      }

      // online softmax in the log2 domain; m is max(s) * scale * log2 e
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      // P as the A operand of P·V: k step kk covers columns [16 kk, +16)
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = exp2f(fmaf(sc[4 * j], sl2, -m[0]));
        const float p1 = exp2f(fmaf(sc[4 * j + 1], sl2, -m[0]));
        const float p2 = exp2f(fmaf(sc[4 * j + 2], sl2, -m[1]));
        const float p3 = exp2f(fmaf(sc[4 * j + 3], sl2, -m[1]));
        ps[0] += p0 + p1;
        ps[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = sm90::pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(p2, p3);
      }
      // l is this thread's partial row sum; the 4 lanes of a row add up
      // at the end
      l[0] = l[0] * alpha[0] + ps[0];
      l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }

      // O += P V: k = BK in steps of 16 rows of V
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Wgmma<D>::rs(acc, pa[kk],
                           sm90::desc_mnmajor(v_s + kk * 16 * 128, BK * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    }

    // ---- epilogue: o = acc / l through the warpgroup's Q rows; lse ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lc = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / lc;
      const int row = q0 + 64 * wg + r0 + 8 * r;
      if (lane % 4 == 0 && row < Sq)
        lse[((long long)b * Hq + h) * Sq + row] =
            (m[r] == mtt::NEG_INF ? mtt::NEG_INF : m[r] * LN2) + logf(lc);
    }
    sm90::fence_proxy_async();
    unsigned char* q_tile = sbase + L::q_off;
    sm90::stage_rows<D>(q_tile, BQ, 64 * wg, acc, inv[0], inv[1]);
    sm90::named_barrier_sync(1 + wg, 128);
    sm90::copy_rows_out<D>(q_tile, BQ, 64 * wg, o + b * o_sb + h * o_sh,
                           o_ss, q0 + 64 * wg, Sq);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   const long long* qs, const long long* ks,
                   const long long* vs, const long long* os, float scale,
                   int causal, int window, int delta, cudaStream_t stream,
                   int* map_error) {
  using L = FwdSmem<D>;
  CUtensorMap mq, mk, mv;
  *map_error = sm90::make_tile_map(&mq, q, D, Hq, Sq, B, qs[0], qs[1], qs[2],
                                   BQ);
  if (!*map_error)
    *map_error = sm90::make_tile_map(&mk, k, D, Hkv, Skv, B, ks[0], ks[1],
                                     ks[2], BK);
  if (!*map_error)
    *map_error = sm90::make_tile_map(&mv, v, D, Hkv, Skv, B, vs[0], vs[1],
                                     vs[2], BK);
  if (*map_error) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::total);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, THREADS, L::total, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv,
      Hq, Hkv, os[0], os[1], os[2], scale, causal, window, delta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Strides are in elements, (batch, seq, head)
// for each of q, k, v, o; the head dim must be contiguous and the other
// strides multiples of 8 elements (TMA's 16-byte rule). window <= 0 means
// no sliding window. Returns the cudaError_t of the launch, or
// sm90::kTensorMapError + the CUresult when a tensor map cannot be built.
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
  int map_error = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128)
    err = launch<128>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                      scale, causal, window, delta, st, &map_error);
  else if (D == 64)
    err = launch<64>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os,
                     scale, causal, window, delta, st, &map_error);
  return map_error ? map_error : (int)err;
}
