// flash_bwd_dq: the dq kernel of the FlashAttention-2 recompute backward
// for Hopper (sm_90a), bf16 in/out. Replaces
// megatron_tpu/ops/pallas/flash_template.py _dq_kernel (launched by _bwd,
// :288). Its partner, the dk/dv kernel, is flash_bwd_dkv.cu.
//
// It recomputes p = exp(q·kᵀ·scale − lse) from the forward's lse instead
// of storing the [S, S] probabilities, then
//   dp = do·vᵀ,  ds = p·(dp − dsum)  with dsum = rowsum(do·o) per query row,
//   dq = scale·Σ_k ds·k.
// Masking is the forward's: causal / bidirectional, sliding window, and a
// runtime q-vs-k position offset `delta`; p is 0 wherever `visible` is
// false (never exp of a huge number), so fully masked rows give zero
// gradients. Plain version: ops/flash/flash_template.py
// flash_bwd_reference.
//
// What bounds it: at Llama-2-7B widths (H=32, D=128, S=4096 causal) it is
// operation-bound: 3 products of 2·D FLOPs per visible (q, k) pair (6·D)
// against ~2·D bytes per row of each operand, far above the card's ~295
// FLOP/byte ridge (4 products with the split of ds below). So every
// product is a wgmma with its accumulator in registers, and the K/V tiles
// stream in by TMA while the tensor cores work. It is the dq counterpart
// of flash_bwd_dkv.cu: the same header (sm90.cuh), layout rule and ring.
//
// Design, against the TPU kernel:
//  * Pallas ran a sequential kv grid axis carrying dq in VMEM scratch.
//    Here one block owns (batch, q head, 128-row q tile) and loops over
//    its live kv tiles (masks.cuh live_tile_range, the forward's bounds),
//    reading K/V at kv head h / G. blockIdx.z runs the q tiles backwards,
//    so under a causal mask the tiles that see the most kv tiles start
//    first (the mirror of the dk/dv kernel's order).
//  * Warp specialisation: warpgroups 0 and 1 each own 64 of the q rows and
//    run the math (setmaxnreg 240); one thread of warpgroup 2 (setmaxnreg
//    24) loads Q and dO once and streams 64-row K and V tiles through a
//    2-stage TMA ring (full / empty mbarriers). Each consumer thread reads
//    the lse·log2 e and dsum of its two rows into registers once.
//  * Per kv tile, each a wgmma with its accumulator in registers:
//    S = Q·Kᵀ and dP = dO·Vᵀ (m64n64k16, all operands K-major in shared
//    memory); p = exp2(S·scale·log2 e − lse·log2 e) and dS = p·(dP − dsum)
//    in registers, masked only on tiles that masks.cuh tile_class does
//    not call FULL; then dQ += dS·K with dS packed to bf16 pairs in place
//    as the register A operand and K as the MN-major B operand (transpose
//    flag), exactly as dK += dSᵀ·Q in the dk/dv kernel.
//  * dS is split into a bf16 high part and the bf16 rounding of what is
//    left (dS − hi), and both go through the tensor cores against the same
//    K tile. One bf16 rounding of ds (relative 2^-9) summed over thousands
//    of keys left dq outside the JAX package's backward gate on some
//    inputs; the split cuts it to about 2^-17, for a fourth product per
//    tile.
//  * dQ stays in fp32 registers for the whole loop (64 a thread at D 128):
//    no atomics and no separate dq pass. The scale multiplies it once at
//    the end; scale·dQ leaves as bf16 through the warpgroup's own Q rows in
//    shared memory, in 16-byte stores.
//  * q/k/v/do/dq in the framework layout [B, S, H, D] through strides
//    (4-d tensor maps {D, H, S, B}); lse and dsum as plain [B, Hq, Sq]
//    fp32. Any S >= 1: TMA fills rows past Sq/Skv with zeros, the mask
//    removes kv columns past Skv, and q rows past Sq are not written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;  // q rows per block: 2 consumer warpgroups x 64
constexpr int BK = 64;   // kv rows per ring stage
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan (byte offsets from a 1024-aligned base); tiles as in
// sm90.cuh: D / 64 column blocks of rows x 128 bytes.
template <int D>
struct DqSmem {
  static constexpr int CB = D / 64;
  static constexpr uint32_t q_bytes = BQ * D * 2;   // Q or dO
  static constexpr uint32_t kv_bytes = BK * D * 2;  // one K or V tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_bytes;
  static constexpr uint32_t k_off = 2 * q_bytes;  // + stage * kv_bytes
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  // mbarriers: q_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  static constexpr uint32_t total = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

// the two floats of a bf16 pair packed by sm90::pack_bf16
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        bf16* __restrict__ dq, int Sq, int Skv, int Hq,
                        int Hkv, long long dq_sb, long long dq_ss,
                        long long dq_sh, float scale, int causal, int window,
                        int delta) {
  using L = DqSmem<D>;
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
      sm90::mbar_arrive_expect_tx(q_full, 2 * L::q_bytes);
      for (int cb = 0; cb < L::CB; ++cb) {
        sm90::tma_load_4d(base + L::q_off + cb * BQ * 128, &tq, q_full,
                          cb * 64, h, q0, b);
        sm90::tma_load_4d(base + L::do_off + cb * BQ * 128, &tdo, q_full,
                          cb * 64, h, q0, b);
      }
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
    const int qrow = q0 + 64 * wg + r0;  // row r0 (query index)
    const uint32_t q_wg = base + L::q_off + wg * 64 * 128;
    const uint32_t do_wg = base + L::do_off + wg * 64 * 128;

    // this thread's two rows' lse·log2 e and dsum (0 past Sq)
    float l2[2], dsr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      const long long at = ((long long)b * Hq + h) * Sq + row;
      l2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
      dsr[r] = row < Sq ? dsum[at] : 0.f;
    }

    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    if (n > 0) sm90::mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int k0 = (lo + i) * BK;
      sm90::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const uint32_t k_s = base + L::k_off + s * L::kv_bytes;
      const uint32_t v_s = base + L::v_off + s * L::kv_bytes;

      // S = Q Kᵀ and dP = dO Vᵀ: 64 q rows x BK kv columns, k = D
      float sc[BK / 2], dp[BK / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BK>::ss(
            sc, sm90::desc_kmajor(q_wg + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            sm90::desc_kmajor(k_s + (kk / 4) * BK * 128 + (kk % 4) * 32),
            kk > 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BK>::ss(
            dp,
            sm90::desc_kmajor(do_wg + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            sm90::desc_kmajor(v_s + (kk / 4) * BK * 128 + (kk % 4) * 32),
            kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // dS as the A operand of dQ += dS K: k step kk covers kv columns
      // [16 kk, +16); hi is dS rounded to bf16, lo the rounding of the rest
      const bool full_tile =
          mtt::tile_class(q0, BQ, k0, BK, Sq, Skv, is_causal, window,
                          delta) == mtt::TILE_FULL;
      uint32_t sa[BK / 16][4], sl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(sc[4 * j + e], sl2, -l2[e >> 1]));
          if (!full_tile) {
            const int col = k0 + 8 * j + c0 + (e & 1);
            if (!(col < Skv && mtt::visible(qrow + 8 * (e >> 1) + delta, col,
                                            is_causal, window)))
              p = 0.f;
          }
          d[e] = p * (dp[4 * j + e] - dsr[e >> 1]);
        }
        const uint32_t h01 = sm90::pack_bf16(d[0], d[1]);
        const uint32_t h23 = sm90::pack_bf16(d[2], d[3]);
        sa[j / 2][2 * (j % 2)] = h01;
        sa[j / 2][2 * (j % 2) + 1] = h23;
        const float2 f01 = unpack_bf16(h01), f23 = unpack_bf16(h23);
        sl[j / 2][2 * (j % 2)] = sm90::pack_bf16(d[0] - f01.x, d[1] - f01.y);
        sl[j / 2][2 * (j % 2) + 1] =
            sm90::pack_bf16(d[2] - f23.x, d[3] - f23.y);
      }

      // dQ += dS K: k = BK in steps of 16 kv rows, K as the MN-major B
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Wgmma<D>::rs(dqa, sa[kk],
                           sm90::desc_mnmajor(k_s + kk * 16 * 128, BK * 128));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Wgmma<D>::rs(dqa, sl[kk],
                           sm90::desc_mnmajor(k_s + kk * 16 * 128, BK * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqa);
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    }

    // ---- epilogue: scale·dQ through the warpgroup's Q rows ----
    sm90::fence_proxy_async();
    unsigned char* q_tile = sbase + L::q_off;
    sm90::stage_rows<D>(q_tile, BQ, 64 * wg, dqa, scale, scale);
    sm90::named_barrier_sync(1 + wg, 128);
    sm90::copy_rows_out<D>(q_tile, BQ, 64 * wg, dq + b * dq_sb + h * dq_sh,
                           dq_ss, q0 + 64 * wg, Sq);
  }
}

struct Strides {
  long long b, s, h;
};

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, int window,
                      int delta, cudaStream_t stream, int* map_error) {
  using L = DqSmem<D>;
  CUtensorMap mq, mk, mv, mdo;
  *map_error =
      sm90::make_tile_map(&mq, q, D, Hq, Sq, B, qs.b, qs.s, qs.h, BQ);
  if (!*map_error)
    *map_error =
        sm90::make_tile_map(&mdo, dout, D, Hq, Sq, B, dos.b, dos.s, dos.h, BQ);
  if (!*map_error)
    *map_error =
        sm90::make_tile_map(&mk, k, D, Hkv, Skv, B, ks.b, ks.s, ks.h, BK);
  if (!*map_error)
    *map_error =
        sm90::make_tile_map(&mv, v, D, Hkv, Skv, B, vs.b, vs.s, vs.h, BK);
  if (*map_error) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, THREADS, L::total, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dq), Sq, Skv, Hq,
      Hkv, dqs.b, dqs.s, dqs.h, scale, causal, window, delta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Strides are in elements, (batch, seq, head)
// for each [B, S, H, D] tensor; the head dim must be contiguous and the
// other strides multiples of 8 elements (TMA's 16-byte rule). lse and dsum
// are contiguous [B, Hq, Sq] fp32. window <= 0 means no sliding window.
// Returns the cudaError_t of the launch, or sm90::kTensorMapError + the
// CUresult when a tensor map cannot be built.
extern "C" int mtt_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, int causal, int window, int delta, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh},
      dqs{dq_sb, dq_ss, dq_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int map_error = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128)
    err = launch_dq<128>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, Hq, Hkv, qs,
                         ks, vs, dos, dqs, scale, causal, window, delta, s,
                         &map_error);
  else if (D == 64)
    err = launch_dq<64>(q, k, v, dout, lse, dsum, dq, B, Sq, Skv, Hq, Hkv, qs,
                        ks, vs, dos, dqs, scale, causal, window, delta, s,
                        &map_error);
  return map_error ? map_error : (int)err;
}
