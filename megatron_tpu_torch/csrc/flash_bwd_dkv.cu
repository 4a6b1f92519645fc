// flash_bwd_dkv: the dk/dv kernel of the FlashAttention-2 recompute
// backward for Hopper (sm_90a), bf16 in/out. Replaces
// megatron_tpu/ops/pallas/flash_template.py _dkv_kernel (launched by _bwd,
// :313). Its partner, the dq kernel, is flash_bwd_dq.cu.
//
// It recomputes pᵀ = exp(k·qᵀ·scale − lse) from the forward's lse instead
// of storing the [S, S] probabilities, then
//   dpᵀ = v·doᵀ,  dsᵀ = pᵀ·(dpᵀ − dsum)  with dsum = rowsum(do·o) per query,
//   dv = Σ_q pᵀ·do,  dk = scale·Σ_q dsᵀ·q,
// summed over the G query heads of each kv head. Masking is the
// forward's: causal / bidirectional, sliding window, and a runtime q-vs-k
// position offset `delta`; pᵀ is 0 wherever `visible` is false (never exp
// of a huge number), so a kv row no query sees gets zero gradients. Plain
// version: ops/flash/flash_template.py flash_bwd_reference.
//
// What bounds it: at Llama-2-7B widths (H=32, D=128, S=4096 causal) it is
// operation-bound: 4 products of 2·D FLOPs per visible (q, k) pair (8·D)
// against ~2·D bytes per row of each operand. So every product is a
// wgmma with its accumulator in registers, and the Q/dO tiles stream in by
// TMA while the tensor cores work.
//
// Design, against the TPU kernel:
//  * Pallas ran a sequential grid axis carrying dk/dv in VMEM scratch.
//    Here one block owns (batch, kv head, 128-row kv tile) and loops over
//    the G query heads of its kv head x its live q tiles (masks.cuh
//    live_q_tile_range, the inverse of the forward's range). blockIdx.z
//    runs the kv tiles forwards, so under a causal mask the tiles that see
//    the most q tiles start first.
//  * Warp specialisation: warpgroups 0 and 1 each own 64 of the kv rows
//    and run the math (setmaxnreg 240); one warp of warpgroup 2
//    (setmaxnreg 24) loads K and V once and Q, dO (64-row tiles) through a
//    2-stage TMA ring, copying each tile's lse·log2 e and dsum into the
//    stage beside them.
//  * Per q tile, each a wgmma with its accumulator in registers:
//    Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n64k16, all operands K-major in shared
//    memory); pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e) and
//    dSᵀ = pᵀ·(dPᵀ − dsum) in registers, masked only on tiles that
//    masks.cuh tile_class does not call FULL; then dV += Pᵀ·dO and
//    dK += dSᵀ·Q with Pᵀ and dSᵀ packed to bf16 register A operands and
//    dO, Q as MN-major B operands (transpose flag).
//  * dK and dV stay in fp32 registers across the whole loop, the GQA group
//    sum included: no atomics and no repeated K/V (the TPU launch repeated
//    K/V per query head and group-summed in the repeat's vjp), so the sum
//    is deterministic.
//  * The TPU kernel pre-scaled q in fp32 before its dk product; here q
//    stays bf16 for the tensor cores and the scale multiplies the fp32 dK
//    accumulator at the end. pᵀ and dsᵀ are rounded to bf16 for the
//    tensor-core products (the TPU kernel keeps them fp32).
//  * q/k/v/do/dk/dv in the framework layout [B, S, H, D] through strides
//    (4-d tensor maps {D, H, S, B}); lse and dsum as plain [B, Hq, Sq]
//    fp32. Any S >= 1: TMA fills rows past Sq/Skv with zeros, the mask
//    removes q columns past Sq, and kv rows past Skv are not written. The
//    epilogue goes through shared memory (the warpgroup's own K and V
//    rows) in 16-byte stores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 128;  // kv rows per block: 2 consumer warpgroups x 64
constexpr int BQ = 64;   // q rows per ring stage
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan (byte offsets from a 1024-aligned base); tiles as in
// sm90.cuh: D / 64 column blocks of rows x 128 bytes.
template <int D>
struct DkvSmem {
  static constexpr int CB = D / 64;
  static constexpr uint32_t kv_bytes = BK * D * 2;  // K or V
  static constexpr uint32_t q_bytes = BQ * D * 2;   // one Q or dO tile
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = kv_bytes;
  static constexpr uint32_t q_off = 2 * kv_bytes;  // + stage * q_bytes
  static constexpr uint32_t do_off = q_off + STAGES * q_bytes;
  // per stage: lse·log2 e [BQ] then dsum [BQ], fp32
  static constexpr uint32_t stat_off = do_off + STAGES * q_bytes;
  static constexpr uint32_t stat_bytes = 2 * BQ * 4;
  // mbarriers: kv_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t bar_off = stat_off + STAGES * stat_bytes;
  static constexpr uint32_t total = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Skv, int Hq, int Hkv, long long dk_sb,
                         long long dk_ss, long long dk_sh, long long dv_sb,
                         long long dv_ss, long long dv_sh, float scale,
                         int causal, int window, int delta) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::bar_off;
  const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 * (1 + STAGES);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int G = Hq / Hkv;
  const bool is_causal = causal != 0;
  int lo, hi;
  mtt::live_q_tile_range(BQ, (Sq + BQ - 1) / BQ, k0, min(k0 + BK, Skv) - 1,
                         is_causal, window, delta, &lo, &hi);
  const int per_head = hi > lo ? hi - lo : 0;
  const int n = G * per_head;  // (query head, q tile) items, head-major

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full0 + 8 * s, 32);  // every lane of the producer warp
      sm90::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // ---- producer: warp 8 loads; lane 0 issues the TMA ----
    sm90::reg_dealloc<24>();
    if (threadIdx.x / 32 == 8 && n > 0) {
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(kv_full, 2 * L::kv_bytes);
        for (int cb = 0; cb < L::CB; ++cb) {
          sm90::tma_load_4d(base + L::k_off + cb * BK * 128, &tk, kv_full,
                            cb * 64, hk, k0, b);
          sm90::tma_load_4d(base + L::v_off + cb * BK * 128, &tv, kv_full,
                            cb * 64, hk, k0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int h = hk * G + i / per_head;
        const int q0 = (lo + i % per_head) * BQ;
        if (i >= STAGES)
          sm90::mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* stat =
            reinterpret_cast<float*>(sbase + L::stat_off + s * L::stat_bytes);
        const long long at = ((long long)b * Hq + h) * Sq;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < Sq;
          stat[r] = ok ? lse[at + q0 + r] * LOG2E : 0.f;
          stat[BQ + r] = ok ? dsum[at + q0 + r] : 0.f;
        }
        const uint32_t full = full0 + 8 * s;
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(full, 2 * L::q_bytes);
          for (int cb = 0; cb < L::CB; ++cb) {
            sm90::tma_load_4d(base + L::q_off + s * L::q_bytes + cb * BQ * 128,
                              &tq, full, cb * 64, h, q0, b);
            sm90::tma_load_4d(
                base + L::do_off + s * L::q_bytes + cb * BQ * 128, &tdo,
                full, cb * 64, h, q0, b);
          }
        } else {
          sm90::mbar_arrive(full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns kv rows [k0 + 64 wg, + 64) ----
    sm90::reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);            // columns 8 j + c0 and + 1
    const float sl2 = scale * LOG2E;
    const int kpos = k0 + 64 * wg + r0;  // position of row r0
    const uint32_t k_wg = base + L::k_off + wg * 64 * 128;
    const uint32_t v_wg = base + L::v_off + wg * 64 * 128;

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    if (n > 0) sm90::mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int q0 = (lo + i % per_head) * BQ;
      sm90::mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
      const uint32_t q_s = base + L::q_off + s * L::q_bytes;
      const uint32_t do_s = base + L::do_off + s * L::q_bytes;

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 64 kv rows x BQ q columns, k = D
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BQ>::ss(
            st, sm90::desc_kmajor(k_wg + (kk / 4) * BK * 128 + (kk % 4) * 32),
            sm90::desc_kmajor(q_s + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            kk > 0);
      sm90::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::Wgmma<BQ>::ss(
            dpt,
            sm90::desc_kmajor(v_wg + (kk / 4) * BK * 128 + (kk % 4) * 32),
            sm90::desc_kmajor(do_s + (kk / 4) * BQ * 128 + (kk % 4) * 32),
            kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // Pᵀ and dSᵀ as the A operands of the gradient products: k step kk
      // covers q columns [16 kk, +16)
      const float* stat = reinterpret_cast<const float*>(
          sbase + L::stat_off + s * L::stat_bytes);
      const bool full_tile =
          mtt::tile_class(q0, BQ, k0, BK, Sq, Skv, is_causal, window,
                          delta) == mtt::TILE_FULL;
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = 8 * j + c0;
        const float2 l2 = *reinterpret_cast<const float2*>(stat + c);
        const float2 ds = *reinterpret_cast<const float2*>(stat + BQ + c);
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(fmaf(st[4 * j + e], sl2, (e & 1) ? -l2.y : -l2.x));
          if (!full_tile) {
            const int qrow = q0 + c + (e & 1);
            if (!(qrow < Sq && mtt::visible(qrow + delta, kpos + 8 * (e >> 1),
                                            is_causal, window)))
              p[e] = 0.f;
          }
          d[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? ds.y : ds.x));
        }
        pa[j / 2][2 * (j % 2)] = sm90::pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(p[2], p[3]);
        sa[j / 2][2 * (j % 2)] = sm90::pack_bf16(d[0], d[1]);
        sa[j / 2][2 * (j % 2) + 1] = sm90::pack_bf16(d[2], d[3]);
      }

      // dV += Pᵀ dO and dK += dSᵀ Q: k = BQ in steps of 16 q rows
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        sm90::Wgmma<D>::rs(dva, pa[kk],
                           sm90::desc_mnmajor(do_s + kk * 16 * 128, BQ * 128));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        sm90::Wgmma<D>::rs(dka, sa[kk],
                           sm90::desc_mnmajor(q_s + kk * 16 * 128, BQ * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
      if (lane == 0) sm90::mbar_arrive(empty0 + 8 * s);
    }

    // ---- epilogue: dK·scale and dV through the warpgroup's K/V rows ----
    sm90::fence_proxy_async();
    unsigned char* k_tile = sbase + L::k_off;
    unsigned char* v_tile = sbase + L::v_off;
    sm90::stage_rows<D>(k_tile, BK, 64 * wg, dka, scale, scale);
    sm90::stage_rows<D>(v_tile, BK, 64 * wg, dva, 1.f, 1.f);
    sm90::named_barrier_sync(1 + wg, 128);
    sm90::copy_rows_out<D>(k_tile, BK, 64 * wg, dk + b * dk_sb + hk * dk_sh,
                           dk_ss, k0 + 64 * wg, Skv);
    sm90::copy_rows_out<D>(v_tile, BK, 64 * wg, dv + b * dv_sb + hk * dv_sh,
                           dv_ss, k0 + 64 * wg, Skv);
  }
}

struct Strides {
  long long b, s, h;
};

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                       int Hkv, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale,
                       int causal, int window, int delta, cudaStream_t stream,
                       int* map_error) {
  using L = DkvSmem<D>;
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
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::total);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (Skv + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, L::total, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv, dks.b, dks.s, dks.h, dvs.b,
      dvs.s, dvs.h, scale, causal, window, delta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Strides are in elements, (batch, seq, head)
// for each [B, S, H, D] tensor; the head dim must be contiguous and the
// other strides multiples of 8 elements (TMA's 16-byte rule). lse and dsum
// are contiguous [B, Hq, Sq] fp32. window <= 0 means no sliding window.
// Returns the cudaError_t of the launch, or sm90::kTensorMapError + the
// CUresult when a tensor map cannot be built.
extern "C" int mtt_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int delta, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, dos{do_sb, do_ss, do_sh},
      dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int map_error = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 128)
    err = launch_dkv<128>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, Hq,
                          Hkv, qs, ks, vs, dos, dks, dvs, scale, causal,
                          window, delta, st, &map_error);
  else if (D == 64)
    err = launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, B, Sq, Skv, Hq,
                         Hkv, qs, ks, vs, dos, dks, dvs, scale, causal,
                         window, delta, st, &map_error);
  return map_error ? map_error : (int)err;
}
