// flash_decode: Sq-small attention over a per-slot KV cache for Hopper
// (sm_90a), bf16 in/out — one decode tick of the continuous-batching
// engine (Sq = 1), and the speculative verify pass (Sq = k + 1). Two
// launches of one kernel body, as in the TPU package:
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
// FLOP per byte at G = 1 and 20 in the Sq-5 GQA-4 verify form, far below
// the card's ~295 FLOP/byte ridge. So the design spreads the bytes over
// every SM, keeps them in flight, and keeps the arithmetic off the
// critical path.
//
// Design, against the TPU kernel:
//  * Split-K. The TPU grid walked a slot's kv blocks in sequence; one
//    block per (slot, kv head) walking a 2048-position prefix leaves most
//    SMs idle while the longest slots finish. Here the grid is
//    (Hkv, B, splits): split s owns a fixed run of split_tiles 64-position
//    tiles of its slot's live range (masks.cuh decode_split_range; the
//    host picks split_tiles from the cache length and B * Hkv alone,
//    masks.py decode_split_tiles, since kv_lengths stay on the device). A
//    split past its slot's live range, or behind its window, exits at
//    once.
//  * In-kernel merge. Each warp writes its unnormalised partial o (fp32
//    [R, D]) with its row max m (log2 units) and sum l to a workspace the
//    wrapper allocates. The last split of a (slot, kv head) to finish, told
//    by an atomic ticket it then resets to 0, merges the partials in split
//    order (deterministic) and writes o. A partial that saw nothing has
//    m = NEG_INF and l = 0 and adds nothing; a row that sees nothing gets
//    o = 0 (l clamped at 1e-30). One launch per call: no second merge
//    kernel on a host-bound tick.
//  * Loads: the K and V tiles are double-buffered with 16-byte cp.async
//    (cp.async.cg, zero-filled past the slot's frontier), so the next
//    tile's bytes are in flight while this tile's math runs. Shared tiles
//    are XOR-swizzled by 16-byte chunk, so ldmatrix reads are
//    conflict-free. Paged: every thread resolves the physical page of each
//    row it loads from the table (one int32 read, shared through L1 by the
//    row's loaders) and addresses it in int64 from the layer's pool
//    pointer; a tile may span several scattered pages (ps < 64) or part of
//    one. ps is a power of two. An entry outside [0, P) reads as the
//    scratch page 0.
//  * Math on the tensor cores: mma.sync m16n8k16 (bf16 in, fp32 out) for
//    S = Q·Kᵀ and O += P·V, with the R = Sq * G query rows of a kv head
//    cut into row tiles of at most 64 (MAX_ROWS) rows, one block each,
//    and a tile's rows padded to M m16 tiles (M = 1, 2, 4 for R <= 16,
//    32, 64; 4 for every tile when R > 64). The 4 warps
//    split each 64-key tile: warp w takes m16 tile w / (4 / M) and 16 M
//    keys, keeps its own S, P and O in registers (P is S's accumulator
//    repacked as the A fragment), and runs its own online softmax in the
//    log2 domain; its partial joins the split merge, so no warp waits on
//    another inside the loop. At R = 1 the padding costs tensor-core
//    cycles, which are not the limit there; at R = 20 (the verify form)
//    the products no longer run on the CUDA cores.
//  * Any number of rows: the grid's x axis is (kv head, row tile), and
//    row tile t of a kv head holds rows [64 t, min(64 t + 64, R)). Every
//    row tile walks its kv head's whole live range (the same split plan,
//    its own partials and ticket), so K and V are read once per row tile:
//    at multi-query shapes (Falcon-7B: G 71, R 71 or 355) that reads a few
//    MB more per layer, against a simpler body.
//  * GQA without replicating K/V: row r is query j = r / G of head
//    h * G + r % G, at position kv_len - 1 + j, seeing k_pos < kv_len + j
//    (and, with a window W, k_pos > its position - W). The cache is read
//    in its stored layout through strides.
//  * Masked scores are -inf before the max (p = 0, never NaN); m starts at
//    the finite NEG_INF as in the TPU kernel. Scratch-page entries (idle
//    rows, pages released behind a window) hold finite values and are
//    masked to p = 0.
//  * The partial form (either launch): with o32 given, o is written in
//    fp32 there instead of bf16, and with lse given, each row's
//    log-sum-exp of its scaled scores, fp32 [B, Hq, Sq] in natural-log
//    units (flash_fwd's convention, which the context-parallel ring
//    merge takes): the merge's running max and sum are in log2 units,
//    so lse = (m + log2 l) * ln 2. A row that sees nothing (kv_len 0:
//    a context-parallel rank that holds no page of the row) has no live
//    split; split 0 of its block then writes o = 0 and lse = NEG_INF
//    (every launch writes o, so the dense and paged forms take kv_len 0
//    too). The partial is one rank's stripe of a row, merged with the
//    other ranks' by inference/context_parallel/ring_kv.py: no new
//    mask, since a stripe's visible keys are a prefix of its local
//    table (the wrapper passes the local length as kv_len).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "masks.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;  // kv positions per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// m16 tiles for R query rows (the wrapper sizes the workspace by the same
// rule: flash_template.decode_plan)
constexpr int m_tiles(int R) { return R <= 16 ? 1 : (R <= 32 ? 2 : 4); }

// Shared-memory plan: Q [16 M rows][D], then K and V [2 stages][BK][D],
// bf16, each row D * 2 bytes with 16-byte chunk g of row r at g ^ (r % 8).
template <int D, int M>
struct DecSmem {
  static constexpr uint32_t q_bytes = 16 * M * D * 2;
  static constexpr uint32_t kv_bytes = BK * D * 2;
  static constexpr uint32_t k_off = q_bytes;  // + stage * kv_bytes
  static constexpr uint32_t v_off = k_off + 2 * kv_bytes;
  static constexpr uint32_t total = v_off + 2 * kv_bytes;
};

template <int D>
__device__ __forceinline__ uint32_t swz(int r, int g) {
  return r * (D * 2) + ((g ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += A · B, m16n8k16, bf16 in, fp32 accumulate. Thread l holds d[0..1]
// at row l / 4, columns 2 (l % 4) and + 1, d[2..3] at row l / 4 + 8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Dense: k/v strides are (slot, position, head). Paged: (page, row in
// page, head), S = max_pages << page_shift, page_table [B, max_pages].
// With T = ceil(R / 64) row tiles of TR = min(R, 64) rows: workspace
// part_o [B * Hkv * T][splits * 4 / M][TR][D] and part_ml
// [B * Hkv * T][splits * 4 / M][TR][2] fp32, tickets [B * Hkv * T] int32
// (0 at launch; left at 0).
template <int D, int M, bool PAGED>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ kv_lengths,
                        const int* __restrict__ page_table, int n_pages,
                        int max_pages, int page_shift, bf16* __restrict__ o,
                        float* __restrict__ o32, float* __restrict__ lse,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int* __restrict__ tickets,
                        int Sq, int S, int Hq, int Hkv, int split_tiles,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        float scale, int window) {
  using L = DecSmem<D, M>;
  constexpr int WPM = WARPS / M;  // warps per m16 tile
  constexpr int KPW = BK / WPM;   // keys of each tile per warp (16 M)
  constexpr int NT = KPW / 8;     // n8 tiles of S per warp
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  const int G = Hq / Hkv;
  const int R = Sq * G;
  const int TR = min(R, MAX_ROWS);  // rows of a full row tile
  const int row_tiles = (R + MAX_ROWS - 1) / MAX_ROWS;
  const int h = blockIdx.x / row_tiles, rt = blockIdx.x % row_tiles;
  const int b = blockIdx.y, split = blockIdx.z;
  const int row0 = rt * MAX_ROWS;     // this tile's first row
  const int nr = min(R - row0, MAX_ROWS);  // and its row count
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int kv_len = kv_lengths[b];
  int lo, hi;
  mtt::live_tile_range(BK, (S + BK - 1) / BK, kv_len - 1, kv_len + Sq - 2,
                       true, window, &lo, &hi);
  const int n_live = mtt::decode_live_splits(lo, hi, split_tiles);
  // row gr of this tile's output: element c of query gr / G, head
  // h * G + gr % G (o and o32 share o's strides)
  auto out_off = [&](int gr, int c) {
    return b * o_sb + (gr / G) * o_ss + (long long)(h * G + gr % G) * o_sh +
           c;
  };
  auto store = [&](int gr, int c, float4 val, float row_lse) {
    const long long off = out_off(gr, c);
    if (o32 != nullptr) {
      *reinterpret_cast<float4*>(o32 + off) = val;
    } else {
      uint2 packed;
      packed.x = sm90::pack_bf16(val.x, val.y);
      packed.y = sm90::pack_bf16(val.z, val.w);
      *reinterpret_cast<uint2*>(o + off) = packed;
    }
    if (lse != nullptr && c == 0)
      lse[((long long)b * Hq + h * G + gr % G) * Sq + gr / G] = row_lse;
  };
  if (split >= n_live) {
    if (n_live == 0 && split == 0) {
      // the row sees nothing: o = 0, lse = NEG_INF
      for (int i = threadIdx.x; i < nr * (D / 4); i += THREADS)
        store(row0 + i / (D / 4), (i % (D / 4)) * 4,
              make_float4(0.f, 0.f, 0.f, 0.f), mtt::NEG_INF);
    }
    return;
  }
  int t0, t1;
  mtt::decode_split_range(split, split_tiles, lo, hi, &t0, &t1);
  const int nt = t1 - t0;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sb = sm90::smem_u32(smem);

  // the tile's rows r < nr (row gr = row0 + r: query gr / G, head
  // h * G + gr % G), zero padding after
  for (int i = tid; i < 16 * M * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr)
      val = *reinterpret_cast<const uint4*>(
          q + b * q_sb + (gr / G) * q_ss + (long long)(h * G + gr % G) * q_sh +
          c * 8);
    *reinterpret_cast<uint4*>(smem + swz<D>(r, c)) = val;
  }

  const bf16* kb = k + h * k_sh;
  const bf16* vb = v + h * v_sh;
  if constexpr (!PAGED) {
    kb += b * k_sb;
    vb += b * v_sb;
  }
  const int* table = PAGED ? page_table + (long long)b * max_pages : nullptr;
  const int row_mask = (1 << page_shift) - 1;
  // positions past the deepest query (or past the cache) are never read
  const int k_end = min(S, kv_len + Sq - 1);

  auto load_tile = [&](int ti, int stage) {
    const int k0 = ti * BK;
#pragma unroll
    for (int it = 0; it < BK * CPR / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / CPR, c = i % CPR;
      const int kp = k0 + r;
      const bool ok = kp < k_end;
      long long ko = (long long)kp * k_ss, vo = (long long)kp * v_ss;
      if constexpr (PAGED) {
        int page = ok ? __ldg(table + (kp >> page_shift)) : 0;
        page = (unsigned)page < (unsigned)n_pages ? page : 0;
        const long long rp = kp & row_mask;
        ko = (long long)page * k_sb + rp * k_ss;
        vo = (long long)page * v_sb + rp * v_ss;
      }
      const uint32_t so = stage * L::kv_bytes + swz<D>(r, c);
      cp_async16(sb + L::k_off + so, ok ? kb + ko + c * 8 : kb, ok ? 16 : 0);
      cp_async16(sb + L::v_off + so, ok ? vb + vo + c * 8 : vb, ok ? 16 : 0);
    }
  };

  const int mt = warp / WPM;  // this warp's m16 tile
  const int ksl = warp % WPM;  // and its key slice of each tile
  const int r0 = lane / 4, c2 = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    qpos[hh] = kv_len - 1 + (row0 + mt * 16 + r0 + 8 * hh) / G;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {mtt::NEG_INF, mtt::NEG_INF}, l[2] = {0.f, 0.f};

  if (nt > 0) load_tile(t0, 0);
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) load_tile(t0 + i + 1, (i + 1) & 1);
    cp_async_commit();  // possibly empty: wait_group 1 then covers tile i
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t k_s = sb + L::k_off + (i & 1) * L::kv_bytes;
    const uint32_t v_s = sb + L::v_off + (i & 1) * L::kv_bytes;
    const int key0 = ksl * KPW;  // the warp's first key within the tile
    const int kpos0 = (t0 + i) * BK + key0;

    // S = Q Kᵀ: 16 rows x KPW keys, k = D
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(sb + swz<D>(mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1),
                          2 * kk + (lane >> 4)),
              a);
#pragma unroll
      for (int nn = 0; nn < NT; nn += 2) {
        uint32_t bk[4];
        ldsm_x4(k_s + swz<D>(key0 + 8 * nn + (lane & 7) + 8 * (lane >> 4),
                             2 * kk + ((lane >> 3) & 1)),
                bk);
        mma_bf16(sc[nn], a, bk[0], bk[1]);
        mma_bf16(sc[nn + 1], a, bk[2], bk[3]);
      }
    }

    // mask, then the online softmax in the log2 domain (m is
    // max(s) * scale * log2 e); the 4 lanes of a row reduce with shuffles
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nn = 0; nn < NT; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kpos0 + 8 * nn + c2 + (e & 1);
        if (!(kpos < S && mtt::visible(qpos[e >> 1], kpos, true, window)))
          sc[nn][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nn][e]);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * sl2);
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
    // P as the A operand of P·V: k step s covers keys [16 s, +16) of the
    // warp's slice, i.e. S's n8 tiles 2 s and 2 s + 1
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nn = 0; nn < NT; ++nn) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(sc[nn][e], sl2, -m[e >> 1]));
        ps[e >> 1] += p[e];
      }
      pa[nn / 2][2 * (nn % 2)] = sm90::pack_bf16(p[0], p[1]);
      pa[nn / 2][2 * (nn % 2) + 1] = sm90::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: k = the warp's KPW keys, n = D
#pragma unroll
    for (int s = 0; s < NT / 2; ++s)
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(v_s + swz<D>(key0 + 16 * s + (lane & 7) +
                                   8 * ((lane >> 3) & 1),
                               nd + (lane >> 4)),
                  bv);
        mma_bf16(acc[nd], pa[s], bv[0], bv[1]);
        mma_bf16(acc[nd + 1], pa[s], bv[2], bv[3]);
      }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- this warp's partial: unnormalised o, m and l of its rows ----
  const long long bh = ((long long)b * Hkv + h) * row_tiles + rt;
  const int n_part = gridDim.z * WPM;
  const int part = split * WPM + ksl;
  float* po = part_o + (bh * n_part + part) * TR * D;
  float* pml = part_ml + (bh * n_part + part) * TR * 2;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = mt * 16 + r0 + 8 * hh;
    if (row < nr) {
      if (lane % 4 == 0) {
        pml[row * 2] = m[hh];
        pml[row * 2 + 1] = l[hh];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(po + row * D + 8 * j + c2) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }

  // ---- the last live split of (slot, kv head, row tile) merges, in split
  // order ----
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(tickets + bh, 1) == n_live - 1;
    if (is_last) tickets[bh] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int np = n_live * WPM;
  const float* mo = part_o + bh * n_part * TR * D;
  const float* mml = part_ml + bh * n_part * TR * 2;
  for (int i = tid; i < nr * (D / 4); i += THREADS) {
    const int row = i / (D / 4), c = (i % (D / 4)) * 4, gr = row0 + row;
    float mx = mtt::NEG_INF, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int p = 0; p < np; ++p) {
      const long long pr = (long long)p * TR + row;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(mml + pr * 2));
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(mo + pr * D + c));
      const float m_new = fmaxf(mx, ml.x);
      const float s1 = exp2f(mx - m_new), s2 = exp2f(ml.x - m_new);
      den = den * s1 + ml.y * s2;
      num.x = num.x * s1 + a.x * s2;
      num.y = num.y * s1 + a.y * s2;
      num.z = num.z * s1 + a.z * s2;
      num.w = num.w * s1 + a.w * s2;
      mx = m_new;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    store(gr, c,
          make_float4(num.x * inv, num.y * inv, num.z * inv, num.w * inv),
          den > 0.f ? (mx + log2f(den)) * LN2 : mtt::NEG_INF);
  }
}

struct Args {
  const void *q, *k, *v;
  const int *lens, *table;
  int n_pages, max_pages, page_shift;
  void* o;
  float *o32, *lse;
  float *part_o, *part_ml;
  int* tickets;
  int B, Sq, S, Hq, Hkv, split_tiles, n_split;
  long long qs[3], ks[3], vs[3], os[3];
  float scale;
  int window;
  cudaStream_t stream;
};

template <int D, int M, bool PAGED>
cudaError_t launch(const Args& a) {
  using L = DecSmem<D, M>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, M, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::total);
  if (err != cudaSuccess) return err;
  const int row_tiles = (a.Sq * (a.Hq / a.Hkv) + MAX_ROWS - 1) / MAX_ROWS;
  dim3 grid(a.Hkv * row_tiles, a.B, a.n_split);
  flash_decode_kernel<D, M, PAGED><<<grid, THREADS, L::total, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lens, a.table, a.n_pages, a.max_pages,
      a.page_shift, static_cast<bf16*>(a.o), a.o32, a.lse, a.part_o,
      a.part_ml, a.tickets,
      a.Sq, a.S, a.Hq, a.Hkv, a.split_tiles, a.qs[0], a.qs[1], a.qs[2],
      a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.os[0], a.os[1],
      a.os[2], a.scale, a.window);
  return cudaGetLastError();
}

template <int D, bool PAGED>
cudaError_t launch_rows(const Args& a) {
  switch (m_tiles(min(a.Sq * (a.Hq / a.Hkv), MAX_ROWS))) {
    case 1: return launch<D, 1, PAGED>(a);
    case 2: return launch<D, 2, PAGED>(a);
    default: return launch<D, 4, PAGED>(a);
  }
}

template <bool PAGED>
int dispatch(const Args& a, int D) {
  const int n_tiles = (a.S + BK - 1) / BK;
  if (a.B < 1 || a.Sq < 1 || a.S < 1 || a.Hkv < 1 || a.Hq % a.Hkv ||
      a.split_tiles < 1 ||
      a.n_split < 1 || (long long)a.n_split * a.split_tiles < n_tiles ||
      a.n_split > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch_rows<128, PAGED>(a);
  if (D == 64) return (int)launch_rows<64, PAGED>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of the launch.
// Both take the split schedule (split_tiles kv tiles of 64 positions a
// split, n_split splits with n_split * split_tiles >= ceil(S / 64)) and
// its workspace: part_o fp32 [B * Hkv * T * n_split * 4 / M * TR * D],
// part_ml fp32 [B * Hkv * T * n_split * 4 / M * TR * 2] (R = Sq * Hq /
// Hkv query rows a kv head, T = ceil(R / 64) row tiles of TR = min(R, 64)
// rows, M = 1, 2, 4 for TR <= 16, 32, 64) and tickets int32
// [B * Hkv * T], zero before the launch and left at zero by it.
//
// The partial form: o32 (fp32, o's strides) non-null writes o there
// instead of the bf16 o (which may then be null); lse non-null writes
// the rows' log-sum-exp, fp32 [B, Hq, Sq] contiguous. kv_len 0 gives
// o = 0 and lse = NEG_INF.
//
// Dense: q/o are [B, Sq, Hq, D], k/v [B, S, Hkv, D], kv_lengths [B] int32
// on the device; strides in elements as (batch, seq, head), head dim
// contiguous. window <= 0 means no sliding window.
extern "C" int mtt_flash_decode_bf16(
    const void* q, const void* k, const void* v, const void* kv_lengths,
    void* o, void* o32, void* lse, void* part_o, void* part_ml,
    void* tickets, int B, int Sq, int S,
    int Hq, int Hkv, int D, int split_tiles, int n_split, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale, int window,
    void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  const Args a{q, k, v, static_cast<const int*>(kv_lengths), nullptr, 0, 0, 0,
               o, static_cast<float*>(o32), static_cast<float*>(lse),
               static_cast<float*>(part_o), static_cast<float*>(part_ml),
               static_cast<int*>(tickets), B, Sq, S, Hq, Hkv, split_tiles,
               n_split, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
               {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}, scale, window,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D);
}

// Paged: k/v are one layer's page pools [P, ps, Hkv, D] (P = n_pages)
// with strides in elements as (page, row in page, head), page_table
// [B, max_pages] int32 contiguous on the device (entries in [0, P); 0 is
// the scratch page), ps = 1 << page_shift, S = max_pages * ps.
extern "C" int mtt_paged_flash_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_lengths, void* o, void* o32,
    void* lse, void* part_o, void* part_ml, void* tickets, int B, int Sq,
    int n_pages, int max_pages,
    int page_shift, int Hq, int Hkv, int D, int split_tiles, int n_split,
    long long q_sb, long long q_ss, long long q_sh, long long k_sp,
    long long k_sr, long long k_sh, long long v_sp, long long v_sr,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int window, void* stream) {
  cudaGetLastError();
  if (n_pages < 1 || max_pages < 1 || page_shift < 0 || page_shift > 20)
    return (int)cudaErrorInvalidValue;
  const long long S = (long long)max_pages << page_shift;
  if (S > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(kv_lengths),
               static_cast<const int*>(page_table), n_pages, max_pages,
               page_shift, o, static_cast<float*>(o32),
               static_cast<float*>(lse), static_cast<float*>(part_o),
               static_cast<float*>(part_ml), static_cast<int*>(tickets), B, Sq,
               (int)S, Hq, Hkv, split_tiles, n_split, {q_sb, q_ss, q_sh},
               {k_sp, k_sr, k_sh}, {v_sp, v_sr, v_sh}, {o_sb, o_ss, o_sh},
               scale, window, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D);
}
