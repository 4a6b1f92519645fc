"""Ring attention over sequence-striped paged KV pools (counterpart of
megatron_tpu/inference/context_parallel/ring_kv.py).

The device half of the context-parallel serving engine, one layer at a
time on every rank of the context group: (1) scatter-write the new K/V
rows into this rank's stripe (logical page l of a sequence lives on
context rank ``l % cp``; a rank holds only its own pages), (2) attend
the local stripe alone, giving a normalized partial (o, lse), and (3)
merge the cp partials with the ring-attention merge algebra
(ops/ring_attention._merge_normalized) under one of two geometries:

  * "ring": cp - 1 hops around the context group. Overlapped by default
    (CpComm.overlap): hop l + 1's exchange is posted before the merge of
    hop l's arrival, which is legal because the hop chain depends only on
    earlier arrivals, never on the merges; same hops, bytes and numerics
    as the serial schedule;
  * "2d": cp = cp_seq x cp_head. A head all-to-all inside each
    cp_head-sized subgroup trades full-head partials for this member's
    head slice of every member's partial (site "cp_a2a"), the members'
    stripes merge locally, cp_seq - 1 ring hops across subgroups (1 /
    cp_head the payload) merge the rest, and a subgroup all-gather
    restores the heads.

The hop moves the partial output dense (fp32) or low-bit (site
"cp_ring", quant/collectives.ring_start); the lse rows always move
dense. Every rank ends with the whole result.

The rank's partial, by route (chosen by configuration, never because a
launch failed):

  * decode (one token a slot) under attention_impl "pallas" and no
    sliding window: B5's partial form, paged_flash_decode(...,
    return_lse=True) (csrc/flash_decode.cu on CUDA tensors, its plain
    version on the CPU). A rank's pages hold a row's global positions in
    increasing order, so the keys a rank sees of a row of length L are a
    prefix of its local table, of length sum_j clamp(L - (j cp + r) ps,
    0, ps); the kernel takes that local length and the local table
    (sentinel entries clamped into the pool, as the JAX package clamps
    them), and needs no new mask. A rank holding no page of the row has
    local length 0: o = 0, lse = NEG_INF, which the merge weighs 0;
  * a prefill chunk, a decode under a sliding window (a stripe's visible
    keys then start above its local index 0, which B5's window mask
    cannot express) or attention_impl "xla": the plain masked partial
    here (stripe_partial), the JAX package's arithmetic in fp32.

Mask semantics are ops/attention.py's, so the engine stays
token-identical to the one-process paged engine: decode key g attends
iff g < lengths + 1 (the pre-increment slot length) and, with a window
W, g >= lengths + 1 - W; chunk key g attends query q_pos iff g <= q_pos
and, with a window, g > q_pos - W.

The local table is this rank's view [rows, mpl]: entry [i, j] is the
local pool index of logical page ``j * cp + r`` of row i, or the
sentinel ``npl`` (the local pool size) where that page is unallocated
(rank 0 maps those to its scratch page 0). Sentinel writes are dropped;
sentinel reads are masked (plain route) or past the local length (B5).
The scatter-write drops them with a boolean mask, which reads the mask
on the host once a layer: the context-parallel tick runs eagerly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from megatron_tpu_torch.ops.flash import flash_template as ft
from megatron_tpu_torch.ops.flash.masks import NEG_INF
from megatron_tpu_torch.ops.ring_attention import _merge_normalized
from megatron_tpu_torch.quant.collectives import (
    grouped_all_gather, grouped_all_to_all, ring_start,
)


def _ring_hop(cpc, o, lse, perm):
    """Post one hop: the o partial over the (optionally low-bit) cp_ring
    transport, the lse rows dense. Returns the wait for (o, lse)."""
    return ring_start([o, lse], cpc.group, perm, mode=cpc.wire_mode(),
                      chunk=cpc.chunk, dense=(1,))


def _ring_merge(cpc, o, lse, perm, hops):
    """Merge `hops` ring arrivals into this rank's partial. Serial: hop,
    merge, hop, ... Overlapped (cpc.overlap): hop l + 1 is posted before
    hop l's merge; the result is the same."""
    acc = (o, lse)
    if hops <= 0:
        return acc
    if not cpc.overlap:
        cur = (o, lse)
        for _ in range(hops):
            cur = tuple(_ring_hop(cpc, *cur, perm)())
            acc = _merge_normalized(acc, *cur)
        return acc
    nxt = _ring_hop(cpc, o, lse, perm)
    for hop in range(hops):
        cur = tuple(nxt())
        if hop + 1 < hops:
            nxt = _ring_hop(cpc, *cur, perm)
        acc = _merge_normalized(acc, *cur)
    return acc


def _merge_2d(cpc, o, lse):
    """The 2d merge: head scatter inside the subgroup, local merge of the
    members' stripes, the ring across subgroups at 1 / subgroup the
    payload, head gather. o [B, S, H, D], lse [B, H, S]."""
    cp, g = cpc.cp, cpc.subgroup
    b, s, h, d = o.shape
    mode = cpc.a2a_wire_mode()
    # member m of a subgroup ends with head slice m of every member's
    # partial, stacked in member order on a leading dim
    o_st = grouped_all_to_all(o, cpc.sub_group, split_axis=2, concat_axis=0,
                              mode=mode, chunk=cpc.chunk)
    l_st = grouped_all_to_all(lse, cpc.sub_group, split_axis=1,
                              concat_axis=0)
    o_st = o_st.reshape(g, b, s, h // g, d)
    l_st = l_st.reshape(g, b, h // g, s)
    acc = (o_st[0], l_st[0])
    for m in range(1, g):
        acc = _merge_normalized(acc, o_st[m], l_st[m])
    # the ring only across subgroups: context rank r -> r + g
    perm = [(r, (r + g) % cp) for r in range(cp)]
    acc_o, _ = _ring_merge(cpc, *acc, perm, cp // g - 1)
    return grouped_all_gather(acc_o, cpc.sub_group, gather_axis=2,
                              mode=mode, chunk=cpc.chunk)


def local_lengths(lengths: torch.Tensor, cp: int, rank: int, ps: int,
                  mpl: int) -> torch.Tensor:
    """[B] int32: how many of each row's first `lengths` global positions
    context rank `rank` holds, sum_j clamp(L - (j cp + rank) ps, 0, ps)
    over its mpl table slots (a prefix of its local positions)."""
    start = (torch.arange(mpl, device=lengths.device) * cp + rank) * ps
    return torch.clamp(lengths.long()[:, None] - start[None, :], 0,
                       ps).sum(1).to(torch.int32)


def stripe_partial(q, k_pool, v_pool, loc, cp, rank, cache_index, per_slot,
                   sliding_window=None):
    """Plain masked partial of this rank's stripe, in fp32 (the JAX
    package's ring_kv partial): q [B, S, Hq, D]; pools [npl, ps, Hkv, D];
    loc [B, mpl] local table. Returns (o [B, S, Hq, D] fp32 normalized,
    lse [B, Hq, S] fp32, -inf where the rank sees nothing)."""
    npl, ps = k_pool.shape[0], k_pool.shape[1]
    rows, mpl = loc.shape
    b, s, hq, d = q.shape
    hkv = k_pool.shape[2]
    dev = q.device
    safe = torch.clamp(loc.long(), max=npl - 1)
    kf = k_pool[safe].reshape(rows, mpl * ps, hkv, d).float()
    vf = v_pool[safe].reshape(rows, mpl * ps, hkv, d).float()
    g_pos = (((torch.arange(mpl, device=dev) * cp + rank) * ps)[:, None]
             + torch.arange(ps, device=dev)[None, :]).reshape(-1)
    valid = (loc != npl).repeat_interleave(ps, dim=1)       # [rows, s_loc]
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    if per_slot:
        kv_len = cache_index.long()[:, None, None] + 1      # [B, 1, 1]
        allowed = g_pos[None, None, :] < kv_len
        if sliding_window is not None:
            allowed &= g_pos[None, None, :] >= kv_len - sliding_window
    else:
        q_pos = (int(cache_index)
                 + torch.arange(s, device=dev))[None, :, None]
        allowed = g_pos[None, None, :] <= q_pos
        if sliding_window is not None:
            allowed &= g_pos[None, None, :] > q_pos - sliding_window
    allowed = allowed & valid[:, None, :]                   # [B, S, s_loc]
    scores = scores.masked_fill(~allowed[:, None, None], -torch.inf)
    m_raw = scores.amax(dim=-1)                             # [B, Hkv, G, S]
    m_safe = torch.where(torch.isfinite(m_raw), m_raw,
                         torch.zeros_like(m_raw))
    p = torch.exp(scores - m_safe[..., None])
    tot = p.sum(dim=-1)                                     # [B, Hkv, G, S]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    tot_t = tot.permute(0, 3, 1, 2)                         # [B, S, Hkv, G]
    o = (o / torch.clamp(tot_t, min=1e-30)[..., None]).reshape(b, s, hq, d)
    lse = torch.where(tot > 0.0,
                      m_safe + torch.log(torch.clamp(tot, min=1e-30)),
                      torch.full_like(tot, -torch.inf))
    return o, lse.reshape(b, hq, s)


def _write_stripe(pool, new, loc, pos, rows, cp, rank, keep):
    """new [n, Hkv, D] at global positions pos [n] of table rows `rows`
    [n] into this rank's pool, where this rank owns the page and `keep`
    [n] holds (the chunk's write fences); other rows dropped."""
    npl, ps = pool.shape[0], pool.shape[1]
    lpage = pos // ps
    j = torch.clamp(lpage // cp, max=loc.shape[1] - 1)
    phys = loc.long()[rows, j]
    keep = keep & ((lpage % cp) == rank) & (phys < npl)
    pool[phys[keep], (pos % ps)[keep]] = new[keep].to(pool.dtype)


def paged_ring_attention(cpc, q, k_new, v_new, pools, loc, cache_index,
                         per_slot: bool, page_write_start=None,
                         page_write_end=None,
                         sliding_window: Optional[int] = None,
                         kernel: bool = True) -> torch.Tensor:
    """Cross-stripe paged attention for one layer on this rank.

    q [B, S, Hq, D]; k_new/v_new [B, S, Hkv, D] (after rope); pools =
    (k_pool, v_pool) this rank's stripe [npl, ps, Hkv, D], written in
    place; loc [B, mpl] int32 this rank's local table. Decode
    (per_slot): cache_index = lengths [B], S == 1. Chunk prefill:
    cache_index the int chunk offset, B == 1, the writes fenced to
    [page_write_start, page_write_end). kernel: the decode partial may
    take B5 (attention_impl "pallas"). Returns ctx [B, S, Hq, D] in q's
    dtype."""
    k_pool, v_pool = pools
    cp, rank = cpc.cp, cpc.rank
    b, s = q.shape[:2]
    if per_slot and s != 1:
        raise ValueError(
            "context-parallel paged decode serves one token a slot (no "
            f"speculative rows); got S={s}")
    if not per_slot and b != 1:
        raise ValueError(f"context-parallel chunk prefill needs batch 1, "
                         f"got {b}")
    dev = q.device
    if per_slot:
        pos = cache_index.to(dev, torch.long)
        rows = torch.arange(b, device=dev)
        keep = torch.ones(b, dtype=torch.bool, device=dev)
        kn, vn = k_new[:, 0], v_new[:, 0]
    else:
        pos = int(cache_index) + torch.arange(s, device=dev)
        rows = torch.zeros(s, dtype=torch.long, device=dev)
        keep = torch.ones(s, dtype=torch.bool, device=dev)
        if page_write_start is not None:
            keep &= pos >= int(page_write_start)
        if page_write_end is not None:
            keep &= pos < int(page_write_end)
        kn, vn = k_new[0], v_new[0]
    _write_stripe(k_pool, kn, loc, pos, rows, cp, rank, keep)
    _write_stripe(v_pool, vn, loc, pos, rows, cp, rank, keep)

    if per_slot and kernel and sliding_window is None:
        npl, ps = k_pool.shape[0], k_pool.shape[1]
        safe = torch.clamp(loc, max=npl - 1).to(torch.int32).contiguous()
        o, lse = ft.paged_flash_decode(
            q, k_pool, v_pool, safe,
            local_lengths(pos + 1, cp, rank, ps, loc.shape[1]),
            return_lse=True)
        # the kernel's empty rows (NEG_INF) as the merge's -inf
        lse = torch.where(lse <= NEG_INF / 2, -torch.inf, lse)
    else:
        o, lse = stripe_partial(q, k_pool, v_pool, loc, cp, rank,
                                cache_index, per_slot, sliding_window)
    if cpc.geometry == "2d":
        ctx = _merge_2d(cpc, o, lse)
    else:
        perm = [(i, (i + 1) % cp) for i in range(cp)]
        ctx, _ = _ring_merge(cpc, o, lse, perm, cp - 1)
    return ctx.to(q.dtype)
