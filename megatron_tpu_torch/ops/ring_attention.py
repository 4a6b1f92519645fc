"""Ring attention over the context group (counterpart of
megatron_tpu/ops/ring_attention.py, its flash-inner rings).

Context parallelism shards the sequence over the context ranks; each
rank keeps its queries and passes its K/V block around the ring
(parallel/mappings.p2p to context_next, from context_prev), one hop a
step, merging each block's normalized partial attention into a running
(out, lse) pair (_merge_normalized). Two layouts:

  * zig-zag (causal or sliding-window masks, S % 2cp == 0): the
    sequence's 2cp stripes of c = S / 2cp positions are dealt so that
    rank r holds stripes r and 2cp-1-r, an early and a late one, which
    evens out the causal work over the ranks. restripe() moves a rank's
    contiguous piece (stripes 2r, 2r+1) into that layout with one
    all-to-all over the context group and back after attention; the
    backward of each move is the other. Each hop then holds at most
    three stripe pairs: lo x lo when src <= my, hi x lo always, hi x hi
    when src >= my, each also gated by the window's reachability;
  * contiguous (S % 2cp != 0, or a bidirectional mask): one pair a hop,
    skipped for a causal mask when the block lies wholly in the future
    (src > my).

The schedule (ring_schedule) is a pure function of (my, cp, c, window):
per hop the block's origin and its stripe pairs, each with its q-vs-k
position offset delta and its predicate. Every live pair is one launch
of the flash_fwd kernel (B1) at that runtime delta. The backward is one
torch.autograd.Function around the whole ring: it replays the ring with
the global lse of each query stripe and runs flash_bwd_dq (B2) and
flash_bwd_dkv (B3) per live pair; dq accumulates in fp32 on its rank,
dk/dv accumulate in fp32 in carries that travel with their blocks and
come home after the last hop. The kernels take GQA natively (k/v keep
their Hkv heads). On CPU tensors the wrappers run their plain versions.

ring_attention_emulated runs every virtual rank's schedule over one
process's tensors (the same hops, pairs and merges, the block of hop r
read from its origin's stripes), so the ring's math is held without
spawning ranks; with plain=True its stripe pairs run the kernels' plain
versions on any device, the yardstick the card holds the kernels'
ring against.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from megatron_tpu_torch.ops.flash import flash_template as ft
from megatron_tpu_torch.ops.flash.masks import NEG_INF
from megatron_tpu_torch.parallel.mappings import exchange, p2p

# p2p tags of the ring's blocks (k, v, dk, dv)
_TAGS = (11, 12, 13, 14)


@dataclasses.dataclass(frozen=True)
class StripePair:
    """One (query part, key part) product of a hop: parts index the
    rank's stripes (0 lo, 1 hi; 0 on the contiguous ring); delta is the
    query part's global origin minus the key part's."""

    q_part: int
    k_part: int
    delta: int
    live: bool


def zigzag_window_pred(window: Optional[int], c: int, k_stripe: int,
                       q_stripe: int) -> bool:
    """A key stripe can reach a query stripe under the window: its last
    position is past the query stripe's first position - window."""
    if window is None:
        return True
    return (k_stripe + 1) * c - 1 > q_stripe * c - window


def ring_schedule(my: int, cp: int, c: int, window: Optional[int],
                  zigzag: bool, causal: bool = True
                  ) -> List[Tuple[int, List[StripePair]]]:
    """Per hop r = 0 .. cp-1: (src, pairs), src = (my - r) % cp the
    origin of the block the rank holds. c is the stripe length (zig-zag)
    or the block length (contiguous)."""
    hops = []
    for r in range(cp):
        src = (my - r) % cp
        if zigzag:
            my_hi, src_hi = 2 * cp - 1 - my, 2 * cp - 1 - src
            pairs = [
                StripePair(0, 0, (my - src) * c,
                           src <= my and zigzag_window_pred(window, c, src,
                                                            my)),
                StripePair(1, 0, (my_hi - src) * c,
                           zigzag_window_pred(window, c, src, my_hi)),
                StripePair(1, 1, (src - my) * c,
                           src >= my and zigzag_window_pred(window, c,
                                                            src_hi, my_hi)),
            ]
        else:
            live = zigzag_window_pred(window, c, src, my)
            if causal:
                live = live and src <= my
            pairs = [StripePair(0, 0, (my - src) * c, live)]
        hops.append((src, pairs))
    return hops


def _merge_normalized(st, o_i: torch.Tensor, lse_i: torch.Tensor):
    """Merge a pair's (normalized out [B, c, H, D] fp32, lse [B, H, c])
    into the running pair. A lse at the kernel's fully-masked depth
    (NEG_INF) counts as -inf: such rows carry zero weight whichever hop
    merges first."""
    out, lse = st
    lse_i = torch.where(lse_i <= NEG_INF / 2,
                        torch.full_like(lse_i, -torch.inf), lse_i)
    m = torch.maximum(lse, lse_i)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - m_safe),
                        torch.zeros_like(lse))
    w_new = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - m_safe),
                        torch.zeros_like(lse_i))
    tot = torch.clamp(w_old + w_new, min=1e-30)

    def t(x):                                   # [B, H, c] -> [B, c, H, 1]
        return x.transpose(1, 2)[..., None]

    new_out = (out * t(w_old) + o_i * t(w_new)) / t(tot)
    new_lse = torch.where(w_old + w_new > 0.0, m_safe + torch.log(tot),
                          torch.full_like(tot, -torch.inf))
    return new_out, new_lse


def _parts(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    return list(x.chunk(n, dim=1)) if n > 1 else [x]


def _pair_fwd(plain, q, k, v, **kw):
    """(o, lse) of one stripe pair: the B1 kernel or its plain version."""
    if plain:
        return ft.flash_fwd_reference(q, k, v, **kw)
    return ft.flash_fwd(q, k, v, **kw)


def _pair_bwd(plain, q, k, v, o, lse, do, **kw):
    """(dq, dk, dv) of one stripe pair with the global out and lse: the
    B2 and B3 kernels, or their plain version."""
    if plain:
        return ft.flash_bwd_reference(q, k, v, o, lse, do, **kw)
    return ft.flash_bwd(q, k, v, o, lse, do, **kw)


def _rank_forward(q, hops, n_parts, window, causal,
                  block: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                  plain: bool = False):
    """One rank's ring forward: q [B, s, Hq, D] in its ring layout;
    block(r) gives hop r's (k, v). Returns (out in q's dtype, [lse of
    each query part, [B, Hq, c] fp32])."""
    b, s, hq, d = q.shape
    c = s // n_parts
    qs = _parts(q, n_parts)
    st = [(torch.zeros((b, c, hq, d), dtype=torch.float32, device=q.device),
           torch.full((b, hq, c), -torch.inf, dtype=torch.float32,
                      device=q.device)) for _ in range(n_parts)]
    for r, (_, pairs) in enumerate(hops):
        k, v = block(r)
        ks, vs = _parts(k, n_parts), _parts(v, n_parts)
        for p in pairs:
            if not p.live:
                continue
            o, lse = _pair_fwd(plain, qs[p.q_part], ks[p.k_part],
                               vs[p.k_part], causal=causal,
                               sliding_window=window, delta=p.delta)
            st[p.q_part] = _merge_normalized(st[p.q_part], o.float(), lse)
    out = torch.cat([o for o, _ in st], dim=1).to(q.dtype)
    return out, [lse.contiguous() for _, lse in st]


def _rank_backward(q, out, lses, do, hops, n_parts, window, causal,
                   block, deliver, plain: bool = False):
    """One rank's ring backward with the global lse of each query part:
    returns dq (q's dtype); deliver(r, dk, dv) takes hop r's block
    gradients ([B, s, Hkv, D] fp32)."""
    qs, os_, dos = (_parts(t, n_parts) for t in (q, out, do))
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in qs]
    for r, (_, pairs) in enumerate(hops):
        k, v = block(r)
        ks, vs = _parts(k, n_parts), _parts(v, n_parts)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        dks, dvs = _parts(dk, n_parts), _parts(dv, n_parts)
        for p in pairs:
            if not p.live:
                continue
            dq_i, dk_i, dv_i = _pair_bwd(
                plain, qs[p.q_part], ks[p.k_part], vs[p.k_part],
                os_[p.q_part], lses[p.q_part], dos[p.q_part],
                causal=causal, sliding_window=window, delta=p.delta)
            dq[p.q_part] += dq_i.float()
            dks[p.k_part] += dk_i.float()
            dvs[p.k_part] += dv_i.float()
        deliver(r, dk, dv)
    return torch.cat(dq, dim=1).to(q.dtype)


def _rotate(mesh, tensors):
    """Each tensor to the next context rank, its counterpart from the
    previous one (every send posted before any wait)."""
    sends = [(t, mesh.context_next, tag) for t, tag in zip(tensors, _TAGS)]
    recvs = [(tuple(t.shape), t.dtype, t.device, mesh.context_prev, tag)
             for t, tag in zip(tensors, _TAGS)]
    return p2p(sends, recvs)


class _Ring(torch.autograd.Function):
    """The ring over the context group (the JAX package's custom_vjp
    _make_zigzag_flash / _make_contig_flash): forward saves q, k, v,
    out and the global lse of each query part; backward replays the
    ring with the dk/dv carries."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, window, zigzag, causal):
        n = 2 if zigzag else 1
        hops = ring_schedule(mesh.cp_rank, mesh.cp, q.shape[1] // n,
                             window, zigzag, causal)
        held = [k, v]

        def block(r):
            if r:
                held[:] = _rotate(mesh, held)
            return held[0], held[1]

        out, lses = _rank_forward(q, hops, n, window, causal, block)
        ctx.save_for_backward(q, k, v, out, *lses)
        ctx.cfg = (mesh, window, zigzag, causal, hops, n)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, *lses = ctx.saved_tensors
        mesh, window, zigzag, causal, hops, n = ctx.cfg
        held = [k, v, None, None]

        def block(r):
            if r:
                held[:] = _rotate(mesh, held)
            return held[0], held[1]

        def deliver(r, dk, dv):
            held[2] = dk if held[2] is None else held[2] + dk
            held[3] = dv if held[3] is None else held[3] + dv

        dq = _rank_backward(q, out, lses, do.contiguous(), hops, n, window,
                            causal, block, deliver)
        # the carries belong to the block of the last hop (from my + 1):
        # one more step brings each rank's own home
        dk, dv = _rotate(mesh, held[2:])
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None,
                None)


def restripe_plan(cp: int, to_zigzag: bool):
    """The all-to-all that deals a rank's contiguous stripes (2r, 2r+1)
    into the zig-zag layout (r, 2cp-1-r), or back. Per rank: (send
    order of its two local stripes, send counts per group rank, receive
    counts per group rank, the order that puts the received stripes in
    place)."""
    def home(s):            # zig-zag holder of global stripe s
        return s if s < cp else 2 * cp - 1 - s

    plans = []
    for r in range(cp):
        if to_zigzag:
            have, want = [2 * r, 2 * r + 1], [r, 2 * cp - 1 - r]
            dest, src = home, (lambda s: s // 2)
        else:
            have, want = [r, 2 * cp - 1 - r], [2 * r, 2 * r + 1]
            dest, src = (lambda s: s // 2), home
        send = sorted(range(2), key=lambda i: (dest(have[i]), have[i]))
        send_counts = [sum(dest(s) == j for s in have) for j in range(cp)]
        recv_counts = [sum(src(s) == j for s in want) for j in range(cp)]
        # received: by source rank, each source's stripes ascending
        got = sorted(want, key=lambda s: (src(s), s))
        plans.append((send, send_counts, recv_counts,
                      [got.index(s) for s in want]))
    return plans


def restripe(x: torch.Tensor, mesh, to_zigzag: bool) -> torch.Tensor:
    """x [B, s, H, D] between a rank's contiguous piece and its zig-zag
    stripes (restripe_plan), with a gradient (the all-to-all's backward
    is the mirrored one, the local reorders are indexing)."""
    send, send_counts, recv_counts, order = restripe_plan(
        mesh.cp, to_zigzag)[mesh.cp_rank]
    b, s, h, d = x.shape
    rows = x.reshape(b, 2, s // 2, h, d).transpose(0, 1)
    rows = rows[torch.tensor(send, device=x.device)]
    got = exchange(rows, mesh.group("context"), send_counts, recv_counts)
    got = got[torch.tensor(order, device=x.device)]
    return got.transpose(0, 1).reshape(b, s, h, d)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, mask_type: str = "causal",
                   sliding_window: Optional[int] = None) -> torch.Tensor:
    """Exact attention of this rank's contiguous piece [B, S/cp, H, D]
    of the sequence over the whole sequence, by the ring: zig-zag for a
    causal mask when S % 2cp == 0 (restriped there and back), else
    contiguous."""
    causal = mask_type == "causal"
    zigzag = causal and q.shape[1] % 2 == 0
    if not zigzag:
        return _Ring.apply(q, k, v, mesh, sliding_window, False, causal)
    q, k, v = (restripe(t, mesh, True) for t in (q, k, v))
    out = _Ring.apply(q, k, v, mesh, sliding_window, True, True)
    return restripe(out, mesh, False)


# ---------------------------------------------------------------------------
# one-process emulation of every rank's ring
# ---------------------------------------------------------------------------


def _to_ranks(x: torch.Tensor, cp: int, zigzag: bool) -> List[torch.Tensor]:
    """Each virtual rank's piece of x [B, S, H, D]: its zig-zag stripes
    or its contiguous block."""
    if not zigzag:
        return list(x.chunk(cp, dim=1))
    st = x.chunk(2 * cp, dim=1)
    return [torch.cat([st[r], st[2 * cp - 1 - r]], dim=1) for r in range(cp)]


def _from_ranks(pieces: List[torch.Tensor], zigzag: bool) -> torch.Tensor:
    if not zigzag:
        return torch.cat(pieces, dim=1)
    cp = len(pieces)
    st = [None] * (2 * cp)
    for r, p in enumerate(pieces):
        st[r], st[2 * cp - 1 - r] = p.chunk(2, dim=1)
    return torch.cat(st, dim=1)


class _EmulatedRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cp, window, zigzag, causal, plain):
        n = 2 if zigzag else 1
        qs, ks, vs = (_to_ranks(t, cp, zigzag) for t in (q, k, v))
        c = qs[0].shape[1] // n
        outs, lses = [], []
        for my in range(cp):
            hops = ring_schedule(my, cp, c, window, zigzag, causal)
            o, lse = _rank_forward(
                qs[my], hops, n, window, causal,
                lambda r, hops=hops: (ks[hops[r][0]], vs[hops[r][0]]),
                plain)
            outs.append(o)
            lses.append(lse)
        ctx.save_for_backward(q, k, v)
        ctx.state = (outs, lses, cp, window, zigzag, causal, n, c, plain)
        return _from_ranks(outs, zigzag)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        outs, lses, cp, window, zigzag, causal, n, c, plain = ctx.state
        qs, ks, vs, dos = (_to_ranks(t, cp, zigzag)
                           for t in (q, k, v, do.contiguous()))
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in ks]
        dv = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in vs]
        dqs = []
        for my in range(cp):
            hops = ring_schedule(my, cp, c, window, zigzag, causal)

            def deliver(r, dk_r, dv_r, hops=hops):
                src = hops[r][0]
                dk[src] += dk_r
                dv[src] += dv_r

            dqs.append(_rank_backward(
                qs[my], outs[my], lses[my], dos[my], hops, n, window,
                causal, lambda r, hops=hops: (ks[hops[r][0]],
                                              vs[hops[r][0]]),
                deliver, plain))
        return (_from_ranks(dqs, zigzag),
                _from_ranks(dk, zigzag).to(k.dtype),
                _from_ranks(dv, zigzag).to(v.dtype),
                None, None, None, None, None)


def ring_attention_emulated(q_all: torch.Tensor, k_all: torch.Tensor,
                            v_all: torch.Tensor, cp: int,
                            mask_type: str = "causal",
                            sliding_window: Optional[int] = None,
                            zigzag: Optional[bool] = None,
                            plain: bool = False) -> torch.Tensor:
    """Every virtual rank's ring over the whole sequence in one process:
    q_all [B, S, Hq, D], k_all/v_all [B, S, Hkv, D] -> [B, S, Hq, D],
    with a gradient. zigzag None: ring_attention's choice (zig-zag for a
    causal mask when S % 2cp == 0). plain: the stripe pairs' plain
    versions on any device (CPU tensors take them in any case)."""
    causal = mask_type == "causal"
    S = q_all.shape[1]
    if zigzag is None:
        zigzag = causal and S % (2 * cp) == 0
    if S % ((2 if zigzag else 1) * cp):
        raise ValueError(f"sequence {S} does not split into "
                         f"{'2 x ' if zigzag else ''}{cp} pieces")
    return _EmulatedRing.apply(q_all, k_all, v_all, cp, sliding_window,
                               bool(zigzag), causal, bool(plain))
