"""Mixture-of-Experts layer with top-k routing (counterpart of
megatron_tpu/ops/moe.py).

Semantics (the JAX package's):
  * router: softmax over E experts in fp32, top-k per token (k=1
    Switch, k=2 GShard/Mixtral), optionally renormalized to sum 1
    (Mixtral; with ample capacity the layer then equals HF's dropless
    MixtralSparseMoeBlock).
  * capacity dispatch (moe_block): the N = B*S tokens form G groups of
    Sg tokens (Sg divides the RUNTIME S, so a decode tick's S = 1 gives
    groups of one token); each expert takes at most
    C = max(k, ceil(capacity_factor * k * Sg / E)) rows per group, slots
    claimed in token order within an expert, first choices before second
    ones (the GShard priority rule); an overflowing choice is dropped
    (a token dropped by every choice passes with a zero MLP output).
    The JAX package expresses dispatch and combine as einsums with dense
    one-hot [G, Sg, E, C] tensors; here the same slots are a gather into
    [G, E, C, h] expert batches and a gather of each token's k outputs
    back (the one-hot products pick exactly those rows), so no [.., E, C]
    tensor the size of the tokens times the slots exists.
  * dropless dispatch (moe_block_dropless): the N*k (token, choice) rows
    sorted by expert (stable: token order within an expert), the two
    expert products as grouped products over the per-expert row spans,
    and the outputs added back per token, weighted by the gates. On a
    CUDA bf16 tensor the grouped products are torch._grouped_mm with the
    span ends on the device (no host sync, so a CUDA graph can capture
    it); elsewhere a per-expert loop over host-side counts, which syncs.
  * auxiliary losses: the Switch load-balance loss E * sum_e f_e * P_e
    (top-1 assignment fractions f, mean router probabilities P) plus
    the ST-MoE router z-loss mean(logsumexp^2), each with its
    coefficient, from the means over ALL the microbatch's tokens.

Across ranks (a MeshRuntime as `mesh`; the JAX package gets the same
function from GSPMD and its shard_map form, moe.py:122-462):
  * the statistics (f, P, the mean logsumexp^2) are averaged over the
    batch group (data x expert) before the product, so the loss is the
    global one (_BatchMean). Its backward hands every rank the whole
    upstream gradient, so the data ranks' mean of the router's
    gradients is the global loss's; under tensor parallelism it is
    scaled by 1/tp, because the router's gradients (weight and input)
    are summed over the tensor group while each tensor rank holds the
    whole aux loss;
  * tensor parallelism runs inside each expert: the block enters
    through enter_tp (under sequence parallelism the whole sequence is
    gathered, so routing and the capacity slots see every token, as in
    JAX), w_in [E, h, Fin] is this rank's columns (a GLU per half),
    w_out [E, F, h] its rows, the gates weight partial expert outputs
    (an expert's b_out is added on tensor rank 0 only), and moe_block
    returns this rank's partial sums: the caller reduces them with
    exit_tp. The router weight's gradient is a partial sum on each
    tensor rank (training/train_step.reduce_grads sums it);
  * expert parallelism (mesh.ep > 1): the experts are cut E/ep over the
    "expert" axis (rank j of the expert group owns experts [j*El,
    (j+1)*El)). Capacity dispatch fills this rank's [E, G*C, h] slot
    batches and an even all-to-all over the expert group
    (parallel/mappings.exchange) sends each expert's rows to its owner;
    the experts run over [El, ep*G*C, h] and the mirrored all-to-all
    brings the rows back. Dropless dispatch is moe_block_dropless_ep.
    A failed exchange raises; the experts never run replicated.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import apply_activation
from megatron_tpu_torch.parallel.mappings import (
    all_gather, all_reduce, enter_tp, exchange,
)
from megatron_tpu_torch.parallel.mesh import AXIS_EXPERT, BATCH_AXES


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Per-expert token capacity for a group of num_tokens:
    ceil(capacity_factor * top_k * tokens / E), floored at top_k."""
    c = math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * num_tokens
                  / cfg.num_experts)
    return max(cfg.moe_top_k, c)


def _group_for(s: int, target: int) -> int:
    """Largest divisor of s that is <= target, unless that divisor is a
    sliver below min(256, target) (a prime s): then whole rows."""
    if s <= target:
        return s
    d = next(g for g in range(target, 0, -1) if s % g == 0)
    return d if d >= min(256, target) else s


def moe_group_size(cfg: ModelConfig) -> int:
    """Tokens per dispatch group: cfg.moe_group_size, or auto, the largest
    divisor of seq_length <= 2048."""
    if cfg.moe_group_size:
        return cfg.moe_group_size
    return _group_for(cfg.seq_length, 2048)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot [..., n] by comparison (F.one_hot validates its input
    on the host, which a captured decode step cannot do)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _topk_gates(gates: torch.Tensor, top_k: int, renorm: bool):
    """The top-k + renorm numerics, shared by both dispatch modes."""
    topw, topi = torch.topk(gates, top_k, dim=-1)
    if renorm:
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi


def _slots(topi: torch.Tensor, num_experts: int, capacity: int):
    """Slot of every (token, choice) inside its expert, by the GShard
    priority rule: token order within an expert, choice level by choice
    level. topi [..., N, k] -> (pos [..., N, k], keep [..., N, k])."""
    base = torch.zeros(topi.shape[:-2] + (num_experts,), dtype=torch.long,
                       device=topi.device)
    pos = []
    for j in range(topi.shape[-1]):
        m = _one_hot(topi[..., j], num_experts)            # [..., N, E]
        pos_in_e = torch.cumsum(m, dim=-2) - m + base[..., None, :]
        pos.append((pos_in_e * m).sum(-1))
        base = base + m.sum(-2)
    pos = torch.stack(pos, dim=-1)
    return pos, pos < capacity


def topk_dispatch(gates: torch.Tensor, top_k: int, capacity: int,
                  renorm: bool):
    """The dense form of one group's dispatch, as the JAX package builds
    it: (combine [N, E, C] fp32, dispatch [N, E, C] bool, top1 [N, E])."""
    N, E = gates.shape
    topw, topi = _topk_gates(gates, top_k, renorm)
    pos, keep = _slots(topi, E, capacity)
    combine = torch.zeros((N, E, capacity), dtype=torch.float32,
                          device=gates.device)
    for j in range(top_k):
        w = topw[:, j].float() * keep[:, j]
        slot = _one_hot(pos[:, j].clamp(max=capacity - 1), capacity)
        combine = combine + (w[:, None, None]
                             * _one_hot(topi[:, j], E)[:, :, None]
                             * slot[:, None, :])
    return combine, combine > 0, _one_hot(topi[:, 0], E).float()


def _route(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor):
    """(logits, gates, topw, topi) for tokens x [..., h], router in fp32."""
    logits = torch.matmul(x.float(), p["router"].float())
    gates = torch.softmax(logits, dim=-1)
    topw, topi = _topk_gates(gates, cfg.moe_top_k, cfg.moe_renorm_gates)
    return logits, gates, topw, topi


class _BatchMean(torch.autograd.Function):
    """Statistics averaged over the batch group; the backward passes the
    upstream gradient on, scaled by 1/tp (the module docstring)."""

    @staticmethod
    def forward(ctx, stats, group, n, tp):
        ctx.tp = tp
        return all_reduce(stats, group) / n if n > 1 else stats.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp, None, None, None


def _aux_loss(cfg: ModelConfig, logits: torch.Tensor, gates: torch.Tensor,
              topi: torch.Tensor, mesh=None) -> torch.Tensor:
    """Switch load balance + router z-loss, fp32 scalar, from the means
    over every token of the batch (this rank's, averaged over the batch
    group): f the top-1 assignment fractions, P the mean router
    probabilities, and the mean logsumexp^2 (the JAX package's
    _aux_from_stats)."""
    E = cfg.num_experts
    frac = _one_hot(topi[..., 0], E).float().reshape(-1, E).mean(0)
    prob = gates.reshape(-1, E).mean(0)
    z_sq = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    if mesh is not None and (mesh.dp > 1 or mesh.tp > 1):
        stats = _BatchMean.apply(torch.cat([frac, prob, z_sq[None]]),
                                 mesh.group(BATCH_AXES), mesh.dp, mesh.tp)
        frac, prob, z_sq = stats[:E], stats[E:2 * E], stats[2 * E]
    lb = E * (frac * prob).sum()
    return (cfg.moe_aux_loss_coeff * lb
            + cfg.moe_z_loss_coeff * z_sq).float()


def _ep(mesh) -> int:
    return 1 if mesh is None else mesh.ep


def _adds_out_bias(p: Dict[str, Any], mesh) -> bool:
    """Whether this rank adds the experts' b_out: once over the tensor
    group, as its outputs are partial sums there."""
    return "b_out" in p and (mesh is None or mesh.tp_rank == 0)


def _expert_mlp(cfg: ModelConfig, p: Dict[str, Any], xe: torch.Tensor,
                mesh=None):
    """The experts' MLPs over per-expert batches xe [E, R, h] -> [E, R, h]
    (this rank's experts, and under tensor parallelism its partial
    sums)."""
    hmid = torch.bmm(xe, p["w_in"])
    if "b_in" in p:
        hmid = hmid + p["b_in"][:, None, :]
    hmid = apply_activation(cfg.activation, hmid)
    out = torch.bmm(hmid, p["w_out"])
    if _adds_out_bias(p, mesh):
        out = out + p["b_out"][:, None, :]
    return out


def moe_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's MoE FFN: x [B, S, h] -> (y [B, S, h], aux fp32 scalar).
    p: router [h, E], w_in [E, h, Fin], w_out [E, F, h] (+ b_in, b_out);
    with a mesh, this rank's slices, x its sequence chunk under sequence
    parallelism, and y this tensor rank's partial sums over the whole
    sequence (the module docstring: reduce them with exit_tp)."""
    x = enter_tp(x, mesh)
    if cfg.moe_dispatch == "dropless":
        if _ep(mesh) > 1:
            return moe_block_dropless_ep(cfg, p, x, mesh)
        return moe_block_dropless(cfg, p, x, mesh)
    b, s, h = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    # Sg divides the runtime S (a decode tick's S = 1, a prefill bucket)
    Sg = _group_for(s, moe_group_size(cfg))
    G = b * s // Sg
    xg = x.reshape(G, Sg, h)
    logits, gates, topw, topi = _route(cfg, p, xg)           # [G, Sg, *]
    C = moe_capacity(cfg, Sg)
    pos, keep = _slots(topi, E, C)                           # [G, Sg, k]
    aux = _aux_loss(cfg, logits, gates, topi, mesh)

    # slot table [G, E*C]: the token in each slot, or Sg (a zero row) for
    # an empty one; a dropped choice writes past the table, each to a
    # column of its own, so every index of the scatter is distinct
    slot = topi * C + pos.clamp(max=C - 1)
    spill = E * C + torch.arange(Sg * k, device=x.device).reshape(Sg, k)
    dest = torch.where(keep, slot, spill)
    src = torch.arange(Sg, device=x.device)[:, None].expand(Sg, k)
    table = torch.full((G, E * C + Sg * k), Sg, dtype=torch.long,
                       device=x.device)
    table.scatter_(1, dest.reshape(G, -1), src.reshape(1, -1).expand(G, -1))
    table = table[:, :E * C]
    rows = torch.arange(G, device=x.device)
    xpad = torch.cat([xg, xg.new_zeros(G, 1, h)], dim=1)
    xe = xpad[rows[:, None], table]                          # [G, E*C, h]
    xe = xe.reshape(G, E, C, h).transpose(0, 1).reshape(E, G * C, h)
    ep = _ep(mesh)
    if ep > 1:
        # each expert's rows to the rank that owns it: [ep, El, G*C, h]
        # sent block j to rank j, received from each source in its order
        El, even = E // ep, [E // ep * G * C] * ep
        group = mesh.group(AXIS_EXPERT)
        xe = exchange(xe.reshape(E * G * C, h), group, even, even)
        xe = xe.reshape(ep, El, G * C, h).transpose(0, 1).reshape(
            El, ep * G * C, h)
        out = _expert_mlp(cfg, p, xe, mesh)
        out = out.reshape(El, ep, G * C, h).transpose(0, 1).reshape(
            E * G * C, h)
        out = exchange(out, group, even, even)
    else:
        out = _expert_mlp(cfg, p, xe, mesh)
    out = out.reshape(E, G, C, h).transpose(0, 1).reshape(G, E * C, h)

    # combine: each token's kept choices, weighted by their gates in the
    # activation dtype (the JAX combine tensor's cast), summed in fp32
    w = (topw * keep).to(x.dtype)
    picked = out[rows[:, None, None], slot]                  # [G, Sg, k, h]
    y = (picked.float() * w.float()[..., None]).sum(2)
    return y.to(x.dtype).reshape(b, s, h), aux


def _grouped(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor
             ) -> torch.Tensor:
    """Rows x [R, K] sorted by expert, counts [E] rows per expert,
    w [E, K, N] -> [R, N]: each expert's span times its weight."""
    if grouped_mm_available(x):
        offs = torch.cumsum(counts, 0).to(torch.int32)
        return torch._grouped_mm(x, w, offs=offs)
    outs, start = [], 0
    for e, n in enumerate(counts.tolist()):
        outs.append(torch.matmul(x[start:start + n], w[e]))
        start += n
    return torch.cat(outs)


def grouped_mm_available(x: torch.Tensor) -> bool:
    """Whether the dropless products run as torch._grouped_mm (device-side
    span ends, capturable): a CUDA bf16 tensor on a torch that has it."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and hasattr(torch, "_grouped_mm"))


def _grouped_mlp(cfg: ModelConfig, p: Dict[str, Any], xs: torch.Tensor,
                 counts: torch.Tensor, expert_of_row: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """The experts' MLPs over rows xs sorted by expert (counts [E] rows
    each; expert_of_row picks the biases)."""
    hmid = _grouped(xs, p["w_in"], counts)
    if "b_in" in p:
        hmid = hmid + p["b_in"][expert_of_row]
    hmid = apply_activation(cfg.activation, hmid.to(xs.dtype))
    out = _grouped(hmid, p["w_out"], counts)
    if _adds_out_bias(p, mesh):
        out = out + p["b_out"][expert_of_row]
    return out


def _sorted_rows(topi: torch.Tensor, n: int, k: int):
    """The n*k (token, choice) rows sorted by expert, stable (token order
    within an expert): (flat expert ids, sort order, token of each
    sorted row)."""
    flat_e = topi.reshape(-1)                                # [n*k]
    order = torch.argsort(flat_e, stable=True)
    rows = torch.arange(n, device=topi.device).repeat_interleave(k)[order]
    return flat_e, order, rows


def moe_block_dropless(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                       mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dropless dispatch: no token is dropped and no [.., E, C]
    tensor exists; the experts do exactly N*k rows (x already entered
    the tensor group: moe_block)."""
    b, s, h = x.shape
    N, E, k = b * s, cfg.num_experts, cfg.moe_top_k
    xf = x.reshape(N, h)
    logits, gates, topw, topi = _route(cfg, p, xf)
    flat_e, order, rows = _sorted_rows(topi, N, k)
    counts = _one_hot(flat_e, E).sum(0)
    out = _grouped_mlp(cfg, p, xf[rows], counts, flat_e[order], mesh)
    w = topw.reshape(-1)[order]
    y = torch.zeros((N, h), dtype=torch.float32, device=x.device)
    y = y.index_add(0, rows, out.float() * w[:, None])
    aux = _aux_loss(cfg, logits, gates, topi, mesh)
    return y.to(x.dtype).reshape(b, s, h), aux


def _excl_cumsum(a: np.ndarray, axis: int) -> np.ndarray:
    return np.cumsum(a, axis=axis) - a


def ep_metadata(counts: np.ndarray, me: int, ep: int, El: int, R: int
                ) -> Dict[str, np.ndarray]:
    """The expert all-to-all's bookkeeping (a copy of the JAX package's
    _ep_metadata, megatron_tpu/ops/moe.py:211, on the host) from the
    all-gathered counts [ep, E] (rows source i holds for global expert
    e; every rank of the expert group computes the same matrix). Rank j
    owns experts [j*El, (j+1)*El). Chunks land on the receiver packed in
    source order; a receive buffer of R rows clamps greedily in source
    order."""
    SS = counts.reshape(ep, ep, El).sum(-1)        # [src, dst] row counts
    before = _excl_cumsum(SS, axis=0)              # rows ahead of src i on dst j
    kept = np.clip(R - before, 0, SS)              # greedy receive clamp
    off_on_dst = np.minimum(before, R)             # chunk start of src i on dst j
    src_in_off = _excl_cumsum(SS, axis=1)          # span starts in src i's rows
    return {"SS": SS, "kept": kept,
            "in_off": src_in_off[me],              # my span starts      [ep]
            "send": kept[me],                      # rows I send dst j   [ep]
            "out_off": off_on_dst[me],             # where they land     [ep]
            "recv": kept[:, me],                   # rows I get from i   [ep]
            "recv_off": off_on_dst[:, me],         # where I put them    [ep]
            "back_off": src_in_off[:, me]}         # src i's own offset of
                                                   # its chunk to me


def _spans(starts, sizes) -> np.ndarray:
    """The indices of the spans [start, start + size), concatenated."""
    return np.concatenate([np.arange(a, a + n) for a, n in
                           zip(np.ravel(starts), np.ravel(sizes))]
                          + [np.zeros(0, np.int64)]).astype(np.int64)


def moe_block_dropless_ep(cfg: ModelConfig, p: Dict[str, Any],
                          x: torch.Tensor, mesh
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch over the expert group (the JAX package's
    moe_block_dropless_ep, megatron_tpu/ops/moe.py:295): this rank sorts
    its n*k (token, choice) rows by global expert; the [E] counts are
    all-gathered over the expert group into [ep, E] (on the host: the
    split sizes of the exchange, one sync a layer); ep_metadata gives
    the offsets; each rank's rows for expert block j go to rank j
    (parallel/mappings.exchange, uneven splits), land packed in source
    order in a receive buffer of R = ceil(n*k*f) rows, f =
    moe_ep_buffer_factor or ep (dropless for any routing; a smaller f
    clamps greedily in source order, and a clamped row loses that
    expert); the received rows' local experts are painted from the
    counts (no id payload travels), the grouped products run over this
    rank's El experts, the rows return along the mirrored route and the
    gates weight them at home. The buffer's slack tail (JAX: rows of a
    zero trash expert, which never travel back) is not materialized."""
    b, s, h = x.shape
    n, E, k, ep = b * s, cfg.num_experts, cfg.moe_top_k, mesh.ep
    El = E // ep
    f = cfg.moe_ep_buffer_factor
    f = float(ep) if f is None else min(float(f), float(ep))
    R = int(math.ceil(n * k * f))
    me = mesh.index(AXIS_EXPERT)
    group = mesh.group(AXIS_EXPERT)
    xf = x.reshape(n, h)
    logits, gates, topw, topi = _route(cfg, p, xf)
    flat_e, order, rows = _sorted_rows(topi, n, k)
    mine = _one_hot(flat_e, E).sum(0)
    counts = all_gather(mine[None], group, 0).cpu().numpy()  # [ep, E]
    md = ep_metadata(counts, me, ep, El, R)

    # dispatch: the first send[j] rows of my span for expert block j
    sent = _spans(md["in_off"], md["send"])
    sent_t = torch.from_numpy(sent).to(x.device)
    recv_buf = exchange(xf[rows[sent_t]], group, md["send"], md["recv"])

    # the received rows grouped by local expert: source i's chunk holds
    # its rows of experts me*El.. in order, clamped to recv[i]
    Cm = counts[:, me * El:(me + 1) * El]                    # [ep, El]
    rel = _excl_cumsum(Cm, axis=1)
    got = np.clip(md["recv"][:, None] - rel, 0, Cm)          # [ep, El]
    starts = md["recv_off"][:, None] + rel
    perm = _spans(starts.T, got.T)                           # expert-major
    per_expert = got.sum(0)
    perm_t = torch.from_numpy(perm).to(x.device)
    inv_t = torch.from_numpy(np.argsort(perm)).to(x.device)
    local_ids = torch.from_numpy(np.repeat(np.arange(El), per_expert)).to(
        x.device)
    out = _grouped_mlp(cfg, p, recv_buf[perm_t],
                       torch.from_numpy(per_expert).to(x.device), local_ids,
                       mesh)
    back = exchange(out[inv_t], group, md["recv"], md["send"])

    # combine at home: the gates weight the returned rows
    w = topw.reshape(-1)[order][sent_t]
    y = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    y = y.index_add(0, rows[sent_t], back.float() * w[:, None])
    aux = _aux_loss(cfg, logits, gates, topi, mesh)
    return y.to(x.dtype).reshape(b, s, h), aux
