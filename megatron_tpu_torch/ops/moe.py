"""Mixture-of-Experts layer with top-k routing (counterpart of
megatron_tpu/ops/moe.py, its single-device forms).

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
    (top-1 assignment fractions f, mean router probabilities P, both over
    all N tokens) plus the ST-MoE router z-loss mean(logsumexp^2), each
    with its coefficient.

Expert parallelism (moe_block_dropless_ep and its exchanges) is not
ported: MoE runs at world size 1 (models/params.check_mesh).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import apply_activation


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


def _aux_losses(cfg: ModelConfig, logits: torch.Tensor, gates: torch.Tensor,
                top1_frac: torch.Tensor) -> torch.Tensor:
    """Switch load balance + router z-loss, fp32 scalar; top1_frac [E]
    is the mean top-1 assignment over all tokens."""
    prob = gates.reshape(-1, cfg.num_experts).mean(0)
    z_sq = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    lb = cfg.num_experts * (top1_frac * prob).sum()
    return (cfg.moe_aux_loss_coeff * lb
            + cfg.moe_z_loss_coeff * z_sq).float()


def _expert_mlp(cfg: ModelConfig, p: Dict[str, Any], xe: torch.Tensor):
    """The experts' MLPs over per-expert batches xe [E, R, h] -> [E, R, h]."""
    hmid = torch.bmm(xe, p["w_in"])
    if "b_in" in p:
        hmid = hmid + p["b_in"][:, None, :]
    hmid = apply_activation(cfg.activation, hmid)
    out = torch.bmm(hmid, p["w_out"])
    if "b_out" in p:
        out = out + p["b_out"][:, None, :]
    return out


def moe_block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's MoE FFN: x [B, S, h] -> (y [B, S, h], aux fp32 scalar).
    p: router [h, E], w_in [E, h, Fin], w_out [E, F, h] (+ b_in, b_out)."""
    if cfg.moe_dispatch == "dropless":
        return moe_block_dropless(cfg, p, x)
    b, s, h = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    # Sg divides the runtime S (a decode tick's S = 1, a prefill bucket)
    Sg = _group_for(s, moe_group_size(cfg))
    G = b * s // Sg
    xg = x.reshape(G, Sg, h)
    logits, gates, topw, topi = _route(cfg, p, xg)           # [G, Sg, *]
    C = moe_capacity(cfg, Sg)
    pos, keep = _slots(topi, E, C)                           # [G, Sg, k]
    aux = _aux_losses(cfg, logits, gates,
                      _one_hot(topi[..., 0], E).float().mean((0, 1)))

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
    out = _expert_mlp(cfg, p, xe)
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


def moe_block_dropless(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dropless dispatch: no token is dropped and no [.., E, C]
    tensor exists; the experts do exactly N*k rows."""
    b, s, h = x.shape
    N, E, k = b * s, cfg.num_experts, cfg.moe_top_k
    xf = x.reshape(N, h)
    logits, gates, topw, topi = _route(cfg, p, xf)

    flat_e = topi.reshape(-1)                                # [N*k]
    order = torch.argsort(flat_e, stable=True)
    rows = torch.arange(N, device=x.device).repeat_interleave(k)[order]
    counts = _one_hot(flat_e, E).sum(0)
    xs = xf[rows]
    hmid = _grouped(xs, p["w_in"], counts)
    expert_of_row = flat_e[order]
    if "b_in" in p:
        hmid = hmid + p["b_in"][expert_of_row]
    hmid = apply_activation(cfg.activation, hmid.to(x.dtype))
    out = _grouped(hmid, p["w_out"], counts)
    if "b_out" in p:
        out = out + p["b_out"][expert_of_row]
    w = topw.reshape(-1)[order]
    y = torch.zeros((N, h), dtype=torch.float32, device=x.device)
    y = y.index_add(0, rows, out.float() * w[:, None])
    aux = _aux_losses(cfg, logits, gates,
                      _one_hot(topi[:, 0], E).float().mean(0))
    return y.to(x.dtype).reshape(b, s, h), aux
