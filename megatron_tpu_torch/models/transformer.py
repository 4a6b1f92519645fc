"""The transformer decoder block (counterpart of
megatron_tpu/models/transformer.py), for serving and training.

Pre-LN Llama/GPT block: norm -> attention (GQA, RoPE, optional window)
-> residual -> norm -> MLP -> residual. KV caches are dense
[B, max_seq, nkv, D] buffers written IN PLACE (the JAX package threads
them functionally and donates them under jit; PyTorch mutates the
buffer instead). The training form is the same block without a cache,
with positions from the batch; selective recompute checkpoints its core
attention. fp8, weight quantization, MoE, paging, int8 caches, dropout
and explicit TP/CP collectives are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import apply_activation
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.ops.rotary import apply_rotary_emb

KVCache = Tuple[torch.Tensor, torch.Tensor]


def _norm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor):
    return norm_forward(cfg.normalization, x, p["scale"], p.get("bias"),
                        cfg.layernorm_epsilon)


def attention_block(
    cfg: ModelConfig,
    p: Dict[str, Any],          # layers/attn subtree of one layer
    x: torch.Tensor,            # [B, S, h] (already normed)
    rope: Tuple[torch.Tensor, torch.Tensor],   # (cos, sin) tables
    positions: Optional[torch.Tensor],
    kv_cache: Optional[KVCache] = None,
    cache_index=None,
    padding_mask: Optional[torch.Tensor] = None,
    recompute_core: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (out [B, S, h], kv_cache).

    recompute_core: checkpoint the core attention (selective recompute):
    its forward runs again in the backward instead of saving its
    internals — the reference's checkpointed core attention.

    cache_index: an int writes this pass's K/V at positions
    cache_index..cache_index+S-1 of every row and attends causally from
    q_offset = cache_index; a [B] tensor is the continuous-batching slot
    cache, where row b writes at its own depth cache_index[b] and
    attends its own valid prefix (kv_lengths = cache_index + 1). S == 1
    is plain decode, S > 1 the speculative verify."""
    b, s, _ = x.shape
    D = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads

    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nq, D)
    k = k.reshape(b, s, nkv, D)
    v = v.reshape(b, s, nkv, D)

    q, k = apply_rotary_emb(q, k, rope[0], rope[1], positions)

    per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    q_offset = 0
    kv_lengths = None
    if kv_cache is not None:
        # in-place cache writes take the place of the JAX package's
        # functional update + buffer donation
        kc, vc = kv_cache
        if per_slot:
            rows = torch.arange(b, device=x.device)
            idx = cache_index.to(device=x.device, dtype=torch.long)
            if s == 1:
                kc[rows, idx] = k[:, 0].to(kc.dtype)
                vc[rows, idx] = v[:, 0].to(vc.dtype)
            else:
                pos = idx[:, None] + torch.arange(s, device=x.device)
                kc[rows[:, None], pos] = k.to(kc.dtype)
                vc[rows[:, None], pos] = v.to(vc.dtype)
            kv_lengths = (idx + 1).to(torch.int32)
        else:
            ci = int(cache_index)
            kc[:, ci:ci + s] = k.to(kc.dtype)
            vc[:, ci:ci + s] = v.to(vc.dtype)
            q_offset = ci
        k, v = kc, vc

    if cfg.attn_mask_type == "padding" and padding_mask is None:
        raise ValueError(
            "attn_mask_type='padding' requires an attention_mask input — "
            "running without one would silently attend to pad tokens")
    core = functools.partial(
        attention,
        mask_type=("bidirectional" if cfg.attn_mask_type == "padding"
                   else cfg.attn_mask_type),
        padding_mask=padding_mask,
        sliding_window=cfg.sliding_window_size,
        q_offset=q_offset,
        impl=cfg.attention_impl,
        softmax_fp32=cfg.softmax_fp32,
        kv_lengths=kv_lengths,
        flash_bwd=cfg.flash_bwd,
    )
    if recompute_core and torch.is_grad_enabled():
        ctx = checkpoint(core, q, k, v, use_reentrant=False)
    else:
        ctx = core(q, k, v)
    out = torch.matmul(ctx.reshape(b, s, nq * D), p["wo"])
    if "bo" in p:
        out = out + p["bo"]
    return out, kv_cache


def mlp_block(cfg: ModelConfig, p: Dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, p["w_in"])
    if "b_in" in p:
        h = h + p["b_in"]
    h = apply_activation(cfg.activation, h)
    out = torch.matmul(h, p["w_out"])
    if "b_out" in p:
        out = out + p["b_out"]
    return out


def block_forward(
    cfg: ModelConfig,
    lp: Dict[str, Any],       # one layer's params
    x: torch.Tensor,          # [B, S, h]
    rope: Tuple[torch.Tensor, torch.Tensor],
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    cache_index=None,
    padding_mask: Optional[torch.Tensor] = None,
    recompute_core: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One pre-LN decoder layer -> (y, kv_cache)."""
    attn_out, kv_cache = attention_block(
        cfg, lp["attn"], _norm(cfg, lp["ln1"], x), rope, positions,
        kv_cache=kv_cache, cache_index=cache_index,
        padding_mask=padding_mask, recompute_core=recompute_core)
    y = x + attn_out
    y = y + mlp_block(cfg, lp["mlp"], _norm(cfg, lp["ln2"], y))
    return y, kv_cache
