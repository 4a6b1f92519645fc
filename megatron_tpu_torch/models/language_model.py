"""Full language model: embedding -> decoder stack -> logits
(counterpart of megatron_tpu/models/language_model.py, inference forms).

The stack is a Python loop over layers (the JAX package scans stacked
params with lax.scan); each layer reads views of the stacked [L, ...]
tensors, and each layer's cache is a view of the stacked
[L, B, S, nkv, D] cache, so in-place cache writes land in the stack.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.transformer import block_forward
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.ops.rotary import precompute_rope


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer i of a stacked [L, ...] parameter subtree."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def embed_tokens(cfg: ModelConfig, params: Dict[str, Any],
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding (positions enter through RoPE)."""
    return F.embedding(tokens, params["embed"]["tokens"]).to(cfg.dtype)


def final_hidden_norm(cfg: ModelConfig, params: Dict[str, Any],
                      x: torch.Tensor) -> torch.Tensor:
    return norm_forward(cfg.normalization, x, params["final_ln"]["scale"],
                        params["final_ln"].get("bias"),
                        cfg.layernorm_epsilon)


def lm_logits(cfg: ModelConfig, params: Dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    """Hidden states -> vocab logits, tied or untied."""
    if cfg.tie_embed_logits:
        return torch.matmul(x, params["embed"]["tokens"].t())
    return torch.matmul(x, params["lm_head"]["w"])


def lm_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,                        # [B, S] int
    positions: Optional[torch.Tensor] = None,
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index=None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] True = attend
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Forward pass to logits [B, S, V].

    kv_caches: stacked per-layer caches [L, B, Smax, nkv, D] x2, updated
    in place; when given, returns (logits, kv_caches). cache_index is an
    int (every row at the same depth) or a [B] tensor (continuous-batching
    slot cache, every row at its own depth).

    rope: a precomputed (cos, sin) table covering every position this
    call uses; None builds one here (at the cache length with caches, as
    the JAX package does). A serving engine builds its table once."""
    if positions is None and kv_caches is not None:
        steps = torch.arange(tokens.shape[1], device=tokens.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            positions = (cache_index.to(tokens.device, torch.long)[:, None]
                         + steps[None, :])
        else:
            positions = int(cache_index) + steps[None, :]

    x = embed_tokens(cfg, params, tokens)

    if rope is None:
        rope_len = (kv_caches[0].shape[2] if kv_caches is not None
                    else max(cfg.seq_length, tokens.shape[1]))
        rope = precompute_rope(cfg.head_dim, rope_len, cfg.rope_theta,
                               cfg.rope_scaling_factor, device=x.device)

    for i in range(cfg.num_layers):
        cache = None if kv_caches is None else (kv_caches[0][i],
                                                kv_caches[1][i])
        x, _ = block_forward(cfg, _layer(params["layers"], i), x, rope,
                             positions, kv_cache=cache,
                             cache_index=cache_index,
                             padding_mask=attention_mask)

    logits = lm_logits(cfg, params, final_hidden_norm(cfg, params, x))
    if kv_caches is not None:
        return logits, kv_caches
    return logits
