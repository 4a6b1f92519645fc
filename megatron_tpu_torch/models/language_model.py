"""Full language model: embedding -> decoder stack -> logits / loss
(counterpart of megatron_tpu/models/language_model.py).

The stack is a Python loop over layers (the JAX package scans stacked
params with lax.scan). Each layer reads its slice of the stacked
[L, ...] tensors through one unbind per leaf, whose backward stacks the
L slices' gradients in a single pass (indexing v[i] per layer would
build a full-size zero gradient per layer instead). Each layer's cache
is a view of the stacked [L, B, S, nkv, D] cache, so in-place cache
writes land in the stack.

Activation recompute maps the JAX package's scan_with_remat policies onto
torch.utils.checkpoint (use_reentrant=False):
  * "none"      saves everything;
  * "selective" checkpoints the core attention of every layer (the
    reference's checkpointed core attention; JAX's
    dots_with_no_batch_dims_saveable keeps the weight-matmul outputs and
    recomputes the rest);
  * "full"      checkpoints each whole block.
"block:N" and "uniform:N" are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from megatron_tpu_torch.config import RECOMPUTE_POLICIES, ModelConfig
from megatron_tpu_torch.models.transformer import block_forward
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.ops.rotary import precompute_rope


def _layers(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of a stacked [L, ...] parameter subtree."""
    per_leaf = {k: (_layers(v, n) if isinstance(v, dict) else v.unbind(0))
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


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
    recompute: str = "none",
    return_hidden: bool = False,
):
    """Forward pass to logits [B, S, V] (or, with return_hidden, the
    final-normed hidden states [B, S, h]).

    kv_caches: stacked per-layer caches [L, B, Smax, nkv, D] x2, updated
    in place; when given, returns (logits, kv_caches). cache_index is an
    int (every row at the same depth) or a [B] tensor (continuous-batching
    slot cache, every row at its own depth).

    rope: a precomputed (cos, sin) table covering every position this
    call uses; None builds one here (at the cache length with caches, as
    the JAX package does). A serving engine builds its table once.

    recompute: the activation-recompute policy of a training pass (see
    the module docstring); it takes effect only while autograd records
    and never with caches."""
    if recompute not in RECOMPUTE_POLICIES:
        raise ValueError(f"unknown recompute policy {recompute!r}; one of "
                         f"{RECOMPUTE_POLICIES}")
    if kv_caches is not None or not torch.is_grad_enabled():
        recompute = "none"
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

    for i, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
        cache = None if kv_caches is None else (kv_caches[0][i],
                                                kv_caches[1][i])
        layer = functools.partial(
            block_forward, cfg, lp, rope=rope, positions=positions,
            kv_cache=cache, cache_index=cache_index,
            padding_mask=attention_mask,
            recompute_core=recompute == "selective")
        if recompute == "full":
            x, _ = checkpoint(layer, x, use_reentrant=False)
        else:
            x, _ = layer(x)

    x = final_hidden_norm(cfg, params, x)
    if return_hidden:
        return x
    logits = lm_logits(cfg, params, x)
    if kv_caches is not None:
        return logits, kv_caches
    return logits


def chunked_lm_loss_tokens(cfg: ModelConfig, params: Dict[str, Any],
                           hidden: torch.Tensor,     # [B, S, h] final-normed
                           labels: torch.Tensor      # [B, S]
                           ) -> torch.Tensor:
    """Per-token CE [B, S] over sequence chunks of cfg.ce_chunk_size
    tokens, LM head included, each chunk's logits recomputed in the
    backward (a checkpoint per chunk): the [B, S, V] logits and their
    fp32 CE intermediates never exist at once; the extra peak is one
    [B, C, V] chunk. The same numbers as the unchunked path — CE is
    independent per token."""
    C = cfg.ce_chunk_size

    def chunk_loss(h_c, y_c):
        return cross_entropy_loss(lm_logits(cfg, params, h_c), y_c)[1]

    out = []
    for c0 in range(0, hidden.shape[1], C):
        h_c, y_c = hidden[:, c0:c0 + C], labels[:, c0:c0 + C]
        if torch.is_grad_enabled():
            out.append(checkpoint(chunk_loss, h_c, y_c, use_reentrant=False))
        else:
            out.append(chunk_loss(h_c, y_c))
    return torch.cat(out, dim=1)


def lm_loss(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], recompute: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss on a batch dict with keys tokens [B, S], labels
    [B, S], optional loss_mask [B, S] and position_ids: per-token CE
    weighted by loss_mask. Returns (mean, {"lm_loss", "ntokens"})."""
    S = batch["tokens"].shape[1]
    # unchunked when the chunk does not tile this batch's sequence;
    # C == S still chunks (the single recomputed chunk drops the forward
    # logits copy)
    chunked = bool(cfg.ce_chunk_size) and S % cfg.ce_chunk_size == 0
    out = lm_forward(cfg, params, batch["tokens"],
                     positions=batch.get("position_ids"),
                     recompute=recompute, return_hidden=chunked)
    loss_mask = batch.get("loss_mask")
    if chunked:
        per_token = chunked_lm_loss_tokens(cfg, params, out, batch["labels"])
        if loss_mask is not None:
            m = loss_mask.float()
            mean = (per_token * m).sum() / m.sum().clamp_min(1.0)
        else:
            mean = per_token.mean()
    else:
        mean, per_token = cross_entropy_loss(out, batch["labels"],
                                             loss_mask=loss_mask)
    ntokens = (loss_mask.sum() if loss_mask is not None
               else per_token.new_tensor(float(per_token.numel())))
    return mean, {"lm_loss": mean, "ntokens": ntokens}
