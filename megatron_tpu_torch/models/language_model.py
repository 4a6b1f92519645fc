"""Full language model: embedding -> decoder stack -> logits / loss
(counterpart of megatron_tpu/models/language_model.py).

The stack is a Python loop over layers (the JAX package scans stacked
params with lax.scan). Each layer reads its slice of the stacked
[L, ...] tensors through one unbind per leaf, whose backward stacks the
L slices' gradients in a single pass (indexing v[i] per layer would
build a full-size zero gradient per layer instead). Each layer's cache
is a view of the stacked [L, B, S, nkv, D] cache (or of the paged pools
[L, P, ps, nkv, D]), so in-place cache writes land in the stack.

Activation recompute maps the JAX package's scan_with_remat policies onto
torch.utils.checkpoint (use_reentrant=False):
  * "none"      saves everything;
  * "selective" checkpoints the core attention of every layer (the
    reference's checkpointed core attention; JAX's
    dots_with_no_batch_dims_saveable keeps the weight-matmul outputs and
    recomputes the rest);
  * "full"      checkpoints each whole block;
  * "block:N"   checkpoints each of the first N blocks and saves the
    rest (the reference's --recompute_method block);
  * "uniform:N" checkpoints chunks of N blocks, and each block inside a
    chunk again, so the backward keeps L/N chunk inputs and replays a
    chunk's N blocks one by one (the JAX package's two-level remat; N
    must divide L; uniform:1 is "full").
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from megatron_tpu_torch.config import ModelConfig, parse_recompute
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
                 tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding, plus the embed/pos rows at `positions` ([B, S] or
    [1, S]; None: 0 .. S-1) for absolute position embeddings (a rotary
    model's positions enter through RoPE). Positions are clamped to the
    table, as a gather on the device must not read past it: the engines
    refuse caches longer than the table, so only padded positions that
    no one reads are clamped."""
    x = F.embedding(tokens, params["embed"]["tokens"]).to(cfg.dtype)
    if cfg.position_embedding_type == "absolute":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        pos = positions.to(tokens.device, torch.long).clamp(
            0, cfg.max_position_embeddings - 1)
        x = x + F.embedding(pos, params["embed"]["pos"]).to(cfg.dtype)
    return x


def final_hidden_norm(cfg: ModelConfig, params: Dict[str, Any],
                      x: torch.Tensor) -> torch.Tensor:
    """The final stack norm; the identity under post-LN, where each layer
    ends with its own norm."""
    if cfg.use_post_ln:
        return x
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
    kv_caches: Optional[Tuple[torch.Tensor, ...]] = None,
    cache_index=None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] True = attend
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    recompute: str = "none",
    return_hidden: bool = False,
    page_table: Optional[torch.Tensor] = None,     # [B, max_pages] int32
    page_write_start: Optional[int] = None,
    page_write_end: Optional[int] = None,
):
    """Forward pass to logits [B, S, V] (or, with return_hidden, the
    final-normed hidden states [B, S, h]).

    kv_caches: stacked per-layer caches [L, B, Smax, nkv, D] x2 (or the
    int8 4-tuple of ops/kv_quant.py, scales [L, B, Smax, nkv, 1]), updated
    in place; when given, returns (logits, kv_caches). cache_index is an
    int (every row at the same depth) or a [B] tensor (continuous-batching
    slot cache, every row at its own depth).

    page_table: the caches are PAGED pools [L, num_pages, page_size, nkv,
    D] (inference/paging/) shared by every slot; row b's logical context
    is the pages page_table[b], the same table for every layer.
    page_write_start/end fence a prefill chunk's writes
    (transformer.attention_block).

    rope: a precomputed (cos, sin) table covering every position this
    call uses; None builds one here for a rotary model (at the cache
    length with caches, or max_pages * page_size with paged pools, as the
    JAX package does). A serving engine builds its table once. Models
    with absolute position embeddings have none.

    recompute: the activation-recompute policy of a training pass (see
    the module docstring); it takes effect only while autograd records
    and never with caches."""
    gran, n_rc = parse_recompute(recompute)
    if kv_caches is not None or not torch.is_grad_enabled():
        gran = "none"
    if gran == "uniform" and n_rc == 1:
        gran = "full"
    if gran == "uniform" and cfg.num_layers % n_rc:
        raise ValueError(
            f"uniform:{n_rc} needs the layer count ({cfg.num_layers}) "
            "divisible by the chunk size")
    if positions is None and kv_caches is not None:
        steps = torch.arange(tokens.shape[1], device=tokens.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            positions = (cache_index.to(tokens.device, torch.long)[:, None]
                         + steps[None, :])
        else:
            positions = int(cache_index) + steps[None, :]

    x = embed_tokens(cfg, params, tokens, positions)

    if rope is None and cfg.position_embedding_type == "rotary":
        if kv_caches is not None and page_table is not None:
            # paged pools are [L, num_pages, page_size, ...]: the logical
            # max length is the table width x page size, not shape[2]
            rope_len = page_table.shape[-1] * kv_caches[0].shape[2]
        elif kv_caches is not None:
            rope_len = kv_caches[0].shape[2]
        else:
            rope_len = max(cfg.seq_length, tokens.shape[1])
        rope = precompute_rope(cfg.head_dim, rope_len, cfg.rope_theta,
                               cfg.rope_scaling_factor, device=x.device)

    layers = []
    for i, lp in enumerate(_layers(params["layers"], cfg.num_layers)):
        cache = None if kv_caches is None else tuple(c[i]
                                                     for c in kv_caches)
        layers.append(functools.partial(
            block_forward, cfg, lp, rope=rope, positions=positions,
            kv_cache=cache, cache_index=cache_index,
            padding_mask=attention_mask,
            recompute_core=gran == "selective",
            page_table=page_table, page_write_start=page_write_start,
            page_write_end=page_write_end))

    def remat(layer, x):
        return checkpoint(layer, x, use_reentrant=False)[0]

    if gran == "uniform":
        def chunk(x, lo):
            for layer in layers[lo:lo + n_rc]:
                x = remat(layer, x)
            return x

        for lo in range(0, cfg.num_layers, n_rc):
            x = checkpoint(chunk, x, lo, use_reentrant=False)
    else:
        for i, layer in enumerate(layers):
            if gran == "full" or (gran == "block" and i < n_rc):
                x = remat(layer, x)
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
