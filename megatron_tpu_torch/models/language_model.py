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

Tensor parallelism (a MeshRuntime as `mesh`, training): the embedding
is vocab-parallel (a masked lookup of this rank's vocab rows, then the
sum over the tensor group, or its reduce-scatter along the sequence
under sequence parallelism), the final hidden states enter the
column-parallel LM head through parallel/mappings.enter_tp, and the
logits are this rank's vocab columns; the loss is then the
vocab-parallel cross-entropy (ops/cross_entropy.py). The pipeline
(training/pipeline.py) runs the same pieces stage by stage. Serving
under tensor parallelism (kv_caches with a mesh, no sequence
parallelism) runs the same layers over caches of this rank's kv heads
[L, B, Smax, nkv/tp, D] and gathers the logits over the tensor group to
[B, S, V] before anyone samples from them.

Context parallelism (mesh.cp > 1, training): tokens, labels, the loss
mask and position ids are this rank's contiguous piece of the sequence
(data/samplers.rank_rows); positions are global, so a piece without
position ids starts at cp_rank * S/cp; the loss a rank backpropagates is
its tokens' sum over the token count of the whole sequence (loss_mean),
whose sum over the context group is the one-sequence mean.

A MoE model's layers each return a router aux loss; lm_loss adds their
sum to the CE (return_moe_aux on lm_forward gives it to other callers).
A weight-quantized serving tree (ops/weight_quant.py) embeds through
take_rows and projects through deq, as the JAX package does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from megatron_tpu_torch.config import ModelConfig, parse_recompute
from megatron_tpu_torch.models.transformer import block_forward
from megatron_tpu_torch.ops.cross_entropy import (
    cross_entropy_loss, vocab_parallel_cross_entropy,
)
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.ops.rotary import precompute_rope
from megatron_tpu_torch.ops.weight_quant import deq, take_rows
from megatron_tpu_torch.parallel.mappings import (
    all_reduce, enter_tp, exit_tp, sp_slice,
)
from megatron_tpu_torch.quant.collectives import gather_logits


def _layers(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of a stacked [L, ...] parameter subtree."""
    per_leaf = {k: (_layers(v, n) if isinstance(v, dict) else v.unbind(0))
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def context_positions(tokens: torch.Tensor, positions, mesh):
    """The positions of a training pass: the given ones, or under
    context parallelism this rank's piece's global positions
    [1, S/cp]; None otherwise (0 .. S-1)."""
    if positions is not None or mesh is None or mesh.cp == 1:
        return positions
    s = tokens.shape[1]
    return (mesh.cp_rank * s + torch.arange(s, device=tokens.device))[None]


def loss_mean(per_token: torch.Tensor, loss_mask: Optional[torch.Tensor],
              mesh) -> torch.Tensor:
    """The masked mean of a microbatch's per-token losses. Under context
    parallelism a rank's share: its masked sum over the mask's count
    summed over the context group (the sum of the shares over the group
    is the mean over the whole sequence)."""
    m = (loss_mask.float() if loss_mask is not None
         else torch.ones_like(per_token))
    count = m.sum()
    if mesh is not None and mesh.cp > 1:
        count = all_reduce(count.detach(), mesh.group("context"))
    return (per_token * m).sum() / count.clamp_min(1.0)


def batch_mean(per_token: torch.Tensor, loss_mask: Optional[torch.Tensor],
               mesh) -> torch.Tensor:
    """The masked mean of per-token losses over the global microbatch,
    as this batch rank's share: its masked sum over the count summed
    over the batch group, times dp (train_step averages the ranks'
    shares over the dp ranks). The JAX loss is the global microbatch's
    token-weighted mean; with unequal counts a mean of each rank's own
    mean would differ (BERT's masked positions, T5's padded targets)."""
    m = (loss_mask.float() if loss_mask is not None
         else torch.ones_like(per_token))
    count = m.sum()
    dp = mesh.dp if mesh is not None else 1
    if dp > 1:
        count = all_reduce(count.detach(), mesh.group(("data", "expert")))
    return (per_token * m).sum() * dp / count.clamp_min(1.0)


def embed_tokens(cfg: ModelConfig, params: Dict[str, Any],
                 tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 mesh=None,
                 tokentype_ids: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embedding, plus the embed/pos rows at `positions` ([B, S] or
    [1, S]; None: 0 .. S-1) for absolute position embeddings (a rotary
    model's positions enter through RoPE), plus the embed/tokentype rows
    at `tokentype_ids` [B, S] when given (BERT's segments). Positions are
    clamped to the table, as a gather on the device must not read past
    it: the engines refuse caches longer than the table, so only padded
    positions that no one reads are clamped. Under tensor parallelism
    the table is this rank's vocab rows: ids outside them embed to zero
    and the tensor group's sum (reduce-scatter under sequence
    parallelism, which then returns this rank's sequence chunk)
    completes each row."""
    table = params["embed"]["tokens"]
    if mesh is None or mesh.tp == 1:
        x = take_rows(table, tokens, cfg.dtype).to(cfg.dtype)
    else:
        rows = table.shape[0]
        local = tokens.long() - mesh.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table).masked_fill(
            ~inside[..., None], 0).to(cfg.dtype)
        x = exit_tp(x, mesh)
    if cfg.position_embedding_type == "absolute":
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        pos = positions.to(tokens.device, torch.long).clamp(
            0, cfg.max_position_embeddings - 1)
        x = x + F.embedding(sp_slice(pos, mesh, dim=-1),
                            params["embed"]["pos"]).to(cfg.dtype)
    if tokentype_ids is not None:
        x = x + F.embedding(
            sp_slice(tokentype_ids.to(tokens.device, torch.long), mesh),
            params["embed"]["tokentype"]).to(cfg.dtype)
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
        return torch.matmul(x, deq(params["embed"]["tokens"], x.dtype).t())
    return torch.matmul(x, deq(params["lm_head"]["w"], x.dtype))


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
    mesh=None,
    return_moe_aux: bool = False,
    tp_comm=None,
    cp_comm=None,
    tokentype_ids: Optional[torch.Tensor] = None,   # [B, S] (BERT segments)
    head_input: bool = True,
):
    """Forward pass to logits [B, S, V] (or, with return_hidden, the
    final-normed hidden states [B, S, h]); with return_moe_aux, (that,
    the layers' summed router aux loss), which a forward with kv_caches
    refuses, as the JAX package does. With a mesh (tensor
    parallelism): without caches logits are this rank's vocab columns
    [B, S, V/tp] (training's vocab-parallel loss reads them) and the
    hidden states are the LM head's input, the whole sequence; with
    kv_caches (serving; each rank's caches hold its nkv/tp heads) the
    logits are gathered over the tensor group to [B, S, V].

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
    and never with caches.

    tp_comm (a quant.TpComm, serving under tensor parallelism): the
    row-parallel reductions and the logits gather at the sites it covers
    run through the compressed collectives (quant/collectives.py), and
    the logits are gathered to [B, S, V] with or without caches, as the
    JAX package's lm_forward(tp_comm=...) returns them. cp_comm (a
    quant.CpComm): context-parallel serving; kv_caches are this rank's
    stripe of the page pools and page_table its local table
    (inference/context_parallel/). tokentype_ids: BERT's segment ids,
    embedded through embed/tokentype (models/bert.py). head_input False
    (with return_hidden): the final-normed hidden states as the last
    layer leaves them, before the LM head's tensor-parallel entry (this
    rank's sequence chunk under sequence parallelism), for heads of
    their own (models/bert.py)."""
    if return_moe_aux and kv_caches is not None:
        raise ValueError("return_moe_aux with kv_caches is ambiguous: "
                         "decode paths don't train the router")
    if kv_caches is not None or tp_comm is not None:
        recompute = "none"
        if mesh is not None and mesh.sequence_parallel:
            raise ValueError("serving under sequence parallelism: the "
                             "engines do not split their sequences")
    if positions is None and kv_caches is not None:
        steps = torch.arange(tokens.shape[1], device=tokens.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            positions = (cache_index.to(tokens.device, torch.long)[:, None]
                         + steps[None, :])
        else:
            positions = int(cache_index) + steps[None, :]
    elif kv_caches is None:
        positions = context_positions(tokens, positions, mesh)

    x = embed_tokens(cfg, params, tokens, positions, mesh=mesh,
                     tokentype_ids=tokentype_ids)

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
            recompute_core=recompute_granularity(recompute) == "selective",
            page_table=page_table, page_write_start=page_write_start,
            page_write_end=page_write_end, mesh=mesh, tp_comm=tp_comm,
            cp_comm=cp_comm))
    x, moe_aux = run_layers(layers, x, recompute)

    x = final_hidden_norm(cfg, params, x)
    if return_hidden and not head_input:
        return (x, moe_aux) if return_moe_aux else x
    x = enter_tp(x, mesh)
    if return_hidden:
        return (x, moe_aux) if return_moe_aux else x
    logits = lm_logits(cfg, params, x)
    if ((kv_caches is not None or tp_comm is not None)
            and mesh is not None and mesh.tp > 1):
        logits = gather_logits(logits, mesh, tp_comm)
    if return_moe_aux:
        return logits, moe_aux
    if kv_caches is not None:
        return logits, kv_caches
    return logits


def recompute_granularity(recompute: str) -> str:
    """The policy's granularity as the layer loop applies it: nothing is
    recomputed outside a recorded backward."""
    gran, n_rc = parse_recompute(recompute)
    if not torch.is_grad_enabled():
        return "none"
    if gran == "uniform" and n_rc == 1:
        return "full"
    return gran


def run_layers(layers: List[Any], x: torch.Tensor,
               recompute: str = "none"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x through `layers` (callables x -> (y, cache, moe_aux)) under a
    recompute policy (the module docstring) -> (y, the layers' summed
    moe_aux); a pipeline stage applies it to its own chunk of layers, as
    the reference applies the budget per stage."""
    gran = recompute_granularity(recompute)
    n_rc = parse_recompute(recompute)[1]
    if gran == "uniform" and len(layers) % n_rc:
        raise ValueError(
            f"uniform:{n_rc} needs the layer count ({len(layers)}) "
            "divisible by the chunk size")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def remat(layer, x):
        y, _, a = checkpoint(layer, x, use_reentrant=False)
        return y, a

    if gran == "uniform":
        def chunk(x, lo):
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for layer in layers[lo:lo + n_rc]:
                x, a = remat(layer, x)
                total = total + a
            return x, total

        for lo in range(0, len(layers), n_rc):
            x, a = checkpoint(chunk, x, lo, use_reentrant=False)
            aux = aux + a
    else:
        for i, layer in enumerate(layers):
            if gran == "full" or (gran == "block" and i < n_rc):
                x, a = remat(layer, x)
            else:
                x, _, a = layer(x)
            aux = aux + a
    return x, aux


def token_losses(cfg: ModelConfig, params: Dict[str, Any],
                 hidden: torch.Tensor, labels: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Per-token CE [B, S] of the LM head's input `hidden` (chunked by
    cfg.ce_chunk_size when the chunk tiles the sequence); with tensor
    parallelism the vocab-parallel CE over this rank's logits."""
    if cfg.ce_chunk_size and hidden.shape[1] % cfg.ce_chunk_size == 0:
        return chunked_lm_loss_tokens(cfg, params, hidden, labels, mesh)
    return _ce(lm_logits(cfg, params, hidden), labels, mesh)[1]


def _ce(logits, labels, mesh, loss_mask=None):
    if mesh is not None and mesh.tp > 1:
        return vocab_parallel_cross_entropy(logits, labels, mesh,
                                            loss_mask=loss_mask)
    return cross_entropy_loss(logits, labels, loss_mask=loss_mask)


def chunked_lm_loss_tokens(cfg: ModelConfig, params: Dict[str, Any],
                           hidden: torch.Tensor,     # [B, S, h] final-normed
                           labels: torch.Tensor,     # [B, S]
                           mesh=None) -> torch.Tensor:
    """Per-token CE [B, S] over sequence chunks of cfg.ce_chunk_size
    tokens, LM head included, each chunk's logits recomputed in the
    backward (a checkpoint per chunk): the [B, S, V] logits and their
    fp32 CE intermediates never exist at once; the extra peak is one
    [B, C, V] chunk. The same numbers as the unchunked path — CE is
    independent per token."""
    C = cfg.ce_chunk_size

    def chunk_loss(h_c, y_c):
        return _ce(lm_logits(cfg, params, h_c), y_c, mesh)[1]

    out = []
    for c0 in range(0, hidden.shape[1], C):
        h_c, y_c = hidden[:, c0:c0 + C], labels[:, c0:c0 + C]
        if torch.is_grad_enabled():
            out.append(checkpoint(chunk_loss, h_c, y_c, use_reentrant=False))
        else:
            out.append(chunk_loss(h_c, y_c))
    return torch.cat(out, dim=1)


def lm_loss(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor], recompute: str = "none",
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss on a batch dict with keys tokens [B, S], labels
    [B, S], optional loss_mask [B, S] and position_ids: per-token CE
    weighted by loss_mask. Returns (mean, {"lm_loss", "ntokens"}); a MoE
    model returns mean + the router aux loss, and aux["moe_aux_loss"]
    (lm_loss stays the pure CE). mesh: tensor parallelism (the
    vocab-parallel CE)."""
    moe = cfg.num_experts is not None
    S = batch["tokens"].shape[1]
    # unchunked when the chunk does not tile this batch's sequence;
    # C == S still chunks (the single recomputed chunk drops the forward
    # logits copy)
    chunked = bool(cfg.ce_chunk_size) and S % cfg.ce_chunk_size == 0
    out = lm_forward(cfg, params, batch["tokens"],
                     positions=batch.get("position_ids"),
                     recompute=recompute, return_hidden=chunked, mesh=mesh,
                     return_moe_aux=moe)
    out, moe_aux = out if moe else (out, None)
    loss_mask = batch.get("loss_mask")
    if mesh is not None and mesh.cp > 1:
        per_token = (chunked_lm_loss_tokens(cfg, params, out,
                                            batch["labels"], mesh)
                     if chunked else _ce(out, batch["labels"], mesh)[1])
        mean = loss_mean(per_token, loss_mask, mesh)
    elif chunked:
        per_token = chunked_lm_loss_tokens(cfg, params, out,
                                           batch["labels"], mesh)
        if loss_mask is not None:
            m = loss_mask.float()
            mean = (per_token * m).sum() / m.sum().clamp_min(1.0)
        else:
            mean = per_token.mean()
    else:
        mean, per_token = _ce(out, batch["labels"], mesh,
                              loss_mask=loss_mask)
    ntokens = (loss_mask.sum() if loss_mask is not None
               else per_token.new_tensor(float(per_token.numel())))
    aux = {"lm_loss": mean, "ntokens": ntokens}
    if moe:
        aux["moe_aux_loss"] = moe_aux
        return mean + moe_aux, aux
    return mean, aux
