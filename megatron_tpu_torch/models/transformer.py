"""The transformer decoder block (counterpart of
megatron_tpu/models/transformer.py), for serving and training.

Pre-LN Llama/GPT block: norm -> attention (GQA, RoPE, optional window)
-> residual -> norm -> MLP -> residual; the Falcon form (parallel_attn)
adds attention and MLP of the same norm in one residual, and the post-LN
form norms each layer's output instead of its input. KV caches are dense
[B, max_seq, nkv, D] buffers written IN PLACE (the JAX package threads
them functionally and donates them under jit; PyTorch mutates the
buffer instead). The training form is the same block without a cache,
with positions from the batch; selective recompute checkpoints its core
attention. The paged form writes K/V through a page table into the
shared page pools [P, ps, nkv, D] (inference/paging/). A cache of four
tensors is the int8 form (ops/kv_quant.py): int8 K/V with fp32 scales
[..., 1], quantized on write and dequantized whole for attention.

Tensor parallelism (a MeshRuntime as `mesh`, training and serving): the
layer params are this rank's slices (models/params.py), so Q/K/V and
w_in are column-parallel over the local heads (nq/tp, nkv/tp) and FFN
columns, wo and w_out row-parallel; each block enters through
parallel/mappings.enter_tp, and attention_block and mlp_block return
their row-parallel partial sums: block_forward reduces them through
exit_tp (an all-reduce, or under sequence parallelism an all-gather in
and a reduce-scatter out) and adds a row-parallel bias once, after the
reduce. The parallel (Falcon) block reduces the sum of its two branches
in one collective. Without a mesh (or at tp 1) both are the identity. A
serving rank's caches hold its nkv/tp heads (the int8 form's scales
too), so each rank writes and attends over its own heads.

A MoE model's FFN is ops/moe.moe_block over the layer's moe subtree
(under tensor parallelism its partial sums, reduced by exit_tp as the
MLP's are; expert parallelism inside it), and block_forward returns the layer's router aux loss beside its output
(a zero for dense models), as the JAX block does. Weight-quantized
serving trees (ops/weight_quant.py) reach the products through deq: one
layer's leaf dequantized at its use. With cfg.fp8_format the block's
projections (wq, wk, wv, wo, w_in, w_out; not the MoE experts, as in
the JAX package) go through ops/fp8.maybe_fp8_matmul, their amax agreed
over the ranks that shard each operand. Under context parallelism
(mesh.cp > 1) x is this rank's piece of the sequence and the core
attention gets the mesh (ops/attention.py's context-parallel dispatch);
positions are global. Dropout is not ported.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import apply_activation
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.fp8 import maybe_fp8_matmul
from megatron_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from megatron_tpu_torch.ops.moe import moe_block
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.ops.rotary import apply_rotary_emb
from megatron_tpu_torch.ops.weight_quant import deq
from megatron_tpu_torch.parallel.mappings import enter_tp, exit_tp
from megatron_tpu_torch.quant.collectives import tp_reduce

#: (k, v), or the int8 form (k_q, v_q, k_scale, v_scale)
KVCache = Tuple[torch.Tensor, ...]


def _norm(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor):
    return norm_forward(cfg.normalization, x, p["scale"], p.get("bias"),
                        cfg.layernorm_epsilon)


def attention_block(
    cfg: ModelConfig,
    p: Dict[str, Any],          # layers/attn subtree of one layer
    x: torch.Tensor,            # [B, S, h] (already normed)
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (cos, sin)
    positions: Optional[torch.Tensor],
    kv_cache: Optional[KVCache] = None,
    cache_index=None,
    padding_mask: Optional[torch.Tensor] = None,
    recompute_core: bool = False,
    page_table: Optional[torch.Tensor] = None,
    page_write_start: Optional[int] = None,
    page_write_end: Optional[int] = None,
    mesh=None,
    cp_comm=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (out [B, S, h], kv_cache): out is the output
    projection's row-parallel partial sums, without its bias "bo"
    (block_forward reduces it and adds the bias; without tensor
    parallelism the sums are whole).

    rope: the (cos, sin) tables of a rotary model; None for absolute
    position embeddings (added to the token embedding instead).

    recompute_core: checkpoint the core attention (selective recompute):
    its forward runs again in the backward instead of saving its
    internals — the reference's checkpointed core attention.

    cache_index: an int writes this pass's K/V at positions
    cache_index..cache_index+S-1 of every row and attends causally from
    q_offset = cache_index; a [B] tensor is the continuous-batching slot
    cache, where row b writes at its own depth cache_index[b] and
    attends its own valid prefix (kv_lengths = cache_index + 1). S == 1
    is plain decode, S > 1 the speculative verify.

    page_table [B, max_pages] int32: kv_cache is this layer's paged pools
    [P, ps, nkv, D]. A [B] cache_index writes row b's new K/V at its own
    depth through its table row (decode, or the multi-token verify form);
    an int cache_index is a prefill chunk of ONE row at positions
    cache_index..cache_index+S-1. Chunk writes at positions outside
    [page_write_start, page_write_end) go to the scratch page 0: the first
    chunk after a prefix-cache hit starts one position inside the shared
    span, and the start fence keeps that overlap query from rewriting a
    refcount-shared page (shared pages are copy-on-write: never written
    through a sharer's table); the end fence parks the final chunk's
    padded-tail writes on scratch.

    cp_comm (a quant.CpComm; context-parallel serving): kv_cache is this
    rank's stripe of the paged pools and page_table its local table
    [B, mpl]; the write and the attention are
    inference/context_parallel/ring_kv.paged_ring_attention's."""
    x = enter_tp(x, mesh)
    b, s, _ = x.shape
    D = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads
    if mesh is not None:
        nq, nkv = nq // mesh.tp, nkv // mesh.tp

    q = maybe_fp8_matmul(cfg, x, deq(p["wq"], x.dtype), mesh)
    k = maybe_fp8_matmul(cfg, x, deq(p["wk"], x.dtype), mesh)
    v = maybe_fp8_matmul(cfg, x, deq(p["wv"], x.dtype), mesh)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nq, D)
    k = k.reshape(b, s, nkv, D)
    v = v.reshape(b, s, nkv, D)

    if cfg.position_embedding_type == "rotary":
        q, k = apply_rotary_emb(q, k, rope[0], rope[1], positions)

    per_slot = isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1
    if cp_comm is not None:
        from megatron_tpu_torch.inference.context_parallel.ring_kv import (
            paged_ring_attention,
        )

        if kv_cache is None or len(kv_cache) != 2 or page_table is None:
            raise ValueError("context-parallel attention takes a rank's "
                             "bf16 page pools and its local table")
        ctx = paged_ring_attention(
            cp_comm, q, k, v, kv_cache, page_table, cache_index, per_slot,
            page_write_start, page_write_end, cfg.sliding_window_size,
            kernel=cfg.attention_impl != "xla")
        ctx = ctx.reshape(b, s, nq * D)
        return maybe_fp8_matmul(cfg, ctx, deq(p["wo"], ctx.dtype),
                                mesh), kv_cache
    paged = page_table is not None
    if paged:
        if kv_cache is None:
            raise ValueError("page_table requires a (paged) kv_cache")
        if not per_slot and b != 1:
            raise ValueError(
                f"paged chunked prefill is single-row (batch {b})")

    def _paged_write(store, new):
        """Scatter new [B, s, nkv, D] rows through the page table into
        store [P, ps, nkv, D], in place. Logical pages past the table
        clamp to its last entry (only fenced or never-read positions get
        there, as with the JAX package's clipped take)."""
        ps, max_pages = store.shape[1], page_table.shape[-1]
        steps = torch.arange(s, device=x.device)
        table = page_table.to(x.device, torch.long)
        if per_slot:
            pos = cache_index.to(x.device, torch.long)[:, None] + steps
            phys = torch.gather(table, 1, (pos // ps).clamp(max=max_pages - 1))
            store[phys, pos % ps] = new.to(store.dtype)
            return
        pos = int(cache_index) + steps                      # [C]
        phys = table[0, (pos // ps).clamp(max=max_pages - 1)]
        if page_write_start is not None:
            # overlap queries below the write fence read the shared pages
            # but park their (identical-valued) K/V on scratch
            phys = torch.where(pos >= page_write_start, phys, 0)
        if page_write_end is not None:
            # padded-tail queries past the prompt park on scratch too
            phys = torch.where(pos < page_write_end, phys, 0)
        store[phys, pos % ps] = new[0].to(store.dtype)

    def _slot_write(store, new):
        """Row b's new [s, ...] rows at its own depth cache_index[b]."""
        rows = torch.arange(b, device=x.device)
        idx = cache_index.to(device=x.device, dtype=torch.long)
        if s == 1:
            store[rows, idx] = new[:, 0].to(store.dtype)
        else:
            pos = idx[:, None] + torch.arange(s, device=x.device)
            store[rows[:, None], pos] = new.to(store.dtype)

    def _write(store, new):
        """This pass's rows of one cache tensor, in place (in-place writes
        take the place of the JAX package's functional update + buffer
        donation)."""
        if paged:
            _paged_write(store, new)
        elif per_slot:
            _slot_write(store, new)
        else:
            ci = int(cache_index)
            store[:, ci:ci + s] = new.to(store.dtype)

    q_offset = 0
    kv_lengths = None
    if kv_cache is not None:
        if len(kv_cache) == 4:
            # int8 cache or pools (k_q, v_q, k_scale, v_scale): quantize
            # the new rows on write, then dequantize the WHOLE cache and
            # attend over it, the JAX package's numerics (a prefill too
            # attends over the dequantized view of its own rows, never
            # the fresh k/v)
            kq, vq, ks, vs = kv_cache
            knew, ksnew = quantize_kv(k)
            vnew, vsnew = quantize_kv(v)
            for store, new in ((kq, knew), (vq, vnew), (ks, ksnew),
                               (vs, vsnew)):
                _write(store, new)
            k = dequantize_kv(kq, ks, cfg.dtype)
            v = dequantize_kv(vq, vs, cfg.dtype)
        else:
            kc, vc = kv_cache
            _write(kc, k)
            _write(vc, v)
            k, v = kc, vc
        if per_slot:
            kv_lengths = (cache_index.to(x.device, torch.long)
                          + 1).to(torch.int32)
        else:
            q_offset = int(cache_index)

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
        page_table=page_table,
        context=mesh if mesh is not None and mesh.cp > 1 else None,
    )
    if recompute_core and torch.is_grad_enabled():
        ctx = checkpoint(core, q, k, v, use_reentrant=False)
    else:
        ctx = core(q, k, v)
    ctx = ctx.reshape(b, s, nq * D)
    return maybe_fp8_matmul(cfg, ctx, deq(p["wo"], ctx.dtype),
                            mesh), kv_cache


def mlp_block(cfg: ModelConfig, p: Dict[str, Any],
              x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The MLP's row-parallel partial sums, without its bias "b_out"
    (as attention_block's out)."""
    h = maybe_fp8_matmul(cfg, enter_tp(x, mesh), deq(p["w_in"], x.dtype),
                         mesh)
    if "b_in" in p:
        h = h + p["b_in"]
    h = apply_activation(cfg.activation, h)
    return maybe_fp8_matmul(cfg, h, deq(p["w_out"], h.dtype), mesh)


def _row_out(partial: torch.Tensor, mesh, tp_comm, site: str,
             *biases) -> torch.Tensor:
    """Row-parallel partial sums reduced over the tensor group (through
    the compressed collective at a site tp_comm covers), then their
    biases (those the params have) added once."""
    out = tp_reduce(partial, mesh, tp_comm, site)
    for bias in biases:
        if bias is not None:
            out = out + bias
    return out


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(cfg: ModelConfig, lp: Dict[str, Any], x: torch.Tensor,
         mesh=None, tp_comm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense MLP or MoE, by config, reduced over the tensor group (the
    dense bias added after): (out, aux loss fp32 scalar)."""
    if cfg.num_experts is not None:
        y, aux = moe_block(cfg, lp["moe"], x, mesh)
        return exit_tp(y, mesh), aux
    return (_row_out(mlp_block(cfg, lp["mlp"], x, mesh), mesh, tp_comm,
                     "mlp_out", lp["mlp"].get("b_out")), _no_aux(x))


def block_forward(
    cfg: ModelConfig,
    lp: Dict[str, Any],       # one layer's params
    x: torch.Tensor,          # [B, S, h]
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    cache_index=None,
    padding_mask: Optional[torch.Tensor] = None,
    recompute_core: bool = False,
    page_table: Optional[torch.Tensor] = None,
    page_write_start: Optional[int] = None,
    page_write_end: Optional[int] = None,
    mesh=None,
    tp_comm=None,
    cp_comm=None,
) -> Tuple[torch.Tensor, Optional[KVCache], torch.Tensor]:
    """One decoder layer -> (y, kv_cache, moe_aux): pre-LN, parallel
    attention (Falcon) or post-LN, as the config says; moe_aux is the
    layer's router loss (a zero scalar for dense models). mesh: tensor
    parallelism (the module docstring); x is then this rank's sequence
    chunk under sequence parallelism.

    The parallel form reduces its two row-parallel branches together, as
    Megatron's parallel block does: one all-reduce (a reduce-scatter
    under sequence parallelism) of the summed partials, then both
    biases. The sequential forms, and the parallel form with a MoE FFN
    (ops/moe.moe_block's partial sums, each expert's bias inside),
    reduce each branch on its own.

    tp_comm (a quant.TpComm; serving): the reductions at the sites it
    covers run through quant/collectives.compressed_psum, the parallel
    form's one reduction at the "attn_out" site's decision. cp_comm:
    context-parallel serving (attention_block)."""
    # post-LN: no pre-norm; the layer ends with its own norm, the ln1 slot
    normed = x if cfg.use_post_ln else _norm(cfg, lp["ln1"], x)
    bo = lp["attn"].get("bo")
    attn_out, kv_cache = attention_block(
        cfg, lp["attn"], normed, rope, positions,
        kv_cache=kv_cache, cache_index=cache_index,
        padding_mask=padding_mask, recompute_core=recompute_core,
        page_table=page_table, page_write_start=page_write_start,
        page_write_end=page_write_end, mesh=mesh, cp_comm=cp_comm)
    if cfg.parallel_attn:
        # the MLP reads ln1(x) (Falcon-7B) or its own ln_mlp(x)
        # (Falcon-40B); one residual add for both branches
        mlp_in = (_norm(cfg, lp["ln_mlp"], x) if cfg.parallel_layernorm
                  else normed)
        res = normed if cfg.apply_residual_post_ln else x
        if cfg.num_experts is None:
            out = _row_out(attn_out + mlp_block(cfg, lp["mlp"], mlp_in, mesh),
                           mesh, tp_comm, "attn_out", bo,
                           lp["mlp"].get("b_out"))
            return res + out, kv_cache, _no_aux(x)
        mlp_out, moe_aux = _ffn(cfg, lp, mlp_in, mesh, tp_comm)
        return (res + _row_out(attn_out, mesh, tp_comm, "attn_out", bo)
                + mlp_out, kv_cache, moe_aux)
    y = (normed if cfg.apply_residual_post_ln else x) + _row_out(
        attn_out, mesh, tp_comm, "attn_out", bo)
    normed2 = _norm(cfg, lp["ln2"], y)
    mlp_out, moe_aux = _ffn(cfg, lp, normed2, mesh, tp_comm)
    y = (normed2 if cfg.apply_residual_post_ln else y) + mlp_out
    if cfg.use_post_ln:
        y = _norm(cfg, lp["ln1"], y)
    return y, kv_cache, moe_aux
