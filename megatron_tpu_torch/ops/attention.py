"""Attention (counterpart of megatron_tpu/ops/attention.py).

Two implementations behind one dispatch:
  * "xla" (the JAX package's name for its plain path): einsum attention
    with fp32 softmax, GQA grouping, causal mask with q_offset, sliding
    window, padding mask, and the per-row kv_lengths rule of
    continuous-batching decode.
  * "pallas": the flash kernels (ops/flash/flash_template.py). On CUDA
    tensors they are the hand-written Hopper kernels; on CPU tensors
    their plain versions.

Routing under impl="pallas" follows the JAX package: kv_lengths goes to
flash_decode, or with a page_table to paged_flash_decode (Sq == 1) or
paged_flash_decode_mq; a full-sequence causal pass (q_len == kv_len,
q_offset 0) goes to flash_mha (flash_fwd forward, the flash_bwd_dq /
flash_bwd_dkv kernels backward); other shapes (a chunk into cached
context, bidirectional masks, a paged chunk after its pages are
gathered) take the dense path. Padding masks and dropout, which no
kernel covers, fall back to the dense path with a loud warning, and so
does
flash_bwd=False (--no_flash_bwd), the escape hatch that puts the dense
O(S^2) attention and its autograd gradient on the training path. A
kernel that is asked for and cannot take a CUDA tensor raises instead
of falling back (the JAX package warns and falls back there).

Context parallelism (a MeshRuntime with cp > 1 as `context`; training's
full-sequence passes): q, k and v are this rank's contiguous piece of
the sequence [B, S/cp, H, D], and the result is the piece's attention
over the whole sequence:
  * "xla" / "pallas": k and v all-gathered over the context group
    (parallel/mappings.gather_context, whose backward reduce-scatters
    their gradients; what GSPMD does for the JAX package), the queries at
    offset c * S/cp: the dense path with that q_offset, or under
    "pallas" the flash kernels at delta = c * S/cp, Sq = S/cp, Skv = S;
  * "ring": ops/ring_attention.py (zig-zag or contiguous);
  * "ulysses": ops/ulysses.py (the all-to-alls around flash_mha).
Padding masks and attention dropout have no context-parallel path and
raise (the JAX package warns and runs its dense path over the gathered
sequence). At
cp 1, "ring" and "ulysses" are the "pallas" route, as the JAX package's
rings and Ulysses run one hop of its kernels there.

Layout is [batch, seq, heads, head_dim] throughout.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from megatron_tpu_torch.ops.flash import flash_template
from megatron_tpu_torch.parallel.mappings import gather_context
from megatron_tpu_torch.parallel.random import keep_mask


def _mask_allowed(q_len: int, kv_len: int, mask_type: str,
                  sliding_window: Optional[int], q_offset: int,
                  device) -> Optional[torch.Tensor]:
    """Boolean [q_len, kv_len] visibility; None when fully visible."""
    if mask_type == "bidirectional" and sliding_window is None:
        return None
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    allowed = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if mask_type == "causal":
        allowed &= k_pos <= q_pos
    if sliding_window is not None:
        allowed &= k_pos > q_pos - sliding_window
    return allowed


def attention(
    q: torch.Tensor,   # [B, Sq, Hq, D]
    k: torch.Tensor,   # [B, Skv, Hkv, D]
    v: torch.Tensor,   # [B, Skv, Hkv, D]
    mask_type: str = "causal",
    sliding_window: Optional[int] = None,
    padding_mask: Optional[torch.Tensor] = None,  # [B, Skv] True = keep
    dropout: float = 0.0,
    dropout_key=None,
    q_offset: int = 0,
    impl: str = "xla",
    softmax_fp32: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,  # [B] valid-prefix lengths
    flash_bwd: bool = True,
    page_table: Optional[torch.Tensor] = None,  # [B, max_pages] int32
    context=None,
    dropout_mesh=None,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA. Returns [B, Sq, Hq, D].

    q_offset: absolute position of q[0] (a chunk into cached context).

    kv_lengths: per-row valid KV prefix (continuous-batching decode). Query
    j of row b sits at position kv_lengths[b] - 1 + j and sees
    k_pos < kv_lengths[b] + j; a sliding window W adds
    k_pos >= kv_lengths[b] + j - W.

    page_table: paged KV cache (inference/paging/): k/v are one layer's
    shared page pools [num_pages, page_size, Hkv, D] and row b's logical
    context is the pages page_table[b]. With kv_lengths under
    impl="pallas" this is the paged flash-decode kernel; otherwise (a
    prefill chunk with q_offset, or impl="xla") the pages are gathered
    into a dense [B, max_pages * page_size, Hkv, D] view (an exact copy)
    and the paths below compute the same values.

    context: the mesh of a context-parallel pass (the module docstring);
    None or cp 1 is the one-sequence path.

    dropout, dropout_key (a parallel/random.DropoutKey): dropout of the
    probabilities [B, Hkv, G, Sq, Skv] on the dense path, the kept ones
    divided by 1 - dropout, as the JAX package does; dropout_mesh: the
    mesh whose rank's block of the logical mask this call draws (its
    batch rows and its kv heads under tensor parallelism)."""
    if impl in ("ring", "ulysses") and (context is None or context.cp == 1):
        impl = "pallas"
    if context is not None and context.cp > 1:
        if dropout > 0.0:
            # the JAX package warns and runs its dense path over the
            # gathered sequence, the O(S^2) scores context parallelism
            # was chosen to avoid
            raise ValueError(
                "attention dropout under context parallelism: no "
                "context-parallel path draws it; drop --attention_dropout "
                "or run at cp 1")
        if (kv_lengths is not None or page_table is not None
                or padding_mask is not None
                or q.shape[1] != k.shape[1] or q_offset):
            raise ValueError(
                "context parallelism covers training's full-sequence "
                "passes: no caches, padding masks, dropout or q_offset")
        if impl == "ring":
            from megatron_tpu_torch.ops.ring_attention import ring_attention

            return ring_attention(q, k, v, context, mask_type=mask_type,
                                  sliding_window=sliding_window)
        if impl == "ulysses":
            from megatron_tpu_torch.ops.ulysses import ulysses_attention

            return ulysses_attention(q, k, v, context, mask_type=mask_type,
                                     sliding_window=sliding_window)
        q_offset = context.cp_rank * q.shape[1]
        k, v = gather_context(k, context), gather_context(v, context)
        if impl == "pallas" and mask_type == "causal" and flash_bwd:
            return flash_template._FlashAttention.apply(
                q, k, v, True, sliding_window, q_offset)
    if page_table is not None:
        if kv_lengths is not None and impl == "pallas":
            if dropout > 0.0 or padding_mask is not None:
                raise ValueError("kv_lengths is a serving-decode path: no "
                                 "dropout / padding masks")
            paged = (flash_template.paged_flash_decode if q.shape[1] == 1
                     else flash_template.paged_flash_decode_mq)
            return paged(q, k, v, page_table, kv_lengths,
                         sliding_window=sliding_window)
        k = flash_template._gather_pages(k, page_table)
        v = flash_template._gather_pages(v, page_table)
    if kv_lengths is not None:
        if dropout > 0.0 or padding_mask is not None:
            raise ValueError("kv_lengths is a serving-decode path: no "
                             "dropout / padding masks")
        if impl == "pallas":
            return flash_template.flash_decode(q, k, v, kv_lengths,
                                               sliding_window=sliding_window)
    elif (impl == "pallas" and mask_type == "causal"
          and q.shape[1] == k.shape[1] and q_offset == 0):
        if dropout == 0.0 and padding_mask is None and flash_bwd:
            return flash_template.flash_mha(q, k, v,
                                            sliding_window=sliding_window)
        if dropout == 0.0 and padding_mask is None:
            # escape hatch (--no_flash_bwd): deliberate, but still loud —
            # the step now pays the O(S^2) dense attention gradient
            warnings.warn(
                "flash_bwd disabled: full-sequence attention (and its "
                "gradient) runs on the O(S^2) dense path", stacklevel=2)
        else:
            warnings.warn(
                "attention_impl='pallas': the flash kernel covers neither "
                "padding masks nor attention dropout; falling back to the "
                "O(S^2) dense path", stacklevel=2)

    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv

    scale = 1.0 / math.sqrt(d)
    if softmax_fp32:
        qf, kf = q.float() * scale, k.float()
    else:
        qf, kf = q * scale, k
    qg = qf.reshape(b, sq, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)  # [B,Hkv,G,Sq,Skv]
    neg = torch.finfo(scores.dtype).min

    if kv_lengths is not None:
        k_pos = torch.arange(skv, device=q.device)[None, None, :]
        qi = torch.arange(sq, device=q.device)[None, :, None]
        lens = kv_lengths.to(q.device, torch.long)[:, None, None]
        allowed = k_pos < lens + qi
        if sliding_window is not None:
            allowed &= k_pos >= lens + qi - sliding_window
        scores = scores.masked_fill(~allowed[:, None, None], neg)
    else:
        allowed = _mask_allowed(sq, skv, mask_type, sliding_window, q_offset,
                                q.device)
        if allowed is not None:
            scores = scores.masked_fill(~allowed, neg)
    if padding_mask is not None:
        scores = scores.masked_fill(~padding_mask[:, None, None, None, :], neg)

    probs = torch.softmax(scores, dim=-1)
    if dropout > 0.0:
        if dropout_key is None:
            raise ValueError("attention dropout requires a key")
        keep = keep_mask(dropout_key, probs.shape, dropout, probs.device,
                         dropout_mesh, "probs")
        probs = torch.where(keep, probs / (1.0 - dropout), 0.0)

    probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)
