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
flash_decode; a full-sequence causal pass (q_len == kv_len) goes to
flash_mha (flash_fwd forward, the flash_bwd_dq / flash_bwd_dkv kernels
backward); other shapes (a chunk into cached context, bidirectional
masks) take the dense path. Padding masks and dropout, which no kernel
covers, fall back to the dense path with a loud warning, and so does
flash_bwd=False (--no_flash_bwd), the escape hatch that puts the dense
O(S^2) attention and its autograd gradient on the training path. A
kernel that is asked for and cannot take a CUDA tensor raises instead
of falling back.

Layout is [batch, seq, heads, head_dim] throughout.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from megatron_tpu_torch.ops.flash import flash_template


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
    dropout_generator: Optional[torch.Generator] = None,
    q_offset: int = 0,
    impl: str = "xla",
    softmax_fp32: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,  # [B] valid-prefix lengths
    flash_bwd: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA. Returns [B, Sq, Hq, D].

    q_offset: absolute position of q[0] (a chunk into cached context).

    kv_lengths: per-row valid KV prefix (continuous-batching decode). Query
    j of row b sits at position kv_lengths[b] - 1 + j and sees
    k_pos < kv_lengths[b] + j; a sliding window W adds
    k_pos >= kv_lengths[b] + j - W."""
    if kv_lengths is not None:
        if dropout > 0.0 or padding_mask is not None:
            raise ValueError("kv_lengths is a serving-decode path: no "
                             "dropout / padding masks")
        if impl == "pallas":
            return flash_template.flash_decode(q, k, v, kv_lengths,
                                               sliding_window=sliding_window)
    elif (impl == "pallas" and mask_type == "causal"
          and q.shape[1] == k.shape[1]):
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
        keep = torch.rand(probs.shape, generator=dropout_generator,
                          device=probs.device) >= dropout
        probs = torch.where(keep, probs / (1.0 - dropout), 0.0)

    probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d)
