"""int8 KV-cache quantization for serving (counterpart of
megatron_tpu/ops/kv_quant.py).

Storing the KV cache as int8 with one fp32 scale per position and head
halves its bytes against bf16 (plus 4 bytes of scale per D values: 3%
at head_dim 128), so one card's KV memory holds twice the tokens.

Layout: q int8 [..., D] + scale fp32 [..., 1]; kv_buffers builds a
cache or pool in this layout (or the plain (k, v) pair). The attention block
quantizes on write and dequantizes the whole cache (or page pool) for
attention, so the attention kernels see the same bf16 layout as the
bf16 cache.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def symmetric_int8(x: torch.Tensor, dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric max-abs int8 quantization along `dim` (keepdim scale),
    in fp32: scale = max(amax, 1e-8) / 127, q = clip(round(x / scale),
    -127, 127). torch.round rounds half to even, as jnp.round does. The
    127 is a tensor: CUDA divides by a Python scalar as a product with
    its reciprocal, one bit short of the division the host makes."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float -> (int8 [..., D], fp32 scale [..., 1])."""
    return symmetric_int8(x, dim=-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_kv, in `dtype`: the fp32 product rounded once
    to `dtype`, as (q.float() * scale).to(dtype) computes it, but in one
    elementwise kernel that writes only the `dtype` result (no fp32
    intermediate: the whole cache is dequantized every layer)."""
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale, out=out)


def kv_buffers(shape: Sequence[int], dtype, int8: bool, device
               ) -> Tuple[torch.Tensor, ...]:
    """Zeroed K/V buffers of `shape` [..., D]: (k, v) in `dtype`, or with
    int8 (k_q, v_q, k_scale, v_scale), int8 values and fp32 scales
    [..., 1]. The slot caches, the one-shot caches and the page pools."""
    shape = tuple(shape)
    if int8:
        sshape = shape[:-1] + (1,)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def kv_head_bytes(head_dim: int, dtype, int8: bool) -> float:
    """Bytes one position of one KV head takes in kv_buffers' K (or V):
    head_dim int8 values plus a 4-byte scale, or head_dim of `dtype`."""
    return (head_dim + 4 if int8
            else head_dim * torch.finfo(dtype).bits / 8)
