"""LayerNorm / RMSNorm (counterpart of megatron_tpu/ops/normalization.py).

Computed in fp32 and cast back, like the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, computed in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm_forward(kind: str, x: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 eps: float = 1e-5) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, scale, eps)
    if kind == "layernorm":
        return layernorm(x, scale, bias, eps)
    raise ValueError(f"unknown normalization {kind!r}")
