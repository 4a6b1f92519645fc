"""Rotary position embeddings (counterpart of megatron_tpu/ops/rotary.py).

Rotate-half convention, linear position-interpolation scaling and
configurable theta, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def precompute_rope(head_dim: int, max_positions: int, theta: float = 10000.0,
                    scaling_factor: float = 1.0, dtype=torch.float32,
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each [max_positions, head_dim]."""
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (idx / head_dim))
    t = torch.arange(max_positions, dtype=torch.float32,
                     device=device) / scaling_factor
    freqs = torch.outer(t, inv_freq)                 # [P, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)          # [P, D]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor,
                     positions: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q, k ([batch, seq, heads, head_dim]) by position.

    positions: [batch, seq] int ids (a per-row gather: continuous-batching
    decode puts every slot at its own depth); None => 0..seq-1."""
    if positions is None:
        seq = q.shape[1]
        cos_g, sin_g = cos[None, :seq], sin[None, :seq]
    else:
        cos_g, sin_g = cos[positions], sin[positions]
    cos_g = cos_g[:, :, None, :].float()
    sin_g = sin_g[:, :, None, :].float()

    def rot(x):
        xf = x.float()
        return (xf * cos_g + _rotate_half(xf) * sin_g).to(x.dtype)

    return rot(q), rot(k)
