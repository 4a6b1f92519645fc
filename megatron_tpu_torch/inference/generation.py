"""Generation helpers (counterpart of megatron_tpu/inference/generation.py).

This slice ports the cache constructor and the output record the engine
returns; the one-shot jitted generation loop, scoring and beam search
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class GenerationOutput:
    tokens: np.ndarray       # [B, total_len] int32 (prompt + generated)
    lengths: np.ndarray      # [B] generated sequence end (index past last)
    logprobs: np.ndarray     # [B, total_len-1] logprob of each emitted token


def _init_caches(cfg: ModelConfig, batch: int, total_len: int,
                 device="cuda"):
    """Zeroed (k, v) caches, each [L, batch, total_len, nkv, D] in the
    model dtype."""
    shape = (cfg.num_layers, batch, total_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
