"""Typed model configuration (counterpart of megatron_tpu/config.py).

Only the ModelConfig fields the serving path reads are ported; the field
names, defaults and derived helpers (head_dim, n_kv_heads, ffn_size,
validate) are the JAX package's, so a config round-trips between the two
packages by field name. ``dtype`` is a torch dtype here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

# absolute position embeddings (GPT-2) are not ported yet
POSITION_EMBEDDING_TYPES = ("rotary",)
NORMALIZATION_TYPES = ("layernorm", "rmsnorm")
ACTIVATION_TYPES = ("gelu", "gelu_tanh", "geglu", "swiglu", "reglu", "liglu",
                    "relu", "squared_relu")
GLU_ACTIVATIONS = ("geglu", "swiglu", "reglu", "liglu")
ATTN_MASK_TYPES = ("causal", "bidirectional", "padding")
# "pallas" keeps the JAX package's name for the kernel route: on CUDA
# tensors it selects the hand-written Hopper kernels (ops/flash/)
ATTENTION_IMPLS = ("xla", "pallas")
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(DTYPES)}")
    return DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of one decoder-only transformer LM."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    vocab_size: int
    seq_length: int

    num_kv_heads: Optional[int] = None
    kv_channels: Optional[int] = None
    ffn_hidden_size: Optional[int] = None

    position_embedding_type: str = "rotary"
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0

    normalization: str = "rmsnorm"
    layernorm_epsilon: float = 1e-5
    activation: str = "swiglu"

    use_bias_linear: bool = False
    use_bias_qkv: bool = False
    tie_embed_logits: bool = False
    sliding_window_size: Optional[int] = None

    init_method_std: float = 0.02
    use_scaled_init: bool = True

    params_dtype: str = "bfloat16"
    softmax_fp32: bool = True
    attn_mask_type: str = "causal"
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.kv_channels or self.hidden_size // self.num_attention_heads

    @property
    def n_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def is_glu(self) -> bool:
        return self.activation in GLU_ACTIVATIONS

    @property
    def ffn_size(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        if self.is_glu:
            raw = int(2 * 4 * self.hidden_size / 3)
            return 256 * ((raw + 255) // 256)
        return 4 * self.hidden_size

    @property
    def dtype(self) -> torch.dtype:
        return _resolve_dtype(self.params_dtype)

    def validate(self) -> "ModelConfig":
        if self.position_embedding_type not in POSITION_EMBEDDING_TYPES:
            raise ValueError(
                f"bad position_embedding_type {self.position_embedding_type}")
        if self.normalization not in NORMALIZATION_TYPES:
            raise ValueError(f"bad normalization {self.normalization}")
        if self.activation not in ACTIVATION_TYPES:
            raise ValueError(f"bad activation {self.activation}")
        if self.attn_mask_type not in ATTN_MASK_TYPES:
            raise ValueError(f"bad attn_mask_type {self.attn_mask_type}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"bad attention_impl {self.attention_impl}")
        _resolve_dtype(self.params_dtype)
        if (self.hidden_size % self.num_attention_heads
                and self.kv_channels is None):
            raise ValueError("num_attention_heads must divide hidden_size")
        if self.num_attention_heads % self.n_kv_heads:
            raise ValueError(
                "num_attention_heads must be divisible by num_kv_heads")
        return self
