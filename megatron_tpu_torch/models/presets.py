"""Architecture presets (counterpart of megatron_tpu/models/presets.py).

The sizes and flags are the JAX package's; pad_vocab is its padding rule.
"""

from __future__ import annotations

from typing import Optional

from megatron_tpu_torch.config import ModelConfig


def pad_vocab(vocab_size: int, divisible_by: int = 128,
              tensor_parallel: int = 1) -> int:
    mult = divisible_by * tensor_parallel
    return mult * ((vocab_size + mult - 1) // mult)


def _llama_base(**kw) -> ModelConfig:
    base = dict(
        normalization="rmsnorm",
        activation="swiglu",
        position_embedding_type="rotary",
        use_bias_linear=False,
        use_bias_qkv=False,
        tie_embed_logits=False,
        layernorm_epsilon=1e-5,
        vocab_size=32000,
        # the hand-written flash kernels on CUDA (ops/flash/)
        attention_impl="pallas",
    )
    base.update(kw)
    return ModelConfig(**base).validate()


# (hidden, layers, heads, kv_heads, ffn)
_LLAMA_SIZES = {
    "7B": (4096, 32, 32, None, 11008),
    "13B": (5120, 40, 40, None, 13824),
    "30B": (6656, 60, 52, None, 17920),
    "65B": (8192, 80, 64, None, 22016),
}
_LLAMA2_SIZES = {
    "7B": (4096, 32, 32, None, 11008),
    "13B": (5120, 40, 40, None, 13824),
    "70B": (8192, 80, 64, 8, 28672),
}


def llama(size: str = "7B", version: int = 2, seq_length: Optional[int] = None,
          rope_scaling_factor: float = 1.0) -> ModelConfig:
    """Llama v1 (seq 2048, eps 1e-6) / v2 (seq 4096, eps 1e-5)."""
    table = _LLAMA2_SIZES if version == 2 else _LLAMA_SIZES
    h, L, nh, nkv, ffn = table[size]
    return _llama_base(
        hidden_size=h, num_layers=L, num_attention_heads=nh, num_kv_heads=nkv,
        ffn_hidden_size=ffn,
        seq_length=seq_length or (4096 if version == 2 else 2048),
        layernorm_epsilon=1e-5 if version == 2 else 1e-6,
        rope_scaling_factor=rope_scaling_factor,
    )


def llama2(size: str = "7B", **kw) -> ModelConfig:
    return llama(size=size, version=2, **kw)


def mistral(size: str = "7B", seq_length: int = 8192) -> ModelConfig:
    """Mistral-7B: llama flags + GQA(8) + sliding window 4096."""
    if size != "7B":
        raise ValueError(f"unknown mistral size {size}")
    return _llama_base(
        hidden_size=4096, num_layers=32, num_attention_heads=32,
        num_kv_heads=8,
        ffn_hidden_size=14336, seq_length=seq_length,
        sliding_window_size=4096,
    )


def tiny(vocab_size: int = 256, seq_length: int = 128, **kw) -> ModelConfig:
    """Small config for tests."""
    base = dict(
        hidden_size=64, num_layers=2, num_attention_heads=4, num_kv_heads=2,
        ffn_hidden_size=128, vocab_size=vocab_size, seq_length=seq_length,
        normalization="rmsnorm", activation="swiglu",
        position_embedding_type="rotary", tie_embed_logits=False,
        params_dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base).validate()


PRESETS = {
    "llama": llama,
    "llama2": llama2,
    "mistral": mistral,
    "tiny": tiny,
}


def from_model_name(name: str) -> ModelConfig:
    """'llama2-7B' -> presets.llama2(size='7B') (the JAX CLI's
    --model_name NAME-SIZE form)."""
    kw = {}
    if "-" in name:
        name, kw["size"] = name.split("-", 1)
    if name not in PRESETS:
        raise ValueError(f"unknown model {name!r}; one of {sorted(PRESETS)}")
    return PRESETS[name](**kw)
