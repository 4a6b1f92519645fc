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
_CODELLAMA_SIZES = {
    "7B": (4096, 32, 32, None, 11008),
    "13B": (5120, 40, 40, None, 13824),
    "34B": (8192, 48, 64, 8, 22016),
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


def codellama(size: str = "7B", seq_length: int = 16384) -> ModelConfig:
    """CodeLlama: llama-2 geometry + rope theta 1e6 + 32016-token vocab."""
    h, L, nh, nkv, ffn = _CODELLAMA_SIZES[size]
    return _llama_base(
        hidden_size=h, num_layers=L, num_attention_heads=nh, num_kv_heads=nkv,
        ffn_hidden_size=ffn, seq_length=seq_length, vocab_size=32016,
        rope_theta=1e6,
    )


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


def mixtral(size: str = "8x7B", seq_length: int = 8192) -> ModelConfig:
    """Mixtral-8x7B: Mistral's geometry without its window, 8 experts a
    layer with renormalized top-2 routing (ops/moe.py), rope theta 1e6."""
    if size != "8x7B":
        raise ValueError(f"unknown mixtral size {size}")
    return _llama_base(
        hidden_size=4096, num_layers=32, num_attention_heads=32,
        num_kv_heads=8, ffn_hidden_size=14336, seq_length=seq_length,
        num_experts=8, moe_top_k=2, moe_renorm_gates=True,
        rope_theta=1e6,
    )


def falcon(size: str = "7B", seq_length: int = 2048) -> ModelConfig:
    """Falcon 7B/40B: rotary, MQA/GQA, parallel attention, layernorm,
    exact gelu, tied embeddings, no linear biases."""
    if size == "7B":
        h, L, nh, nkv, parallel_ln = 4544, 32, 71, 1, False
    elif size == "40B":
        h, L, nh, nkv, parallel_ln = 8192, 60, 128, 8, True
    else:
        raise ValueError(f"unknown falcon size {size}")
    return ModelConfig(
        hidden_size=h, num_layers=L, num_attention_heads=nh, num_kv_heads=nkv,
        ffn_hidden_size=4 * h, vocab_size=65024, seq_length=seq_length,
        normalization="layernorm", activation="gelu",
        position_embedding_type="rotary",
        parallel_attn=True, parallel_layernorm=parallel_ln,
        use_bias_linear=False, use_bias_qkv=False,
        tie_embed_logits=True, layernorm_epsilon=1e-5,
        attention_impl="pallas",
    ).validate()


_GPT2_SIZES = {
    "124M": (768, 12, 12),
    "355M": (1024, 24, 16),
    "760M": (1536, 24, 16),
    "1.3B": (2048, 24, 32),
}


def gpt2(size: str = "124M", seq_length: int = 1024) -> ModelConfig:
    """GPT-2: absolute position embeddings, exact gelu, layernorm, biases,
    tied embeddings, vocab 50257 padded to 50304. One departure from the
    JAX preset, which keeps the default attention_impl "xla": here it is
    "pallas" as for every other preset, since the serving entry point
    takes its kernel route from the preset."""
    h, L, nh = _GPT2_SIZES[size]
    return ModelConfig(
        hidden_size=h, num_layers=L, num_attention_heads=nh,
        vocab_size=50304,
        seq_length=seq_length, max_position_embeddings=seq_length,
        normalization="layernorm", activation="gelu",
        position_embedding_type="absolute",
        use_bias_linear=True, use_bias_qkv=True,
        tie_embed_logits=True, layernorm_epsilon=1e-5,
        init_method_std=0.02, attention_impl="pallas",
    ).validate()


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
    "codellama": codellama,
    "mistral": mistral,
    "mixtral": mixtral,
    "falcon": falcon,
    "gpt2": gpt2,
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
