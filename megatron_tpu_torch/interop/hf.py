"""HuggingFace weight interop, both directions (counterpart of
megatron_tpu/interop/hf.py).

The JAX package's mappings, on torch tensors in place of numpy arrays,
so bf16 weights convert both ways bit for bit (numpy has no bf16). No
q/k permutation: the port's RoPE is HF's rotate-half convention, as the
JAX package's is, so q/k/v weights map by transpose only. Nothing here
imports transformers: config_from_hf takes the `config.json` dict (or
any object with the same attributes) and hf_config_from_native returns
one.

Supported model types: llama (v1, v2, and CodeLlama through
rope_theta) and mistral (its sliding window is the port's
sliding_window_size). falcon, gpt2 and mixtral raise
NotImplementedError: the port's model has no parallel attention
(falcon), no absolute position embeddings (gpt2) and no MoE (mixtral)
yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import types
from typing import Any, Dict, Optional

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.params import param_shapes

SUPPORTED = ("llama", "mistral")
_WAITS_FOR = {
    "falcon": "parallel attention and parallel layernorm blocks "
              "(ModelConfig.parallel_attn / parallel_layernorm)",
    "gpt2": "absolute position embeddings (position_embedding_type "
            "'absolute', the embed/pos table) and biased linears",
    "mixtral": "mixture-of-experts layers (ops/moe.py, the layers/moe "
               "parameters)",
}
_ARCHITECTURES = {"llama": "LlamaForCausalLM",
                  "mistral": "MistralForCausalLM"}


def _check_model_type(model_type: str) -> None:
    if model_type in _WAITS_FOR:
        raise NotImplementedError(
            f"HF model_type {model_type!r} is not ported: it waits for "
            f"{_WAITS_FOR[model_type]}, which the port's model lacks "
            "(ROADMAP.md, queue A)")
    if model_type not in SUPPORTED:
        raise ValueError(f"unsupported HF model_type {model_type!r}; one "
                         f"of {SUPPORTED}")


def config_from_hf(hf_config: Any, seq_length: Optional[int] = None
                   ) -> ModelConfig:
    """ModelConfig of an HF checkpoint, from its config.json dict or a
    transformers PretrainedConfig."""
    c = (types.SimpleNamespace(**hf_config) if isinstance(hf_config, dict)
         else hf_config)
    mt = c.model_type
    _check_model_type(mt)
    rope_scaling = getattr(c, "rope_scaling", None) or {}
    if rope_scaling and rope_scaling.get(
            "rope_type", rope_scaling.get("type")) != "linear":
        raise ValueError(
            f"unsupported rope_scaling {rope_scaling!r} (only linear)")
    if getattr(c, "hidden_act", "silu") != "silu":
        raise ValueError(f"unsupported hidden_act {c.hidden_act!r} (the "
                         "port's llama MLP is SwiGLU)")
    if getattr(c, "attention_bias", False) or getattr(c, "mlp_bias", False):
        raise ValueError("attention_bias / mlp_bias checkpoints are not "
                         "supported")
    head_dim = getattr(c, "head_dim", None)
    return ModelConfig(
        num_layers=c.num_hidden_layers,
        hidden_size=c.hidden_size,
        num_attention_heads=c.num_attention_heads,
        num_kv_heads=getattr(c, "num_key_value_heads", None),
        kv_channels=(head_dim if head_dim
                     and head_dim != c.hidden_size // c.num_attention_heads
                     else None),
        ffn_hidden_size=c.intermediate_size,
        vocab_size=c.vocab_size,
        seq_length=seq_length or c.max_position_embeddings,
        normalization="rmsnorm",
        activation="swiglu",
        position_embedding_type="rotary",
        rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        rope_scaling_factor=float(rope_scaling.get("factor", 1.0)),
        layernorm_epsilon=c.rms_norm_eps,
        tie_embed_logits=bool(getattr(c, "tie_word_embeddings", False)),
        sliding_window_size=(getattr(c, "sliding_window", None)
                             if mt == "mistral" else None),
    ).validate()


def hf_config_from_native(cfg: ModelConfig, model_type: str,
                          torch_dtype: str = "bfloat16") -> Dict[str, Any]:
    """Inverse of config_from_hf: the config.json dict that transformers'
    from_pretrained reads for these weights."""
    _check_model_type(model_type)
    if (cfg.normalization != "rmsnorm" or cfg.activation != "swiglu"
            or cfg.use_bias_linear or cfg.use_bias_qkv):
        raise ValueError(
            f"a {cfg.normalization}/{cfg.activation} model with biases="
            f"{cfg.use_bias_linear or cfg.use_bias_qkv} has no "
            f"{model_type} export target")
    d = dict(
        model_type=model_type,
        architectures=[_ARCHITECTURES[model_type]],
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.ffn_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        max_position_embeddings=cfg.seq_length,
        rms_norm_eps=cfg.layernorm_epsilon,
        rope_theta=cfg.rope_theta,
        tie_word_embeddings=cfg.tie_embed_logits,
        hidden_act="silu",
        torch_dtype=torch_dtype,
    )
    if model_type == "llama" and cfg.rope_scaling_factor != 1.0:
        d["rope_scaling"] = {"rope_type": "linear",
                             "factor": cfg.rope_scaling_factor}
    if model_type == "mistral":
        d["sliding_window"] = cfg.sliding_window_size
    return d


def _nest_set(tree: Dict[str, Any], path: str, value) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


def _llama_to_flat(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    L = cfg.num_layers

    def stack(fmt, transpose=False):
        return torch.stack([sd[fmt.format(i)].t() if transpose
                            else sd[fmt.format(i)] for i in range(L)])

    pre = "model.layers.{}."
    f = {
        "embed/tokens": sd["model.embed_tokens.weight"].clone(),
        "layers/ln1/scale": stack(pre + "input_layernorm.weight"),
        "layers/ln2/scale": stack(pre + "post_attention_layernorm.weight"),
        "layers/attn/wq": stack(pre + "self_attn.q_proj.weight", True),
        "layers/attn/wk": stack(pre + "self_attn.k_proj.weight", True),
        "layers/attn/wv": stack(pre + "self_attn.v_proj.weight", True),
        "layers/attn/wo": stack(pre + "self_attn.o_proj.weight", True),
        "layers/mlp/w_in": torch.cat(
            [stack(pre + "mlp.gate_proj.weight", True),
             stack(pre + "mlp.up_proj.weight", True)], dim=-1),
        "layers/mlp/w_out": stack(pre + "mlp.down_proj.weight", True),
        "final_ln/scale": sd["model.norm.weight"].clone(),
    }
    if not cfg.tie_embed_logits:
        f["lm_head/w"] = sd["lm_head.weight"].t().contiguous()
    return f


def hf_state_dict_to_params(sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                            model_type: str,
                            dtype: Optional[torch.dtype] = None
                            ) -> Dict[str, Any]:
    """An HF state dict -> the port's parameter tree (new contiguous
    tensors on the state dict's device, cast to dtype when given),
    checked path by path and shape by shape against models/params.py."""
    _check_model_type(model_type)
    flat = _llama_to_flat(sd, cfg)
    want = param_shapes(cfg)
    missing, extra = sorted(set(want) - set(flat)), sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing={missing} "
                         f"extra={extra}")
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        if tuple(v.shape) != tuple(want[k]):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != expected "
                             f"{want[k]}")
        _nest_set(out, k, v.to(dtype) if dtype is not None else v)
    return out


def params_to_hf_state_dict(params: Dict[str, Any], cfg: ModelConfig,
                            model_type: str) -> Dict[str, torch.Tensor]:
    """Inverse conversion: HF names -> new contiguous tensors in the
    params' dtype. A tied model's lm_head.weight is the embedding (one
    tensor under both names)."""
    _check_model_type(model_type)
    f = dict(_flatten(params))
    sd: Dict[str, torch.Tensor] = {}

    def t(x):
        return x.t().contiguous()

    sd["model.embed_tokens.weight"] = f["embed/tokens"].clone()
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = f["layers/ln1/scale"][i].clone()
        sd[f"{pre}.post_attention_layernorm.weight"] = \
            f["layers/ln2/scale"][i].clone()
        sd[f"{pre}.self_attn.q_proj.weight"] = t(f["layers/attn/wq"][i])
        sd[f"{pre}.self_attn.k_proj.weight"] = t(f["layers/attn/wk"][i])
        sd[f"{pre}.self_attn.v_proj.weight"] = t(f["layers/attn/wv"][i])
        sd[f"{pre}.self_attn.o_proj.weight"] = t(f["layers/attn/wo"][i])
        gate, up = f["layers/mlp/w_in"][i].chunk(2, dim=-1)
        sd[f"{pre}.mlp.gate_proj.weight"] = t(gate)
        sd[f"{pre}.mlp.up_proj.weight"] = t(up)
        sd[f"{pre}.mlp.down_proj.weight"] = t(f["layers/mlp/w_out"][i])
    sd["model.norm.weight"] = f["final_ln/scale"].clone()
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"]
                            if cfg.tie_embed_logits else t(f["lm_head/w"]))
    return sd
