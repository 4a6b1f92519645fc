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
rope_theta), mistral (its sliding window is the port's
sliding_window_size), falcon (both layouts: the multi-query one of
Falcon-7B and new_decoder_architecture, Falcon-40B's grouped one with its
second layernorm) and gpt2 (absolute position embeddings, biases; HF's
Conv1D weights are stored [in, out] already) and mixtral (Mistral's
layers with a block_sparse_moe: the router gate [E, h] and per expert
w1 (gate), w3 (up), w2 (down), mapped to layers/moe/router [L, h, E],
w_in [L, E, h, 2F] = [w1 | w3] and w_out [L, E, F, h]; HF's block is
dropless, so the config takes capacity factor E, ample for any
routing). A config.json dict may leave out the fields where the HF class
keeps its default (save_pretrained writes only the differences):
config_from_hf reads those with the HF defaults.
"""

from __future__ import annotations

import types
from typing import Any, Dict, Optional

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.params import param_shapes

SUPPORTED = ("llama", "mistral", "mixtral", "falcon", "gpt2")
_ARCHITECTURES = {"llama": "LlamaForCausalLM",
                  "mistral": "MistralForCausalLM",
                  "mixtral": "MixtralForCausalLM",
                  "falcon": "FalconForCausalLM",
                  "gpt2": "GPT2LMHeadModel"}


def _check_model_type(model_type: str) -> None:
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
    if mt == "falcon":
        return _falcon_config(c, seq_length)
    if mt == "gpt2":
        return _gpt2_config(c, seq_length)
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
    moe = {}
    if mt == "mixtral":
        E = getattr(c, "num_local_experts", 8)
        moe = dict(num_experts=E,
                   moe_top_k=getattr(c, "num_experts_per_tok", 2),
                   moe_renorm_gates=True,
                   moe_aux_loss_coeff=getattr(c, "router_aux_loss_coef",
                                              1e-2),
                   # HF Mixtral is dropless: capacity factor E is ample
                   moe_capacity_factor=float(E))
    return ModelConfig(
        **moe,
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
                             if mt in ("mistral", "mixtral") else None),
    ).validate()


def _falcon_config(c, seq_length: Optional[int]) -> ModelConfig:
    """FalconConfig -> ModelConfig (HF's defaults are Falcon-7B's)."""
    if getattr(c, "alibi", False) or getattr(c, "bias", False):
        raise ValueError("falcon checkpoints with alibi or linear biases "
                         "are not supported (Falcon-7B/40B have neither)")
    nq = getattr(c, "num_attention_heads", 71)
    h = getattr(c, "hidden_size", 4544)
    new_arch = getattr(c, "new_decoder_architecture", False)
    if new_arch:
        nkv = getattr(c, "num_kv_heads", None) or nq
    else:
        nkv = 1 if getattr(c, "multi_query", True) else nq
    return ModelConfig(
        num_layers=getattr(c, "num_hidden_layers", 32),
        hidden_size=h,
        num_attention_heads=nq,
        num_kv_heads=nkv,
        ffn_hidden_size=getattr(c, "ffn_hidden_size", None) or 4 * h,
        vocab_size=getattr(c, "vocab_size", 65024),
        seq_length=seq_length or 2048,
        normalization="layernorm",
        activation="gelu",
        position_embedding_type="rotary",
        rope_theta=float(getattr(c, "rope_theta", 10000.0)),
        parallel_attn=getattr(c, "parallel_attn", True),
        parallel_layernorm=new_arch,
        tie_embed_logits=True,
        layernorm_epsilon=getattr(c, "layer_norm_epsilon", 1e-5),
    ).validate()


def _gpt2_config(c, seq_length: Optional[int]) -> ModelConfig:
    """GPT2Config -> ModelConfig. HF's default activation gelu_new is the
    tanh approximation: gelu_tanh."""
    h = getattr(c, "n_embd", 768)
    n_pos = getattr(c, "n_positions", 1024)
    act = getattr(c, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu"):
        raise ValueError(f"unsupported gpt2 activation_function {act!r}")
    return ModelConfig(
        num_layers=getattr(c, "n_layer", 12),
        hidden_size=h,
        num_attention_heads=getattr(c, "n_head", 12),
        ffn_hidden_size=getattr(c, "n_inner", None) or 4 * h,
        vocab_size=getattr(c, "vocab_size", 50257),
        seq_length=seq_length or n_pos,
        max_position_embeddings=n_pos,
        normalization="layernorm",
        activation="gelu_tanh" if act == "gelu_new" else "gelu",
        position_embedding_type="absolute",
        use_bias_linear=True,
        use_bias_qkv=True,
        tie_embed_logits=True,
        layernorm_epsilon=getattr(c, "layer_norm_epsilon", 1e-5),
    ).validate()


def hf_config_from_native(cfg: ModelConfig, model_type: str,
                          torch_dtype: str = "bfloat16") -> Dict[str, Any]:
    """Inverse of config_from_hf: the config.json dict that transformers'
    from_pretrained reads for these weights."""
    _check_model_type(model_type)
    if cfg.use_post_ln:
        raise ValueError(
            "post-LN models have no HF export target: the supported HF "
            "families are pre-LN and expect a final norm")
    if model_type == "falcon":
        if (not cfg.parallel_attn or cfg.normalization != "layernorm"
                or cfg.activation != "gelu" or cfg.use_bias_linear
                or not cfg.tie_embed_logits):
            raise ValueError("a falcon export needs parallel attention, "
                             "layernorm, gelu, no biases, tied embeddings")
        new_arch = cfg.parallel_layernorm
        return dict(
            model_type="falcon", architectures=[_ARCHITECTURES["falcon"]],
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_kv_heads=cfg.n_kv_heads,
            layer_norm_epsilon=cfg.layernorm_epsilon,
            bias=False, alibi=False, parallel_attn=True,
            new_decoder_architecture=new_arch,
            multi_query=cfg.n_kv_heads == 1 and not new_arch,
            ffn_hidden_size=cfg.ffn_size, rope_theta=cfg.rope_theta,
            max_position_embeddings=cfg.seq_length,
            tie_word_embeddings=True, torch_dtype=torch_dtype)
    if model_type == "gpt2":
        if (cfg.position_embedding_type != "absolute"
                or cfg.normalization != "layernorm"
                or cfg.activation not in ("gelu", "gelu_tanh")
                or not (cfg.use_bias_linear and cfg.use_bias_qkv)
                or not cfg.tie_embed_logits or cfg.parallel_attn):
            raise ValueError("a gpt2 export needs absolute positions, "
                             "layernorm, gelu, biases, tied embeddings")
        return dict(
            model_type="gpt2", architectures=[_ARCHITECTURES["gpt2"]],
            vocab_size=cfg.vocab_size,
            n_positions=cfg.max_position_embeddings,
            n_embd=cfg.hidden_size, n_layer=cfg.num_layers,
            n_head=cfg.num_attention_heads, n_inner=cfg.ffn_size,
            activation_function=("gelu_new" if cfg.activation == "gelu_tanh"
                                 else "gelu"),
            layer_norm_epsilon=cfg.layernorm_epsilon,
            resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
            tie_word_embeddings=True, torch_dtype=torch_dtype)
    if (cfg.normalization != "rmsnorm" or cfg.activation != "swiglu"
            or cfg.use_bias_linear or cfg.use_bias_qkv):
        raise ValueError(
            f"a {cfg.normalization}/{cfg.activation} model with biases="
            f"{cfg.use_bias_linear or cfg.use_bias_qkv} has no "
            f"{model_type} export target")
    if (cfg.num_experts is not None) != (model_type == "mixtral"):
        raise ValueError(
            f"num_experts={cfg.num_experts}: MoE models export as mixtral "
            f"and only they do (asked for {model_type})")
    if model_type == "mixtral" and not cfg.moe_renorm_gates:
        raise ValueError("HF Mixtral renormalizes its top-k gates: a "
                         "model with moe_renorm_gates=False has no mixtral "
                         "export target")
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
    if model_type in ("mistral", "mixtral"):
        d["sliding_window"] = cfg.sliding_window_size
    if model_type == "mixtral":
        d.update(num_local_experts=cfg.num_experts,
                 num_experts_per_tok=cfg.moe_top_k,
                 router_aux_loss_coef=cfg.moe_aux_loss_coeff)
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


def _stack(sd, fmt: str, L: int, transpose: bool = False) -> torch.Tensor:
    return torch.stack([sd[fmt.format(i)].t() if transpose
                        else sd[fmt.format(i)] for i in range(L)])


def _llama_to_flat(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    L = cfg.num_layers

    def stack(fmt, transpose=False):
        return _stack(sd, fmt, L, transpose)

    pre = "model.layers.{}."
    f = {
        "embed/tokens": sd["model.embed_tokens.weight"].clone(),
        "layers/ln1/scale": stack(pre + "input_layernorm.weight"),
        "layers/ln2/scale": stack(pre + "post_attention_layernorm.weight"),
        "layers/attn/wq": stack(pre + "self_attn.q_proj.weight", True),
        "layers/attn/wk": stack(pre + "self_attn.k_proj.weight", True),
        "layers/attn/wv": stack(pre + "self_attn.v_proj.weight", True),
        "layers/attn/wo": stack(pre + "self_attn.o_proj.weight", True),
        "final_ln/scale": sd["model.norm.weight"].clone(),
    }
    if cfg.num_experts is None:
        f["layers/mlp/w_in"] = torch.cat(
            [stack(pre + "mlp.gate_proj.weight", True),
             stack(pre + "mlp.up_proj.weight", True)], dim=-1)
        f["layers/mlp/w_out"] = stack(pre + "mlp.down_proj.weight", True)
    else:
        moe = pre + "block_sparse_moe."

        def experts(i, fmt):
            return [sd[(pre.format(i) + "block_sparse_moe.experts.{}."
                        + fmt).format(e)].t()
                    for e in range(cfg.num_experts)]

        f["layers/moe/router"] = stack(moe + "gate.weight", True)
        f["layers/moe/w_in"] = torch.stack([torch.stack([
            torch.cat([w1, w3], dim=-1)
            for w1, w3 in zip(experts(i, "w1.weight"),
                              experts(i, "w3.weight"))])
            for i in range(L)])
        f["layers/moe/w_out"] = torch.stack([
            torch.stack(experts(i, "w2.weight")) for i in range(L)])
    if not cfg.tie_embed_logits:
        f["lm_head/w"] = sd["lm_head.weight"].t().contiguous()
    return f


def _split_falcon_qkv(fused: torch.Tensor, cfg: ModelConfig):
    """Falcon fuses q/k/v grouped per kv head, [(q_0 .. q_{g-1}, k, v) x
    n_kv_heads] along the output dim: Falcon-40B's grouped layout, and
    Falcon-7B's multi-query one (all q heads, then k, then v) as its
    n_kv_heads = 1 case. Returns wq, wk, wv as [h, out]."""
    h, D = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads
    g = nq // nkv
    w = fused.reshape(nkv, g + 2, D, h)
    return (w[:, :g].reshape(nq * D, h).t().contiguous(),
            w[:, g].reshape(nkv * D, h).t().contiguous(),
            w[:, g + 1].reshape(nkv * D, h).t().contiguous())


def _falcon_to_flat(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    L = cfg.num_layers
    pre = "transformer.h.{}."
    ln_attn = "ln_attn" if cfg.parallel_layernorm else "input_layernorm"
    f = {
        "embed/tokens": sd["transformer.word_embeddings.weight"].clone(),
        "layers/ln1/scale": _stack(sd, pre + ln_attn + ".weight", L),
        "layers/ln1/bias": _stack(sd, pre + ln_attn + ".bias", L),
        "layers/attn/wo": _stack(sd, pre + "self_attention.dense.weight", L,
                                 True),
        "layers/mlp/w_in": _stack(sd, pre + "mlp.dense_h_to_4h.weight", L,
                                  True),
        "layers/mlp/w_out": _stack(sd, pre + "mlp.dense_4h_to_h.weight", L,
                                   True),
        "final_ln/scale": sd["transformer.ln_f.weight"].clone(),
        "final_ln/bias": sd["transformer.ln_f.bias"].clone(),
    }
    if cfg.parallel_layernorm:
        f["layers/ln_mlp/scale"] = _stack(sd, pre + "ln_mlp.weight", L)
        f["layers/ln_mlp/bias"] = _stack(sd, pre + "ln_mlp.bias", L)
    qkv = [_split_falcon_qkv(
        sd[pre.format(i) + "self_attention.query_key_value.weight"], cfg)
        for i in range(L)]
    for j, name in enumerate(("wq", "wk", "wv")):
        f[f"layers/attn/{name}"] = torch.stack([t[j] for t in qkv])
    return f


def _gpt2_to_flat(sd: Dict[str, torch.Tensor], cfg: ModelConfig
                  ) -> Dict[str, torch.Tensor]:
    L, h = cfg.num_layers, cfg.hidden_size
    wte = sd["transformer.wte.weight"]
    if wte.shape[0] < cfg.vocab_size:  # the padded vocab (50257 -> 50304)
        wte = torch.cat([wte, wte.new_zeros(cfg.vocab_size - wte.shape[0],
                                            h)])
    pre = "transformer.h.{}."
    qkv_w = _stack(sd, pre + "attn.c_attn.weight", L)    # [L, h, 3h]
    qkv_b = _stack(sd, pre + "attn.c_attn.bias", L)      # [L, 3h]
    f = {
        "embed/tokens": wte.clone(),
        "embed/pos": sd["transformer.wpe.weight"].clone(),
        "final_ln/scale": sd["transformer.ln_f.weight"].clone(),
        "final_ln/bias": sd["transformer.ln_f.bias"].clone(),
    }
    for j, (w, b) in enumerate((("wq", "bq"), ("wk", "bk"), ("wv", "bv"))):
        f[f"layers/attn/{w}"] = qkv_w[..., j * h:(j + 1) * h].contiguous()
        f[f"layers/attn/{b}"] = qkv_b[..., j * h:(j + 1) * h].contiguous()
    for path, name in (("layers/ln1/scale", "ln_1.weight"),
                       ("layers/ln1/bias", "ln_1.bias"),
                       ("layers/ln2/scale", "ln_2.weight"),
                       ("layers/ln2/bias", "ln_2.bias"),
                       ("layers/attn/wo", "attn.c_proj.weight"),
                       ("layers/attn/bo", "attn.c_proj.bias"),
                       ("layers/mlp/w_in", "mlp.c_fc.weight"),
                       ("layers/mlp/b_in", "mlp.c_fc.bias"),
                       ("layers/mlp/w_out", "mlp.c_proj.weight"),
                       ("layers/mlp/b_out", "mlp.c_proj.bias")):
        f[path] = _stack(sd, pre + name, L)
    return f


_IMPORTERS = {"llama": _llama_to_flat, "mistral": _llama_to_flat,
              "mixtral": _llama_to_flat, "falcon": _falcon_to_flat,
              "gpt2": _gpt2_to_flat}


def hf_state_dict_to_params(sd: Dict[str, torch.Tensor], cfg: ModelConfig,
                            model_type: str,
                            dtype: Optional[torch.dtype] = None
                            ) -> Dict[str, Any]:
    """An HF state dict -> the port's parameter tree (new contiguous
    tensors on the state dict's device, cast to dtype when given),
    checked path by path and shape by shape against models/params.py."""
    _check_model_type(model_type)
    flat = _IMPORTERS[model_type](sd, cfg)
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
    if model_type == "falcon":
        return _falcon_state_dict(f, cfg)
    if model_type == "gpt2":
        return _gpt2_state_dict(f, cfg)
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
        if cfg.num_experts is None:
            gate, up = f["layers/mlp/w_in"][i].chunk(2, dim=-1)
            sd[f"{pre}.mlp.gate_proj.weight"] = t(gate)
            sd[f"{pre}.mlp.up_proj.weight"] = t(up)
            sd[f"{pre}.mlp.down_proj.weight"] = t(f["layers/mlp/w_out"][i])
            continue
        moe = f"{pre}.block_sparse_moe"
        sd[f"{moe}.gate.weight"] = t(f["layers/moe/router"][i])
        for e in range(cfg.num_experts):
            gate, up = f["layers/moe/w_in"][i][e].chunk(2, dim=-1)
            sd[f"{moe}.experts.{e}.w1.weight"] = t(gate)
            sd[f"{moe}.experts.{e}.w3.weight"] = t(up)
            sd[f"{moe}.experts.{e}.w2.weight"] = t(
                f["layers/moe/w_out"][i][e])
    sd["model.norm.weight"] = f["final_ln/scale"].clone()
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"]
                            if cfg.tie_embed_logits else t(f["lm_head/w"]))
    return sd


def _falcon_state_dict(f: Dict[str, torch.Tensor], cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    h, D = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads
    g = nq // nkv
    sd = {"transformer.word_embeddings.weight": f["embed/tokens"].clone()}
    lns = [("ln1", "ln_attn"), ("ln_mlp", "ln_mlp")] \
        if cfg.parallel_layernorm else [("ln1", "input_layernorm")]
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        for ours, theirs in lns:
            sd[pre + theirs + ".weight"] = f[f"layers/{ours}/scale"][i].clone()
            sd[pre + theirs + ".bias"] = f[f"layers/{ours}/bias"][i].clone()
        q = f["layers/attn/wq"][i].t().reshape(nkv, g, D, h)
        k = f["layers/attn/wk"][i].t().reshape(nkv, 1, D, h)
        v = f["layers/attn/wv"][i].t().reshape(nkv, 1, D, h)
        sd[pre + "self_attention.query_key_value.weight"] = torch.cat(
            [q, k, v], dim=1).reshape((nq + 2 * nkv) * D, h).contiguous()
        for name, path in (("self_attention.dense", "layers/attn/wo"),
                           ("mlp.dense_h_to_4h", "layers/mlp/w_in"),
                           ("mlp.dense_4h_to_h", "layers/mlp/w_out")):
            sd[pre + name + ".weight"] = f[path][i].t().contiguous()
    sd["transformer.ln_f.weight"] = f["final_ln/scale"].clone()
    sd["transformer.ln_f.bias"] = f["final_ln/bias"].clone()
    sd["lm_head.weight"] = sd["transformer.word_embeddings.weight"]
    return sd


def _gpt2_state_dict(f: Dict[str, torch.Tensor], cfg: ModelConfig
                     ) -> Dict[str, torch.Tensor]:
    sd = {"transformer.wte.weight": f["embed/tokens"].clone(),
          "transformer.wpe.weight": f["embed/pos"].clone()}
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        for name, path in (("ln_1.weight", "layers/ln1/scale"),
                           ("ln_1.bias", "layers/ln1/bias"),
                           ("ln_2.weight", "layers/ln2/scale"),
                           ("ln_2.bias", "layers/ln2/bias"),
                           ("attn.c_proj.weight", "layers/attn/wo"),
                           ("attn.c_proj.bias", "layers/attn/bo"),
                           ("mlp.c_fc.weight", "layers/mlp/w_in"),
                           ("mlp.c_fc.bias", "layers/mlp/b_in"),
                           ("mlp.c_proj.weight", "layers/mlp/w_out"),
                           ("mlp.c_proj.bias", "layers/mlp/b_out")):
            sd[pre + name] = f[path][i].clone()
        sd[pre + "attn.c_attn.weight"] = torch.cat(
            [f[f"layers/attn/{w}"][i] for w in ("wq", "wk", "wv")], dim=-1)
        sd[pre + "attn.c_attn.bias"] = torch.cat(
            [f[f"layers/attn/{b}"][i] for b in ("bq", "bk", "bv")], dim=-1)
    sd["transformer.ln_f.weight"] = f["final_ln/scale"].clone()
    sd["transformer.ln_f.bias"] = f["final_ln/bias"].clone()
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd
