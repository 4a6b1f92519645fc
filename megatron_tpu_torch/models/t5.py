"""T5-style encoder-decoder (counterpart of megatron_tpu/models/t5.py).

As in the JAX package (and the reference's T5): BERT-style absolute
learned position embeddings, a bidirectional padding-masked encoder, a
causal decoder with cross-attention to the encoder output, shared input
embeddings and a tied LM head over the decoder. The parameters live in a
tree of their own (the cross-attention has no place in the decoder
table of models/params.py), with the JAX tree's paths and shapes, so a
JAX tree loads through t5_params_from_numpy.

Every attention here is the dense path (ops/attention.py, impl "xla"):
the JAX model calls attention() without an impl, whose default is its
XLA path, so neither package sends T5 to the flash kernels.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.models.bert import refuse_moe
from megatron_tpu_torch.models.language_model import _layers
from megatron_tpu_torch.models.params import (
    _NORMAL, _ONES, _ZEROS, _nest, init_leaf, tree_from_numpy,
)
from megatron_tpu_torch.ops.activations import (
    apply_activation, mlp_input_width_factor,
)
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.cross_entropy import cross_entropy_loss
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.parallel.sharding import P


def t5_config(
    num_layers: int = 12,          # both stacks unless encoder/decoder
                                   # depths are given explicitly
    hidden_size: int = 768,
    num_attention_heads: int = 12,
    vocab_size: int = 30592,
    seq_length: int = 512,
    decoder_seq_length: int = 128,
    **kw,
) -> ModelConfig:
    base = dict(
        num_layers=num_layers, hidden_size=hidden_size,
        num_attention_heads=num_attention_heads, vocab_size=vocab_size,
        seq_length=seq_length,
        max_position_embeddings=max(seq_length, decoder_seq_length),
        position_embedding_type="absolute",
        normalization="layernorm", activation="gelu",
        use_bias_linear=True, use_bias_qkv=True,
        tie_embed_logits=True, attn_mask_type="padding",
    )
    base.update(kw)
    cfg = ModelConfig(**base).validate()
    refuse_moe(cfg)
    return cfg


def t5_stack_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """(encoder layers, decoder layers): asymmetric when the config sets
    them (--encoder_num_layers / --decoder_num_layers)."""
    return (cfg.encoder_num_layers or cfg.num_layers,
            cfg.decoder_num_layers or cfg.num_layers)


def t5_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat {path: shape}, the JAX package's table."""
    h = cfg.hidden_size
    Le, Ld = t5_stack_depths(cfg)
    D, nq = cfg.head_dim, cfg.num_attention_heads
    F = cfg.ffn_size * mlp_input_width_factor(cfg.activation)
    Fo = cfg.ffn_size
    d: Dict[str, tuple] = {
        "embed/tokens": (cfg.vocab_size, h),
        "embed/pos": (cfg.max_position_embeddings, h),
    }

    def attn_block(prefix: str, L: int):
        for n in ("wq", "wk", "wv"):
            d[f"{prefix}/{n}"] = (L, h, nq * D)
            if cfg.use_bias_qkv:
                d[f"{prefix}/{n}_b"] = (L, nq * D)
        d[f"{prefix}/wo"] = (L, nq * D, h)
        if cfg.use_bias_linear:
            d[f"{prefix}/wo_b"] = (L, h)

    def stack(side: str, cross: bool, L: int):
        d[f"{side}/ln1/scale"] = (L, h)
        d[f"{side}/ln1/bias"] = (L, h)
        attn_block(f"{side}/attn", L)
        if cross:
            d[f"{side}/ln_cross/scale"] = (L, h)
            d[f"{side}/ln_cross/bias"] = (L, h)
            attn_block(f"{side}/cross", L)
        d[f"{side}/ln2/scale"] = (L, h)
        d[f"{side}/ln2/bias"] = (L, h)
        d[f"{side}/mlp/w_in"] = (L, h, F)
        if cfg.use_bias_linear:
            d[f"{side}/mlp/w_in_b"] = (L, F)
        d[f"{side}/mlp/w_out"] = (L, Fo, h)
        if cfg.use_bias_linear:
            d[f"{side}/mlp/w_out_b"] = (L, h)

    stack("encoder", cross=False, L=Le)
    stack("decoder", cross=True, L=Ld)
    d["encoder/final_ln/scale"] = (h,)
    d["encoder/final_ln/bias"] = (h,)
    d["decoder/final_ln/scale"] = (h,)
    d["decoder/final_ln/bias"] = (h,)
    return d


def t5_param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Flat {path: PartitionSpec}, the JAX package's Megatron-style
    tensor-parallel cut (QKV and MLP-in by columns, attention-out and
    MLP-out by rows, the embedding by vocab rows)."""
    def spec_for(path: str, shape) -> P:
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "tokens":
            return P("tensor", None)
        if leaf in ("wq", "wk", "wv", "w_in"):
            return P(None, None, "tensor")
        if leaf in ("wq_b", "wk_b", "wv_b", "w_in_b"):
            return P(None, "tensor")
        if leaf in ("wo", "w_out"):
            return P(None, "tensor", None)
        return P(*(None,) * len(shape))

    return {path: spec_for(path, shape)
            for path, shape in t5_param_shapes(cfg).items()}


def t5_init_params(cfg: ModelConfig, seed: int, device="cuda"
                   ) -> Dict[str, Any]:
    """Random init with the JAX package's rule: norm scales 1, biases 0,
    the output-facing products (wo, w_out) at std / sqrt(2 * depth of
    their own stack), the rest at init_method_std. Each leaf draws from
    its own generator (models/params.init_leaf)."""
    Le, Ld = t5_stack_depths(cfg)
    scaled_std = {"encoder": cfg.init_method_std / math.sqrt(2.0 * Le),
                  "decoder": cfg.init_method_std / math.sqrt(2.0 * Ld)}
    flat = {}
    for path, shape in sorted(t5_param_shapes(cfg).items()):
        if path.endswith("scale"):
            kind, std = _ONES, 0.0
        elif path.endswith(("bias", "_b")):
            kind, std = _ZEROS, 0.0
        else:
            kind = _NORMAL
            std = (scaled_std[path.split("/", 1)[0]]
                   if path.endswith(("wo", "w_out")) else cfg.init_method_std)
        flat[path] = init_leaf(path, shape, kind, std, seed,
                               torch.device(device), cfg.dtype)
    return _nest(flat)


def t5_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> Dict[str, Any]:
    """A JAX t5_init_params tree (numpy leaves) -> this package's tree."""
    return tree_from_numpy(tree, t5_param_shapes(cfg), device, cfg.dtype)


def _proj(x, p, name):
    out = x @ p[name]
    if f"{name}_b" in p:
        out = out + p[f"{name}_b"]
    return out


def _attn(cfg, p, x_q, x_kv, mask_type, padding_mask):
    b, sq, _ = x_q.shape
    D, nq = cfg.head_dim, cfg.num_attention_heads
    q = _proj(x_q, p, "wq").reshape(b, sq, nq, D)
    k = _proj(x_kv, p, "wk").reshape(b, x_kv.shape[1], nq, D)
    v = _proj(x_kv, p, "wv").reshape(b, x_kv.shape[1], nq, D)
    ctx = attention(q, k, v, mask_type=mask_type, padding_mask=padding_mask,
                    softmax_fp32=cfg.softmax_fp32, impl="xla")
    return _proj(ctx.reshape(b, sq, nq * D), p, "wo")


def _mlp(cfg, p, x):
    h = apply_activation(cfg.activation, _proj(x, p, "w_in"))
    return _proj(h, p, "w_out")


def _embed(params, tokens):
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return (params["embed"]["tokens"][tokens.long()]
            + params["embed"]["pos"][pos][None])


def _norm(cfg, p, x):
    return norm_forward(cfg.normalization, x, p["scale"], p.get("bias"),
                        cfg.layernorm_epsilon)


def t5_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    enc_tokens: torch.Tensor,        # [B, Se]
    dec_tokens: torch.Tensor,        # [B, Sd]
    enc_padding_mask: torch.Tensor,  # [B, Se] True = real
) -> torch.Tensor:
    """Returns the decoder's LM logits [B, Sd, V]."""
    Le, Ld = t5_stack_depths(cfg)
    enc = params["encoder"]
    x = _embed(params, enc_tokens)
    for lp in _layers({k: enc[k] for k in ("ln1", "attn", "ln2", "mlp")},
                      Le):
        h = _norm(cfg, lp["ln1"], x)
        x = x + _attn(cfg, lp["attn"], h, h, "bidirectional",
                      enc_padding_mask)
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    enc_out = _norm(cfg, enc["final_ln"], x)

    dec = params["decoder"]
    y = _embed(params, dec_tokens)
    for lp in _layers({k: dec[k] for k in ("ln1", "attn", "ln_cross",
                                           "cross", "ln2", "mlp")}, Ld):
        h = _norm(cfg, lp["ln1"], y)
        y = y + _attn(cfg, lp["attn"], h, h, "causal", None)
        y = y + _attn(cfg, lp["cross"], _norm(cfg, lp["ln_cross"], y),
                      enc_out, "bidirectional", enc_padding_mask)
        y = y + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], y))
    y = _norm(cfg, dec["final_ln"], y)
    return y @ params["embed"]["tokens"].t()


def t5_loss(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: enc_tokens, enc_padding_mask, dec_tokens, labels, loss_mask.
    Returns (masked CE of the decoder's predictions, {"lm_loss"})."""
    logits = t5_forward(cfg, params, batch["enc_tokens"], batch["dec_tokens"],
                        batch["enc_padding_mask"] > 0)
    loss, _ = cross_entropy_loss(logits, batch["labels"],
                                 loss_mask=batch.get("loss_mask"))
    return loss, {"lm_loss": loss}
