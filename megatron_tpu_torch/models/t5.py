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

Tensor parallelism (a MeshRuntime as `mesh`, the cut of t5_param_specs):
each attention and MLP enters through copy_to_tp (the cross-attention's
encoder output too), runs this rank's heads and ffn columns, and leaves
its row-parallel product through reduce_from_tp before the replicated
output bias; the embedding is vocab-parallel and the tied logits are
this rank's vocab columns under the vocab-parallel CE. Sequence
parallelism is not ported for T5 (the JAX package's T5 tests run TP
alone). Pipeline parallelism: training/t5_pipeline.py runs enc_stack and
dec_stack stage by stage.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from megatron_tpu_torch.config import ModelConfig
import torch.nn.functional as F

from megatron_tpu_torch.models.bert import refuse_moe
from megatron_tpu_torch.models.language_model import (
    _ce, _layers, batch_mean, run_layers,
)
from megatron_tpu_torch.models.params import (
    _NORMAL, _ONES, _ZEROS, _nest, init_leaf, tree_from_numpy,
)
from megatron_tpu_torch.ops.activations import (
    apply_activation, mlp_input_width_factor,
)
from megatron_tpu_torch.ops.attention import attention
from megatron_tpu_torch.ops.normalization import norm_forward
from megatron_tpu_torch.parallel.mappings import copy_to_tp, reduce_from_tp
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


def t5_param_specs(cfg: ModelConfig, pipeline: bool = False
                   ) -> Dict[str, P]:
    """Flat {path: PartitionSpec}, the JAX package's Megatron-style
    tensor-parallel cut (QKV and MLP-in by columns, attention-out and
    MLP-out by rows, the embedding by vocab rows). pipeline: the stacked
    [L, ...] leaves of both stacks are also cut over "pipe" (the layer
    slices training/t5_pipeline.py's stages hold, as the JAX pipeline's
    shard_map in_specs cut them)."""
    def spec_for(path: str, shape) -> P:
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "tokens":
            return P("tensor", None)
        if leaf in ("wq", "wk", "wv", "w_in"):
            spec = [None, None, "tensor"]
        elif leaf in ("wq_b", "wk_b", "wv_b", "w_in_b"):
            spec = [None, "tensor"]
        elif leaf in ("wo", "w_out"):
            spec = [None, "tensor", None]
        else:
            spec = [None] * len(shape)
        if pipeline and path.split("/")[1] != "final_ln" and \
                path.startswith(("encoder/", "decoder/")):
            spec[0] = "pipe"
        return P(*spec)

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


def _row_out(x, p, name, mesh):
    """A row-parallel product's partial sums reduced, then its bias."""
    out = reduce_from_tp(x @ p[name], mesh)
    if f"{name}_b" in p:
        out = out + p[f"{name}_b"]
    return out


def _attn(cfg, p, x_q, x_kv, mask_type, padding_mask, mesh=None):
    b, sq, _ = x_q.shape
    D = cfg.head_dim
    nq = cfg.num_attention_heads // (mesh.tp if mesh is not None else 1)
    xq = copy_to_tp(x_q, mesh)
    xkv = xq if x_kv is x_q else copy_to_tp(x_kv, mesh)
    q = _proj(xq, p, "wq").reshape(b, sq, nq, D)
    k = _proj(xkv, p, "wk").reshape(b, x_kv.shape[1], nq, D)
    v = _proj(xkv, p, "wv").reshape(b, x_kv.shape[1], nq, D)
    ctx = attention(q, k, v, mask_type=mask_type, padding_mask=padding_mask,
                    softmax_fp32=cfg.softmax_fp32, impl="xla")
    return _row_out(ctx.reshape(b, sq, nq * D), p, "wo", mesh)


def _mlp(cfg, p, x, mesh=None):
    h = apply_activation(cfg.activation, _proj(copy_to_tp(x, mesh), p,
                                               "w_in"))
    return _row_out(h, p, "w_out", mesh)


def embed(params, tokens, mesh=None):
    """Token (vocab-parallel under TP) plus position embeddings."""
    table = params["embed"]["tokens"]
    if mesh is None or mesh.tp == 1:
        x = table[tokens.long()]
    else:
        rows = table.shape[0]
        local = tokens.long() - mesh.tp_rank * rows
        inside = (local >= 0) & (local < rows)
        x = reduce_from_tp(F.embedding(local.clamp(0, rows - 1), table)
                           .masked_fill(~inside[..., None], 0), mesh)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return x + params["embed"]["pos"][pos][None]


def _norm(cfg, p, x):
    return norm_forward(cfg.normalization, x, p["scale"], p.get("bias"),
                        cfg.layernorm_epsilon)


ENC_KEYS = ("ln1", "attn", "ln2", "mlp")
DEC_KEYS = ("ln1", "attn", "ln_cross", "cross", "ln2", "mlp")


def _enc_layer(cfg, lp, padding_mask, mesh, x):
    h = _norm(cfg, lp["ln1"], x)
    x = x + _attn(cfg, lp["attn"], h, h, "bidirectional", padding_mask, mesh)
    x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x), mesh)
    return x, None, x.new_zeros((), dtype=torch.float32)


def _dec_layer(cfg, lp, enc_out, padding_mask, mesh, y):
    h = _norm(cfg, lp["ln1"], y)
    y = y + _attn(cfg, lp["attn"], h, h, "causal", None, mesh)
    y = y + _attn(cfg, lp["cross"], _norm(cfg, lp["ln_cross"], y), enc_out,
                  "bidirectional", padding_mask, mesh)
    y = y + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], y), mesh)
    return y, None, y.new_zeros((), dtype=torch.float32)


def enc_stack(cfg, stack, x, padding_mask, recompute="none", mesh=None):
    """x through the encoder layers of `stack` (its ENC_KEYS subtrees,
    any number of stacked layers) under a recompute policy."""
    layers = {k: stack[k] for k in ENC_KEYS}
    n = layers["ln1"]["scale"].shape[0]
    return run_layers([functools.partial(_enc_layer, cfg, lp, padding_mask,
                                         mesh)
                       for lp in _layers(layers, n)], x, recompute)[0]


def dec_stack(cfg, stack, y, enc_out, padding_mask, recompute="none",
              mesh=None):
    """y through the decoder layers of `stack`, cross-attending to
    enc_out."""
    layers = {k: stack[k] for k in DEC_KEYS}
    n = layers["ln1"]["scale"].shape[0]
    return run_layers([functools.partial(_dec_layer, cfg, lp, enc_out,
                                         padding_mask, mesh)
                       for lp in _layers(layers, n)], y, recompute)[0]


def tied_logits(cfg, params, y, mesh=None):
    """The decoder's final norm and the tied LM head (this rank's vocab
    columns under TP)."""
    y = _norm(cfg, params["decoder"]["final_ln"], y)
    return copy_to_tp(y, mesh) @ params["embed"]["tokens"].t()


def t5_forward(
    cfg: ModelConfig,
    params: Dict[str, Any],
    enc_tokens: torch.Tensor,        # [B, Se]
    dec_tokens: torch.Tensor,        # [B, Sd]
    enc_padding_mask: torch.Tensor,  # [B, Se] True = real
    recompute: str = "none",
    mesh=None,
) -> torch.Tensor:
    """Returns the decoder's LM logits [B, Sd, V] ([B, Sd, V/tp] under
    tensor parallelism)."""
    if mesh is not None and mesh.sequence_parallel:
        raise ValueError("T5 under sequence parallelism is not ported "
                         "(ROADMAP.md): run tensor parallelism alone")
    x = enc_stack(cfg, params["encoder"], embed(params, enc_tokens, mesh),
                  enc_padding_mask, recompute, mesh)
    enc_out = _norm(cfg, params["encoder"]["final_ln"], x)
    y = dec_stack(cfg, params["decoder"], embed(params, dec_tokens, mesh),
                  enc_out, enc_padding_mask, recompute, mesh)
    return tied_logits(cfg, params, y, mesh)


def t5_loss(
    cfg: ModelConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    recompute: str = "none",
    mesh=None,
    dropout_key=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: enc_tokens, enc_padding_mask, dec_tokens, labels, loss_mask.
    Returns (masked CE of the decoder's predictions, {"lm_loss"}); under
    tensor parallelism the vocab-parallel CE; above one data rank this
    rank's share of the global microbatch's masked mean
    (language_model.batch_mean). dropout_key is taken and unused: T5
    applies no dropout whatever the config says, as the JAX package's
    T5 draws none."""
    logits = t5_forward(cfg, params, batch["enc_tokens"], batch["dec_tokens"],
                        batch["enc_padding_mask"] > 0, recompute, mesh)
    loss = batch_mean(_ce(logits, batch["labels"], mesh)[1],
                      batch.get("loss_mask"), mesh)
    return loss, {"lm_loss": loss}
