"""Parameter tree: shapes and initialization
(counterpart of megatron_tpu/models/params.py).

The tree keeps the JAX package's flat '/' paths and stacked [L, ...]
layer shapes, nested into plain dicts of tensors, so a JAX parameter
tree converts 1:1 through numpy (params_from_numpy) and both packages
compute the same function. The PartitionSpec column is dropped: this
slice serves on one GPU.
"""

from __future__ import annotations

import math
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.ops.activations import mlp_input_width_factor

_NORMAL = "normal"          # N(0, init_method_std)
_SCALED = "scaled_normal"   # N(0, std / sqrt(2 * num_layers)) (output-facing)
_ONES = "ones"
_ZEROS = "zeros"


def _defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Flat {'/'-joined path: (shape, init_kind)}."""
    h = cfg.hidden_size
    L = cfg.num_layers
    D = cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.n_kv_heads
    F = cfg.ffn_size
    Fin = F * mlp_input_width_factor(cfg.activation)
    V = cfg.vocab_size

    d: Dict[str, Any] = {}
    d["embed/tokens"] = ((V, h), _NORMAL)
    if cfg.position_embedding_type == "absolute":
        d["embed/pos"] = ((cfg.max_position_embeddings, h), _NORMAL)

    ln_bias = cfg.normalization == "layernorm"
    norms = ["layers/ln1"]
    if not cfg.parallel_attn:
        norms.append("layers/ln2")
    if cfg.parallel_layernorm:
        norms.append("layers/ln_mlp")
    for prefix in norms:
        d[f"{prefix}/scale"] = ((L, h), _ONES)
        if ln_bias:
            d[f"{prefix}/bias"] = ((L, h), _ZEROS)

    d["layers/attn/wq"] = ((L, h, nq * D), _NORMAL)
    d["layers/attn/wk"] = ((L, h, nkv * D), _NORMAL)
    d["layers/attn/wv"] = ((L, h, nkv * D), _NORMAL)
    d["layers/attn/wo"] = ((L, nq * D, h), _SCALED)
    if cfg.use_bias_qkv:
        d["layers/attn/bq"] = ((L, nq * D), _ZEROS)
        d["layers/attn/bk"] = ((L, nkv * D), _ZEROS)
        d["layers/attn/bv"] = ((L, nkv * D), _ZEROS)
    if cfg.use_bias_linear:
        d["layers/attn/bo"] = ((L, h), _ZEROS)

    d["layers/mlp/w_in"] = ((L, h, Fin), _NORMAL)
    d["layers/mlp/w_out"] = ((L, F, h), _SCALED)
    if cfg.use_bias_linear:
        d["layers/mlp/b_in"] = ((L, Fin), _ZEROS)
        d["layers/mlp/b_out"] = ((L, h), _ZEROS)

    if not cfg.use_post_ln:  # post-LN layers carry their own output norm
        d["final_ln/scale"] = ((h,), _ONES)
        if ln_bias:
            d["final_ln/bias"] = ((h,), _ZEROS)
    if not cfg.tie_embed_logits:
        d["lm_head/w"] = ((h, V), _NORMAL)
    return d


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat {path: shape}."""
    return {k: s for k, (s, _) in _defs(cfg).items()}


def num_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s, _ in _defs(cfg).values())


def empty_params(cfg: ModelConfig, device="cuda",
                 dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The parameter tree, uninitialized: the target of a checkpoint
    load (training/checkpointing.load_params_only)."""
    dtype = dtype or cfg.dtype
    return _nest({path: torch.empty(shape, dtype=dtype, device=device)
                  for path, (shape, _) in sorted(_defs(cfg).items())})


def init_params(cfg: ModelConfig, seed: int, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random-init the full parameter tree on `device`.

    Each tensor draws from its own torch.Generator seeded from the seed
    and a stable hash of its path (the JAX package folds the same hash
    into its key), so adding or removing an optional parameter never
    perturbs the others. The draws differ from jax.random's: parity
    tests share weights through params_from_numpy instead."""
    dtype = dtype or cfg.dtype
    device = torch.device(device)
    scaled_std = (cfg.init_method_std / math.sqrt(2.0 * cfg.num_layers)
                  if cfg.use_scaled_init else cfg.init_method_std)
    flat = {}
    for path, (shape, kind) in sorted(_defs(cfg).items()):
        if kind == _ONES:
            flat[path] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == _ZEROS:
            flat[path] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            std = scaled_std if kind == _SCALED else cfg.init_method_std
            gen = torch.Generator(device=device)
            gen.manual_seed(zlib.crc32(path.encode(), int(seed) & 0xFFFFFFFF))
            t = torch.empty(shape, dtype=dtype, device=device)
            flat[path] = t.normal_(0.0, std, generator=gen)
    return _nest(flat)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A JAX parameter tree, as nested dicts of numpy arrays
    (jax.device_get(params)), -> this package's parameter tree.

    Checks the tree against _defs(cfg) path by path and shape by shape,
    so a mismatched config fails here instead of computing garbage."""
    want = param_shapes(cfg)
    flat = _flatten(tree)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, "
                         f"unexpected {extra}")
    dtype = dtype or cfg.dtype
    out = {}
    for path, arr in flat.items():
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {a.shape} != {want[path]}")
        out[path] = torch.from_numpy(
            np.ascontiguousarray(a.astype(np.float32))).to(
                device=device, dtype=dtype)
    return _nest(out)
