"""int8 / fp8 weight-only quantization for serving (counterpart of
megatron_tpu/ops/weight_quant.py).

Matmul weights get symmetric per-output-channel scales, the token
embedding per-row scales (one scale serves the gather and the tied
logits product). int8 uses a uniform grid (ops/kv_quant.symmetric_int8);
fp8 (e4m3fn, the channel's amax mapped to its 448 max) a log grid. A
quantized leaf is {"q8": int8 | "f8": float8_e4m3fn, "s": fp32}: one
byte a weight instead of two. The use sites (models/transformer.py,
models/language_model.py) dequantize one layer's leaf at a time inside
the forward, (payload.f32 * s) rounded once to the activation dtype,
and feed the unchanged products; a captured decode tick captures the
dequantize with them. Biases, norms, the MoE experts and the router stay
in the model dtype (the _LINEAR_SITES scope).

Serving only: no gradient path, one card (the server refuses sharded
and MoE serving with these flags, as the JAX server does).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from megatron_tpu_torch.ops.kv_quant import symmetric_int8

_F8_MAX = 448.0  # float8_e4m3fn finite max

# (parent key, weight key) pairs quantized per output channel
_LINEAR_SITES = frozenset([
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("mlp", "w_in"), ("mlp", "w_out"), ("lm_head", "w"),
])


def _per_layer(fn, w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """fn over each leading-index slice of a stacked [L, ...] leaf (the
    channel reduction never crosses it), so the fp32 temporaries are one
    layer's, not the whole stack's."""
    if w.dim() < 3:
        return fn(w, dim)
    parts = [fn(w[i], dim) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def _int8(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    q, s = symmetric_int8(w, dim=dim)
    return {"q8": q, "s": s}


def _fp8(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    wf = w.float()
    amax = wf.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: the division the host makes (kv_quant's note)
    s = torch.clamp(amax, min=1e-12) / torch.full_like(amax, _F8_MAX)
    return {"f8": (wf / s).to(torch.float8_e4m3fn), "s": s}


def quantize_linear(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"q8": int8 same shape, "s": fp32 [..., 1, out]},
    on w's device."""
    return _per_layer(_int8, w, -2)


def quantize_rows(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, h] embedding -> {"q8", "s": [V, 1]} (per-row scales)."""
    return _int8(w, -1)


def quantize_linear_fp8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., in, out] -> {"f8", "s": [..., 1, out]}."""
    return _per_layer(_fp8, w, -2)


def quantize_rows_fp8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[V, h] embedding -> {"f8", "s": [V, 1]}."""
    return _fp8(w, -1)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and ("q8" in w or "f8" in w)


def _payload(w: Dict[str, Any]) -> torch.Tensor:
    """The payload in a dtype the elementwise product takes: int8 as is,
    fp8 widened to bf16 (exact: e4m3 values are bf16 values)."""
    if "q8" in w:
        return w["q8"]
    return w["f8"].to(torch.bfloat16)


def deq(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """A {q8|f8, s} leaf as (payload.f32 * s) rounded once to dtype (one
    elementwise kernel writing only the dtype result); a plain tensor
    passes through."""
    if not is_quantized(w):
        return w
    p = _payload(w)
    return torch.mul(p, w["s"], out=torch.empty(p.shape, dtype=dtype,
                                                device=p.device))


def take_rows(w: Any, ids: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """Embedding gather that dequantizes only the gathered rows."""
    if not is_quantized(w):
        return torch.nn.functional.embedding(ids, w)
    kind = "q8" if "q8" in w else "f8"
    payload = w[kind]
    if kind == "f8":
        # gather the bytes; the fp8 view is reattached after
        rows = payload.view(torch.uint8)[ids].view(torch.float8_e4m3fn)
    else:
        rows = payload[ids]
    return deq({kind: rows, "s": w["s"][ids]}, dtype)


def quantize_params_for_serving(params: Dict[str, Any],
                                mode: str = "int8") -> Dict[str, Any]:
    """Walk a (stacked-layers) parameter tree and quantize the matmul
    weights and the token embedding; everything else passes through (the
    same tensors). mode: "int8" or "fp8". Quantizes on each leaf's
    device, one layer at a time."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"unknown weight quant mode {mode!r}")
    q_linear = quantize_linear if mode == "int8" else quantize_linear_fp8
    q_rows = quantize_rows if mode == "int8" else quantize_rows_fp8

    def walk(node, name=None):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "tokens" and name == "embed":
                out[k] = q_rows(v)
            elif ((name, k) in _LINEAR_SITES and not isinstance(v, dict)
                  and v.dim() >= 2):
                out[k] = q_linear(v)
            else:
                out[k] = walk(v, k)
        return out

    return walk(params)


def quantized_mode(params: Dict[str, Any]):
    """"int8" or "fp8" for a tree quantize_params_for_serving made, None
    for a plain one (read from the attention's wq, always quantized)."""
    wq = params["layers"]["attn"]["wq"]
    if not is_quantized(wq):
        return None
    return "int8" if "q8" in wq else "fp8"


def weight_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every tensor in a (possibly quantized) parameter tree."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
