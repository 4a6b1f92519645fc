"""Quantize/dequantize primitives for compressed collectives
(counterpart of megatron_tpu/quant/primitives.py).

Per-chunk symmetric scaling along the LAST axis: int8 (127-level
clamp/round, the recipe of ops/kv_quant.py but chunked instead of per
vector) or fp8 e4m3fn. Chunked scales keep one outlier from poisoning
more than its own `chunk` elements (Flash Communication 2412.04964).

Each recipe has a worst-case round-trip bound
(``quantization_error_bound``), for every element
``|x - deq(quant(x))| <= bound(x)``:

  * int8: the scale is chunk_amax / 127 and values land in [-127, 127],
    so the only error is round-to-nearest: bound = scale / 2;
  * fp8 (e4m3fn, 3 mantissa bits): normals round within a relative
    half-ulp of 2^-4, subnormals within an absolute 2^-10 of the scaled
    value: bound = |x| * 2^-4 + scale * 2^-10.

The arithmetic is the JAX package's in fp32: torch.round rounds half to
even as jnp.round does, and the fp8 cast rounds to nearest even as
ml_dtypes' does (|x / scale| <= 448 by construction, so it never
saturates), so int8 payloads and scales, and fp8 bytes, equal the JAX
package's on the same fp32 input. The divisors 127 and 448 are tensors:
CUDA divides by a Python scalar as a product with its reciprocal, one
bit short of a division.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: fp8 transport format: e4m3fn (e5m2's 2-bit mantissa would double the
#: rounding error for no range benefit on amax-normalized chunks)
FP8_DTYPE_NAME = "float8_e4m3fn"
_FP8_MAX = 448.0


def fp8_supported() -> bool:
    """Whether this torch build carries the fp8 transport dtype (the
    --serve_compress_collectives fp8 gate)."""
    return hasattr(torch, FP8_DTYPE_NAME)


def _fp8_dtype():
    if not fp8_supported():
        raise ValueError(
            f"this toolchain has no torch.{FP8_DTYPE_NAME}; use int8 "
            "compressed collectives instead")
    return getattr(torch, FP8_DTYPE_NAME)


def effective_chunk(width: int, chunk: int) -> int:
    """The largest divisor of `width` that is <= `chunk` (>= 1): the
    scale granularity used when the requested chunk does not tile the
    quantized axis."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    c = max(1, min(int(chunk), width))
    while width % c:
        c -= 1
    return c


def _chunked(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[..., W] -> [..., W/chunk, chunk] fp32."""
    w = x.shape[-1]
    if w % chunk:
        raise ValueError(f"chunk {chunk} does not divide width {w} "
                         "(use effective_chunk)")
    return x.float().reshape(*x.shape[:-1], w // chunk, chunk)


def _scale(amax: torch.Tensor, levels: float) -> torch.Tensor:
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, levels)


def quantize_chunked(x: torch.Tensor, chunk: int, mode: str = "int8"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., W] float -> (q [..., W] int8 or float8_e4m3fn, scales fp32
    [..., W/chunk]) with per-chunk symmetric max-abs scaling along the
    last axis."""
    if mode not in ("int8", "fp8"):
        raise ValueError(f"unknown quantization mode {mode!r} "
                         "(expected 'int8' or 'fp8')")
    xc = _chunked(x, chunk)
    amax = xc.abs().amax(dim=-1, keepdim=True)
    if mode == "int8":
        scale = _scale(amax, 127.0)
        q = torch.clamp(torch.round(xc / scale), -127, 127).to(torch.int8)
    else:
        dt = _fp8_dtype()
        scale = _scale(amax, _FP8_MAX)
        q = (xc / scale).to(dt)
    return q.reshape(x.shape), scale[..., 0]


def dequantize_chunked(q: torch.Tensor, scales: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_chunked: scales broadcast back over their
    chunk, the fp32 product rounded once to `dtype`."""
    w = q.shape[-1]
    chunk = w // scales.shape[-1]
    qc = q.float().reshape(*q.shape[:-1], w // chunk, chunk)
    return (qc * scales[..., None]).reshape(q.shape).to(dtype)


def quantization_error_bound(x: torch.Tensor, chunk: int,
                             mode: str = "int8") -> torch.Tensor:
    """Per-element worst-case |x - deq(quant(x))| of the recipes above
    (the module docstring's derivation)."""
    xc = _chunked(x, chunk)
    amax = xc.abs().amax(dim=-1, keepdim=True)
    if mode == "int8":
        bound = (_scale(amax, 127.0) / 2.0).expand(xc.shape)
    elif mode == "fp8":
        _fp8_dtype()
        bound = xc.abs() * 2.0 ** -4 + _scale(amax, _FP8_MAX) * 2.0 ** -10
    else:
        raise ValueError(f"unknown quantization mode {mode!r}")
    return bound.reshape(x.shape)


def wire_view(q: torch.Tensor) -> torch.Tensor:
    """A low-bit payload as the collectives move it: fp8 as its bytes
    (uint8; neither gloo nor every NCCL build takes float8 tensors),
    int8 as it is."""
    return q.view(torch.uint8) if q.dtype != torch.int8 else q


def from_wire(q: torch.Tensor, mode: str) -> torch.Tensor:
    """Inverse of wire_view for `mode`'s payload dtype."""
    return q.view(_fp8_dtype()) if mode == "fp8" else q
