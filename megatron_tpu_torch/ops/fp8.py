"""fp8 training products (counterpart of megatron_tpu/ops/fp8.py).

The JAX package's quantized-GEMM structure with current per-tensor
scaling, TransformerEngine's Format.E4M3 and Format.HYBRID without the
delayed-scaling history:

  forward   out = (x8 @ w8) / (sx * sw)            x8, w8: e4m3
  backward  dx  = (g8 @ w8^T) / (sg * sw)          g8: e5m2 (hybrid) / e4m3
            dw  = (x8^T @ g8) / (sx * sg)          [x8^T @ g in fp32, / sx,
                                                    when fp8_wgrad is off]

fp8_matmul is a torch.autograd.Function whose saved residuals are the
fp8 operands (x8, w8) and their scales, half the bytes of a bf16
product's saved activations.

On CUDA tensors the three products go through torch._scaled_mm (the
JAX package computes them with lax.dot_general outside any Pallas
kernel; no TPU kernel is replaced here): the second operand
column-major, scale_a/scale_b the inverse scales, the result fp32 before
the cast to the operand's dtype. _scaled_mm takes no e5m2 x e5m2
product (none is asked for) and needs every dimension a multiple of 16;
a product that is not raises. On CPU tensors the plain version runs the
same steps as the JAX package does there: cast to the fp8 dtype, upcast
to fp32, matmul, the scale epilogue.

The casts follow ml_dtypes (the JAX package's fp8 dtypes): e4m3fn has
no inf, so a scaled value past 464 (the midpoint of 448 and the next
step, 480) and +-inf become NaN, where torch's own cast saturates to
448; e5m2 overflows to inf in both.

Across ranks the amax is the global tensor's, as GSPMD's jnp.max over a
sharded operand is: x's and g's are max-reduced over the batch, context
and tensor groups (a group over which the operand is replicated changes
nothing), w's over the tensor group. At world size 1 nothing is reduced.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from megatron_tpu_torch.parallel.mappings import all_reduce

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
FORMATS = ("hybrid", "e4m3")
_FMAX = {E4M3: 448.0, E5M2: 57344.0}
# ml_dtypes rounds |y| > 464 to NaN in e4m3fn (torch saturates)
_E4M3_NAN_ABOVE = 464.0


def _amax(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """max|t| in fp32 over the global tensor: this rank's piece,
    max-reduced over `groups` (None entries skipped)."""
    amax = t.detach().abs().amax().float()
    for g in groups:
        if g is not None:
            amax = all_reduce(amax, g, "max")
    return amax


def _scale(amax: torch.Tensor, fmax: float, margin: int) -> torch.Tensor:
    """fmax * 2^-margin / amax, fp32; a non-finite amax gives 1 (the
    guard tests amax, not the scale: fmax / inf = 0 is finite and would
    NaN every element through the epilogue)."""
    s = (fmax * (2.0 ** -margin)) / torch.clamp(amax, min=1e-12)
    return torch.where(torch.isfinite(amax), s, torch.ones_like(s))


def _q(t: torch.Tensor, s: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(t fp32 * s) cast to dt with ml_dtypes' rounding."""
    y = t.float() * s
    if dt == E4M3:
        y = torch.where(y.abs() > _E4M3_NAN_ABOVE,
                        torch.full_like(y, math.nan), y)
    return y.to(dt)


def _check_scaled_mm(a: torch.Tensor, b: torch.Tensor) -> None:
    m, k = a.shape
    n = b.shape[1]
    if m % 16 or k % 16 or n % 16:
        raise ValueError(
            f"fp8_matmul on CUDA: torch._scaled_mm needs every dimension "
            f"a multiple of 16, got [{m}, {k}] @ [{k}, {n}]")


def _mm(a8: torch.Tensor, b8: torch.Tensor, sa: torch.Tensor,
        sb: torch.Tensor, plain: bool) -> torch.Tensor:
    """(a8 @ b8) / (sa * sb) in fp32: a8 [M, K], b8 [K, N] fp8; plain:
    upcast and torch.matmul on any device."""
    if a8.device.type == "cuda" and not plain:
        _check_scaled_mm(a8, b8)
        a = a8 if a8.is_contiguous() else a8.contiguous()
        b = b8 if b8.t().is_contiguous() else b8.t().contiguous().t()
        out = torch._scaled_mm(a, b, scale_a=(1.0 / sa).reshape(()),
                               scale_b=(1.0 / sb).reshape(()),
                               out_dtype=torch.float32)
        # older PyTorch returns (out, amax)
        return out[0] if isinstance(out, tuple) else out
    if a8.device.type != "cpu" and not plain:
        raise ValueError(f"fp8_matmul: unsupported device {a8.device}")
    return (a8.float() @ b8.float()) / (sa * sb)


class _Fp8Matmul(torch.autograd.Function):
    """The custom VJP of the JAX package's fp8_matmul."""

    @staticmethod
    def forward(ctx, x, w, fmt, margin, fp8_wgrad, x_groups, w_groups,
                plain):
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        sx = _scale(_amax(x2, x_groups), _FMAX[E4M3], margin)
        sw = _scale(_amax(w, w_groups), _FMAX[E4M3], margin)
        x8, w8 = _q(x2, sx, E4M3), _q(w, sw, E4M3)
        out = _mm(x8, w8, sx, sw, plain).to(x.dtype)
        ctx.save_for_backward(x8, w8, sx, sw)
        ctx.cfg = (fmt, margin, fp8_wgrad, x_groups, x.dtype, w.dtype,
                   tuple(x.shape), plain)
        return out.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x8, w8, sx, sw = ctx.saved_tensors
        (fmt, margin, fp8_wgrad, x_groups, x_dtype, w_dtype, x_shape,
         plain) = ctx.cfg
        gdt = E5M2 if fmt == "hybrid" else E4M3
        g2 = g.reshape(-1, g.shape[-1])
        sg = _scale(_amax(g2, x_groups), _FMAX[gdt], margin)
        g8 = _q(g2, sg, gdt)
        dx = _mm(g8, w8.t(), sg, sw, plain).to(x_dtype).reshape(x_shape)
        if fp8_wgrad:
            dw = _mm(x8.t(), g8, sx, sg, plain)
        else:
            # --no_fp8_wgrad: the weight gradient in fp32 on the stored
            # e4m3 activations (TE's override_linear_precision)
            dw = (x8.float().t() @ g2.float()) / sx
        return dx, dw.to(w_dtype), None, None, None, None, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, fmt: str = "hybrid",
               margin: int = 0, fp8_wgrad: bool = True,
               x_groups: Sequence = (), w_groups: Sequence = (),
               plain: bool = False) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> [..., N] through fp8 products (the module
    docstring). fmt "hybrid" (e4m3 forward, e5m2 gradients) or "e4m3";
    x_groups / w_groups: the process groups the operands' amax is
    max-reduced over (g shares x's). plain: the plain version's fp32
    products on any device (CPU tensors always take them; the card
    check holds the _scaled_mm route against them)."""
    if fmt not in FORMATS:
        raise ValueError(f"fp8 format {fmt!r}: expected 'hybrid' or 'e4m3'")
    return _Fp8Matmul.apply(x, w, fmt, int(margin), bool(fp8_wgrad),
                            tuple(x_groups), tuple(w_groups), bool(plain))


def amax_groups(mesh) -> tuple:
    """(x_groups, w_groups) of a rank: the batch, context and tensor
    groups for activations and gradients, the tensor group for weights
    (each None when its axis has one rank); ((), ()) without a mesh."""
    if mesh is None or mesh.world_size == 1:
        return (), ()
    from megatron_tpu_torch.parallel.mesh import (
        AXIS_CONTEXT, AXIS_TENSOR, BATCH_AXES,
    )

    tensor = mesh.group(AXIS_TENSOR)
    return ((mesh.group(BATCH_AXES), mesh.group(AXIS_CONTEXT), tensor),
            (tensor,))


def maybe_fp8_matmul(cfg, x: torch.Tensor, w: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """The projection product of the transformer block: fp8 when
    cfg.fp8_format is set, torch.matmul otherwise."""
    if cfg.fp8_format is None:
        return torch.matmul(x, w)
    xg, wg = amax_groups(mesh)
    return fp8_matmul(x, w, fmt=cfg.fp8_format, margin=cfg.fp8_margin,
                      fp8_wgrad=cfg.fp8_wgrad, x_groups=xg, w_groups=wg)
