"""The flash-attention kernels' wrappers and plain versions
(counterpart of megatron_tpu/ops/pallas/flash_template.py).

Four kernels, each a hand-written CUDA C++ kernel for Hopper in csrc/:

  wrapper         kernel (csrc/)      replaces (TPU kernel)
  flash_fwd       flash_fwd.cu        flash_template.py _fwd_kernel (_fwd)
  flash_bwd_dq    flash_bwd.cu        flash_template.py _dq_kernel (_bwd)
  flash_bwd_dkv   flash_bwd.cu        flash_template.py _dkv_kernel (_bwd)
  flash_decode    flash_decode.cu     flash_template.py _decode_kernel
                                      (_decode_call, dense launch)

Beside the wrappers are their plain PyTorch versions (flash_fwd_reference,
flash_bwd_reference for both backward kernels, flash_decode_reference):
the same functions in fp32, which the CPU tests use and which the card's
smoke run holds the kernels against. A wrapper takes the plain version
only for tensors on the CPU. For CUDA tensors it launches its kernel or
raises; there is no fallback. Each wrapper counts its kernel launches in
a plain integer attribute (flash_fwd.launches, flash_bwd_dq.launches,
flash_bwd_dkv.launches, flash_decode.launches), incremented where the
kernel is launched and nowhere else.

_FlashAttention, the torch.autograd.Function behind flash_mha, takes the
place of the JAX package's jax.custom_vjp _flash_bhsd: its forward runs
flash_fwd and saves (q, k, v, o, lse), its backward runs flash_bwd (the
dq and dk/dv kernels). On CPU tensors the same Function runs the plain
forward and the plain backward.

Layouts are the framework's [B, S, H, D] throughout; the kernels read
them through strides. The paged decode launch is not ported yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from megatron_tpu_torch.ops.flash import build
from megatron_tpu_torch.ops.flash.masks import NEG_INF, visible

#: head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 128)
#: decode query rows per kv head (Sq * G) one block holds
DECODE_MAX_ROWS = 64
#: kv positions per decode tile; engines round their cache length to it
DECODE_BLOCK = 64

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: wrapper -> (library in build.KERNELS, C symbol, argument types)
_SIGNATURES = {
    "flash_fwd": ("flash_fwd", "mtt_flash_fwd_bf16",
                  [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _I, _I, _I, _P]),
    "flash_bwd_dq": ("flash_bwd", "mtt_flash_bwd_dq_bf16",
                     [_P] * 7 + [_I] * 6 + [_L] * 15 + [_F, _I, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd", "mtt_flash_bwd_dkv_bf16",
                      [_P] * 8 + [_I] * 6 + [_L] * 18
                      + [_F, _I, _I, _I, _P]),
    "flash_decode": ("flash_decode", "mtt_flash_decode_bf16",
                     [_P] * 5 + [_I] * 6 + [_L] * 12 + [_F, _I, _P]),
}
_entries = {}


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        library, symbol, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(library), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check_cuda_inputs(name: str, tensors, head_dim: int) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got "
                             f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: head dim must be contiguous and other strides "
                f"multiples of 8 elements (16-byte rows), got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(
                f"{name}: a direct kernel call carries no gradient; use "
                "flash_mha (the autograd Function that runs the backward "
                "kernels) or call under torch.no_grad()")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} not in "
                         f"{KERNEL_HEAD_DIMS}")


def _window_arg(sliding_window: Optional[int]) -> int:
    if sliding_window is None:
        return 0
    if sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    return int(sliding_window)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _check_heads(hq: int, hkv: int) -> None:
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")


# ---------------------------------------------------------------------------
# prefill forward (replaces _fwd_kernel)
# ---------------------------------------------------------------------------


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        sliding_window: Optional[int] = None,
                        delta: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash_fwd kernel, in fp32.

    q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D]; query row i sits at global
    position i + delta, key column j at j. Returns (o [B, Sq, Hq, D] in
    q's dtype, lse [B, Hq, Sq] fp32). Masked scores take NEG_INF and l is
    clamped at 1e-30, so a fully masked row gives o = 0, as the kernel
    does."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_heads(hq, hkv)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(sq, device=q.device)[:, None] + delta
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = visible(q_pos, k_pos, causal=causal, window=sliding_window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sliding_window: Optional[int] = None,
              delta: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """FlashAttention-2 forward -> (o [B, Sq, Hq, D], lse [B, Hq, Sq]).

    CPU tensors: the plain version. CUDA tensors: the csrc/flash_fwd.cu
    kernel (bf16, head dim 64 or 128, any Sq/Skv >= 1), or ValueError."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal,
                                   sliding_window=sliding_window, delta=delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    _check_heads(hq, hkv)
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_fwd: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    _check_cuda_inputs("flash_fwd", (q, k, v), d)
    window = _window_arg(sliding_window)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = _entry("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, skv, hq, hkv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        1.0 / math.sqrt(d), int(causal), window, int(delta),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# prefill backward (replaces _dq_kernel and _dkv_kernel)
# ---------------------------------------------------------------------------


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        sliding_window: Optional[int] = None,
                        delta: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the flash_bwd_dq and flash_bwd_dkv kernels, in
    fp32 with the JAX kernels' formulas (the FA-2 recompute backward).

    q/o/do [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], lse [B, Hq, Sq] from the
    forward. p = exp(q·kᵀ·scale − lse) where visible, else 0;
    dsum = rowsum(do·o); ds = p·(do·vᵀ − dsum); dq = scale·ds·k,
    dk = dsᵀ·(q·scale) and dv = pᵀ·do, group-summed over the G query
    heads of each kv head. Returns (dq, dk, dv) in q's, k's and v's
    dtypes."""
    return _bwd_plain(q, k, v, do, lse, _bwd_dsum(o, do), causal,
                      sliding_window, delta)


def _bwd_dsum(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do·o) in fp32 as [B, H, S]: the JAX package computes it
    outside its kernels too (_bwd's delta)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, dsum, causal, sliding_window, delta):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check_heads(hq, hkv)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = torch.arange(sq, device=q.device)[:, None] + delta
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = visible(q_pos, k_pos, causal=causal, window=sliding_window)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, skv, hkv, g, d).sum(3)
    dv = dv.reshape(b, skv, hkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_inputs(name, q, k, v, do, lse, dsum):
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    _check_heads(hq, hkv)
    if ((bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape)
            or tuple(do.shape) != tuple(q.shape)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do "
                         f"{tuple(do.shape)}")
    _check_cuda_inputs(name, (q, k, v, do), d)
    for t, what in ((lse, "lse"), (dsum, "dsum")):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (b, hq, sq) or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"[{b}, {hq}, {sq}] float32 tensor on "
                             f"{q.device}")


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, dsum: torch.Tensor, *,
                 causal: bool = True, sliding_window: Optional[int] = None,
                 delta: int = 0) -> torch.Tensor:
    """dq [B, Sq, Hq, D] of the recompute backward; dsum = rowsum(do·o)
    as [B, Hq, Sq] fp32.

    CUDA tensors: the csrc/flash_bwd.cu dq kernel (bf16, head dim 64 or
    128, any S >= 1), or ValueError. CPU tensors: the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, causal, sliding_window,
                          delta)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: unsupported device {q.device}")
    _check_bwd_inputs("flash_bwd_dq", q, k, v, do, lse, dsum)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = _entry("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), b, sq, skv, hq, hkv,
        d, *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        *_strides(dq), 1.0 / math.sqrt(d), int(causal),
        _window_arg(sliding_window), int(delta),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd_dq kernel launch failed: cudaError {rc}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, dsum: torch.Tensor, *,
                  causal: bool = True, sliding_window: Optional[int] = None,
                  delta: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Skv, Hkv, D] of the recompute backward, summed over
    each kv head's G query heads.

    CUDA tensors: the csrc/flash_bwd.cu dk/dv kernel (bf16, head dim 64
    or 128, any S >= 1), or ValueError. CPU tensors: the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, dsum, causal, sliding_window,
                          delta)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: unsupported device {q.device}")
    _check_bwd_inputs("flash_bwd_dkv", q, k, v, do, lse, dsum)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    rc = _entry("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
        skv, hq, hkv, d, *_strides(q), *_strides(k), *_strides(v),
        *_strides(do), *_strides(dk), *_strides(dv), 1.0 / math.sqrt(d),
        int(causal), _window_arg(sliding_window), int(delta),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_bwd_dkv kernel launch failed: cudaError {rc}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, sliding_window: Optional[int] = None,
              delta: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the recompute backward (the JAX package's _bwd).

    CPU tensors: flash_bwd_reference. CUDA tensors: dsum = rowsum(do·o)
    as a PyTorch expression (JAX computes it outside its kernels too),
    then the flash_bwd_dq and flash_bwd_dkv kernels."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                   sliding_window=sliding_window,
                                   delta=delta)
    kw = dict(causal=causal, sliding_window=sliding_window, delta=delta)
    dsum = _bwd_dsum(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, dsum, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """flash_fwd with the recompute backward: the counterpart of the JAX
    package's jax.custom_vjp _flash_bhsd (flash_template.py:350-368).

    forward saves (q, k, v, o, lse); backward runs flash_bwd. Grad mode
    is off inside forward, so the raw wrapper's refusal of tensors that
    require a gradient does not fire here."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, delta):
        o, lse = flash_fwd(q, k, v, causal=causal,
                           sliding_window=sliding_window, delta=delta)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, sliding_window, delta)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, delta = ctx.mask
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=causal, sliding_window=window,
                               delta=delta)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sliding_window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full-sequence attention in framework layout -> o [B, Sq, Hq, D]
    (the JAX package's flash_mha): forward and recompute backward through
    _FlashAttention, on the CUDA kernels or, for CPU tensors, their plain
    versions."""
    return _FlashAttention.apply(q, k, v, causal, sliding_window, 0)


# ---------------------------------------------------------------------------
# decode: the Sq-small specialization (replaces _decode_kernel, dense)
# ---------------------------------------------------------------------------


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lengths: torch.Tensor,
                           sliding_window: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain version of the flash_decode kernel, in fp32.

    q [B, Sq, Hq, D]; k/v the cache [B, S, Hkv, D]; kv_lengths [B] the
    valid prefix seen by each row's first query. Query j of row b sits at
    kv_lengths[b] - 1 + j and sees k_pos < kv_lengths[b] + j (and, with a
    window W, k_pos > its position - W). Returns [B, Sq, Hq, D] in q's
    dtype."""
    b, sq, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    _check_heads(hq, hkv)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    q_pos = (kv_lengths.to(q.device, torch.long)[:, None] - 1
             + torch.arange(sq, device=q.device)[None, :])        # [B, Sq]
    k_pos = torch.arange(s_len, device=q.device)
    mask = visible(q_pos[:, :, None], k_pos[None, None, :], causal=True,
                   window=sliding_window)[:, None, None]        # [B,1,1,Sq,S]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_lengths: torch.Tensor,
                 sliding_window: Optional[int] = None) -> torch.Tensor:
    """Decode attention with per-row valid-prefix masking over a dense
    slot cache -> [B, Sq, Hq, D]. Sq == 1 is plain decode; Sq > 1 the
    speculative verify (the JAX package's flash_decode_mq).

    CPU tensors: the plain version. CUDA tensors: the
    csrc/flash_decode.cu kernel (bf16, head dim 64 or 128, Sq * G <= 64,
    kv_lengths int32 on the same device), or ValueError."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, kv_lengths, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    bk, s_len, hkv, dk = k.shape
    _check_heads(hq, hkv)
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if sq * (hq // hkv) > DECODE_MAX_ROWS:
        raise ValueError(f"flash_decode: Sq * G = {sq * (hq // hkv)} query "
                         f"rows per kv head exceeds {DECODE_MAX_ROWS}")
    _check_cuda_inputs("flash_decode", (q, k, v), d)
    if (kv_lengths.device != q.device or kv_lengths.dtype != torch.int32
            or tuple(kv_lengths.shape) != (b,)
            or not kv_lengths.is_contiguous()):
        raise ValueError("flash_decode: kv_lengths must be a contiguous "
                         f"[{b}] int32 tensor on {q.device}")
    window = _window_arg(sliding_window)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    rc = _entry("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lengths.data_ptr(),
        o.data_ptr(), b, sq, s_len, hq, hkv, d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        1.0 / math.sqrt(d), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0

#: the speculative verify pass (Sq > 1) is the same kernel
flash_decode_mq = flash_decode
