"""The flash-attention kernels' wrappers and plain versions
(counterpart of megatron_tpu/ops/pallas/flash_template.py).

Five kernels, each a hand-written CUDA C++ kernel for Hopper in csrc/:

  wrapper             kernel (csrc/)    replaces (TPU kernel)
  flash_fwd           flash_fwd.cu      flash_template.py _fwd_kernel (_fwd)
  flash_bwd_dq        flash_bwd_dq.cu   flash_template.py _dq_kernel (_bwd)
  flash_bwd_dkv       flash_bwd_dkv.cu  flash_template.py _dkv_kernel (_bwd)
  flash_decode        flash_decode.cu   flash_template.py _decode_kernel
                                        (_decode_call, dense launch)
  paged_flash_decode  flash_decode.cu   flash_template.py _decode_kernel
                                        (_with_page_table, paged launch)

Beside the wrappers are their plain PyTorch versions (flash_fwd_reference,
flash_bwd_reference for both backward kernels, flash_decode_reference,
paged_flash_decode_reference): the same functions in fp32, which the CPU
tests use and which the card's smoke run holds the kernels against. A
wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; there is no fallback. Each
wrapper counts its kernel launches in a plain integer attribute
(flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches,
flash_decode.launches, paged_flash_decode.launches, which
paged_flash_decode_mq shares), incremented where the kernel is launched
and nowhere else; the two decode wrappers also count by query length
(launches_by_sq: Sq 1 is the plain tick, Sq k + 1 the speculative
verify). A CUDA graph replay launches kernels without calling the
wrappers, so whoever captures a graph reads launch_counts() around the
capture and adds that difference with add_launch_counts() at each
replay (inference/cuda_graph.py does).

_FlashAttention, the torch.autograd.Function behind flash_mha, takes the
place of the JAX package's jax.custom_vjp _flash_bhsd: its forward runs
flash_fwd and saves (q, k, v, o, lse), its backward runs flash_bwd (the
dq and dk/dv kernels). On CPU tensors the same Function runs the plain
forward and the plain backward.

Layouts are the framework's [B, S, H, D] throughout, and the paged
pools' [P, ps, Hkv, D]; the kernels read them through strides.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from megatron_tpu_torch.ops.flash import build
from megatron_tpu_torch.ops.flash.masks import (
    NEG_INF, decode_live_splits, decode_split_range, decode_split_tiles,
    decode_splits, live_tile_range, visible,
)

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
    "flash_bwd_dq": ("flash_bwd_dq", "mtt_flash_bwd_dq_bf16",
                     [_P] * 7 + [_I] * 6 + [_L] * 15 + [_F, _I, _I, _I, _P]),
    "flash_bwd_dkv": ("flash_bwd_dkv", "mtt_flash_bwd_dkv_bf16",
                      [_P] * 8 + [_I] * 6 + [_L] * 18
                      + [_F, _I, _I, _I, _P]),
    "flash_decode": ("flash_decode", "mtt_flash_decode_bf16",
                     [_P] * 8 + [_I] * 8 + [_L] * 12 + [_F, _I, _P]),
    "paged_flash_decode": ("flash_decode", "mtt_paged_flash_decode_bf16",
                           [_P] * 9 + [_I] * 10 + [_L] * 12 + [_F, _I, _P]),
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

    CUDA tensors: the csrc/flash_bwd_dq.cu kernel (bf16, head dim 64 or
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

    CUDA tensors: the csrc/flash_bwd_dkv.cu kernel (bf16, head dim 64
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


def decode_plan(s_len: int, b: int, hkv: int, rows: int,
                sm_count: int = 132) -> dict:
    """The split-K launch of the decode kernel for a cache of s_len
    positions (paged: max_pages * ps), b slots, hkv kv heads and
    rows = Sq * G query rows per kv head: kv tiles per split
    (masks.decode_split_tiles), splits, grid (Hkv, B, splits), the m16
    tiles the rows pad to (1, 2, 4 for rows <= 16, 32, 64) and the
    partials each (slot, kv head) may write (4 warps / m16 tiles a
    split). csrc/flash_decode.cu m_tiles holds the same row rule."""
    n_tiles = -(-s_len // DECODE_BLOCK)
    tiles = decode_split_tiles(n_tiles, b * hkv, sm_count)
    splits = decode_splits(n_tiles, tiles)
    m = 1 if rows <= 16 else 2 if rows <= 32 else 4
    return {"split_tiles": tiles, "splits": splits, "grid": (hkv, b, splits),
            "m_tiles": m, "partials": splits * (4 // m)}


_plans = {}
_tickets = {}


def _decode_launch(s_len: int, b: int, hkv: int, rows: int, d: int, device):
    """(plan, part_o, part_ml, tickets, stream) of one decode launch on
    `device`'s current stream. The plan is cached per shape and card. The
    partials are one fresh torch.empty buffer (every live split writes its
    own before the merge reads it). The tickets are one int32 per (slot,
    kv head), kept per (device, stream) and zeroed once: the kernel leaves
    them at zero, and launches on one stream run in order, so no two
    launches in flight share a ticket.

    Under CUDA graph capture the partials come from the graph's private
    pool, which keeps them for every replay, and the tickets are those of
    the capturing stream, which an eager launch on that stream (the
    warm-up that every capture needs) must have created: zeroing them
    inside the capture would allocate them in the graph's pool and zero
    them only when it replays, so this raises instead. A graph keeps the
    capturing stream's tickets, so it must not be replayed while another
    launch that uses them runs: one graph is never replayed on two
    streams at once, and nothing else launches on its capture stream."""
    key = (s_len, b, hkv, rows, device)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = decode_plan(s_len, b, hkv, rows, sms)
        _plans[key] = plan
    n = b * hkv * plan["partials"] * rows
    work = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    tickets = _tickets.get((device, stream))
    if tickets is None or tickets.numel() < b * hkv:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode kernel captured on a stream it never ran on: run "
                "the captured work once on the capture stream first (the "
                "warm-up creates and zeroes that stream's tickets)")
        tickets = torch.zeros(max(b * hkv, 1024), dtype=torch.int32,
                              device=device)
        _tickets[(device, stream)] = tickets
    return plan, work[:n * d], work[n * d:], tickets, stream


def flash_decode_split_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, kv_lengths: torch.Tensor,
                                 sliding_window: Optional[int] = None, *,
                                 split_tiles: int = 1) -> torch.Tensor:
    """The split-K decode kernel's schedule in plain fp32, for the tests:
    each slot's live kv tiles (64 positions, masks.live_tile_range) cut
    into runs of split_tiles (masks.decode_split_range), one unnormalised
    partial (m, l, o) per split, merged in split order as the kernel's
    last split does. A split or a row that sees nothing has m = NEG_INF
    and l = 0, and a row that sees nothing anywhere gives o = 0. Equals
    flash_decode_reference up to rounding. Shapes as there."""
    b, sq, hq, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    _check_heads(hq, hkv)
    g = hq // hkv
    qg = (q.float() / math.sqrt(d)).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    k_pos = torch.arange(s_len, device=q.device)
    n_tiles = -(-s_len // DECODE_BLOCK)
    out = torch.zeros(b, hkv, g, sq, d, dtype=torch.float32, device=q.device)
    for bi, n in enumerate(int(x) for x in kv_lengths):
        q_pos = n - 1 + torch.arange(sq, device=q.device)
        vis = visible(q_pos[:, None], k_pos[None, :], causal=True,
                      window=sliding_window)                     # [Sq, S]
        lo, hi = live_tile_range(DECODE_BLOCK, n_tiles, n - 1, n + sq - 2,
                                 causal=True, window=sliding_window)
        mx = torch.full((hkv, g, sq, 1), NEG_INF, device=q.device)
        den = torch.zeros_like(mx)
        num = torch.zeros(hkv, g, sq, d, device=q.device)
        for split in range(decode_live_splits(lo, hi, split_tiles)):
            t0, t1 = decode_split_range(split, split_tiles, lo, hi)
            mask = vis & (k_pos >= t0 * DECODE_BLOCK) & (
                k_pos < t1 * DECODE_BLOCK)
            sp = torch.where(mask, s[bi], NEG_INF)
            m = sp.amax(-1, keepdim=True)
            p = torch.where(mask, torch.exp(sp - m), 0.0)
            m_new = torch.maximum(mx, m)
            s1, s2 = torch.exp(mx - m_new), torch.exp(m - m_new)
            den = den * s1 + p.sum(-1, keepdim=True) * s2
            num = num * s1 + torch.einsum("hgqk,khd->hgqd", p,
                                          v[bi].float()) * s2
            mx = m_new
        out[bi] = num / den.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


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
    plan, part_o, part_ml, tickets, stream = _decode_launch(
        s_len, b, hkv, sq * (hq // hkv), d, q.device)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    rc = _entry("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lengths.data_ptr(),
        o.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        tickets.data_ptr(), b, sq, s_len, hq, hkv, d, plan["split_tiles"],
        plan["splits"],
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        1.0 / math.sqrt(d), window, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: cudaError {rc}")
    flash_decode.launches += 1
    _count_sq(flash_decode, sq)
    return o


flash_decode.launches = 0
flash_decode.launches_by_sq = {}

#: the speculative verify pass (Sq > 1) is the same kernel
flash_decode_mq = flash_decode


# ---------------------------------------------------------------------------
# paged decode: the same kernel reading K/V through a page table
# (replaces _decode_kernel in its paged launch, _with_page_table)
# ---------------------------------------------------------------------------


def check_page_size(page_size: int) -> None:
    """The paged kernel's page-size rule: a power of two (>= 1). The
    kernel splits a position into page and row with a shift and a mask,
    and resolves the physical page of every row it loads, so a page may
    be smaller or larger than its 64-position kv tile. (The TPU kernel's
    multiple-of-8 rule was a sublane rule and does not apply.) Raises
    ValueError otherwise."""
    ps = int(page_size)
    if ps < 1 or ps & (ps - 1):
        raise ValueError(
            f"page_size {page_size} is not a power of two: the paged "
            "flash-decode kernel takes page sizes 1, 2, 4, ..., e.g. 8, 16 "
            "or 64")


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """[P, ps, Hkv, D] pool -> [B, max_pages * ps, Hkv, D] dense view of
    each row's logical context (an exact copy of the pages' values)."""
    b = page_table.shape[0]
    idx = page_table.to(pages.device, torch.long)
    return pages[idx].reshape(b, -1, *pages.shape[2:])


def paged_flash_decode_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_lengths: torch.Tensor,
                                 sliding_window: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version of the paged_flash_decode kernel, in fp32: gather
    each row's pages into its dense logical view, then
    flash_decode_reference.

    q [B, Sq, Hq, D]; k_pages/v_pages the shared pools [P, ps, Hkv, D];
    page_table [B, max_pages] (row b's logical position pos lives at
    pool[page_table[b, pos // ps], pos % ps]); kv_lengths [B] as in
    flash_decode_reference. Returns [B, Sq, Hq, D] in q's dtype."""
    return flash_decode_reference(q, _gather_pages(k_pages, page_table),
                                  _gather_pages(v_pages, page_table),
                                  kv_lengths, sliding_window)


def _paged_decode(name: str, q, k_pages, v_pages, page_table, kv_lengths,
                  sliding_window):
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, k_pages, v_pages, page_table,
                                            kv_lengths, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, sq, hq, d = q.shape
    n_pages, ps, hkv, dk = k_pages.shape
    _check_heads(hq, hkv)
    check_page_size(ps)
    if dk != d or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k_pages "
                         f"{tuple(k_pages.shape)} v_pages "
                         f"{tuple(v_pages.shape)}")
    if sq * (hq // hkv) > DECODE_MAX_ROWS:
        raise ValueError(f"{name}: Sq * G = {sq * (hq // hkv)} query "
                         f"rows per kv head exceeds {DECODE_MAX_ROWS}")
    _check_cuda_inputs(name, (q, k_pages, v_pages), d)
    for t, what, dims in ((page_table, "page_table", 2),
                          (kv_lengths, "kv_lengths", 1)):
        if (t.device != q.device or t.dtype != torch.int32
                or not t.is_contiguous() or t.dim() != dims
                or t.shape[0] != b or t.numel() == 0):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"{dims}-d int32 tensor on {q.device} with {b} "
                             "rows")
    max_pages = page_table.shape[1]
    plan, part_o, part_ml, tickets, stream = _decode_launch(
        max_pages * ps, b, hkv, sq * (hq // hkv), d, q.device)
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    rc = _entry("paged_flash_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_lengths.data_ptr(), o.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), b, sq,
        n_pages, max_pages, ps.bit_length() - 1, hq, hkv, d,
        plan["split_tiles"], plan["splits"],
        *_strides(q), *_strides(k_pages), *_strides(v_pages), *_strides(o),
        1.0 / math.sqrt(d), _window_arg(sliding_window), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    paged_flash_decode.launches += 1
    _count_sq(paged_flash_decode, sq)
    return o


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_table: torch.Tensor,
                       kv_lengths: torch.Tensor,
                       sliding_window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention over paged KV with per-row prefix
    masking -> [B, 1, Hq, D] (the JAX package's paged_flash_decode).

    q [B, 1, Hq, D]; k_pages/v_pages one layer's pools [P, ps, Hkv, D]
    (any strides with a contiguous head dim); page_table [B, max_pages]
    int32; kv_lengths [B] int32. CPU tensors: the plain version. CUDA
    tensors: the csrc/flash_decode.cu kernel in its paged form (bf16,
    head dim 64 or 128, ps a power of two, see check_page_size), or
    ValueError. Table entries belong in [0, P): the kernel reads them on
    the device, where no host check reaches, and reads an entry outside
    that range as the scratch page 0."""
    if q.shape[1] != 1:
        raise ValueError(
            f"paged_flash_decode is single-token only (q_len={q.shape[1]})")
    return _paged_decode("paged_flash_decode", q, k_pages, v_pages,
                         page_table, kv_lengths, sliding_window)


paged_flash_decode.launches = 0
paged_flash_decode.launches_by_sq = {}


def paged_flash_decode_mq(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          kv_lengths: torch.Tensor,
                          sliding_window: Optional[int] = None
                          ) -> torch.Tensor:
    """Multi-query paged decode (the speculative verify pass, Sq > 1:
    query j sees k_pos < kv_lengths + j) -> [B, Sq, Hq, D]. The same
    kernel as paged_flash_decode, counted in paged_flash_decode.launches;
    Sq * G <= 64."""
    return _paged_decode("paged_flash_decode_mq", q, k_pages, v_pages,
                         page_table, kv_lengths, sliding_window)


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def _count_sq(wrapper, sq: int, n: int = 1) -> None:
    wrapper.launches_by_sq[sq] = wrapper.launches_by_sq.get(sq, 0) + n


def _counted():
    return (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_decode,
            paged_flash_decode)


def launch_counts() -> dict:
    """Every wrapper's launch count, by name, and the decode wrappers'
    counts by query length under "name/sq<Sq>"."""
    out = {}
    for w in _counted():
        out[w.__name__] = w.launches
        for sq, n in getattr(w, "launches_by_sq", {}).items():
            out[f"{w.__name__}/sq{sq}"] = n
    return out


def add_launch_counts(delta: dict) -> None:
    """Add a launch_counts() difference to the counters: what one replay
    of a captured CUDA graph launched."""
    by_name = {w.__name__: w for w in _counted()}
    for key, n in delta.items():
        name, _, sq = key.partition("/sq")
        w = by_name[name]
        if sq:
            _count_sq(w, int(sq), n)
        else:
            w.launches += n


def set_launch_counts(counts: dict) -> None:
    """Set the counters to a launch_counts() snapshot (a capture launches
    nothing, so it puts back what it counted)."""
    for w in _counted():
        w.launches = counts.get(w.__name__, 0)
        if hasattr(w, "launches_by_sq"):
            w.launches_by_sq.clear()
    add_launch_counts({k: n for k, n in counts.items() if "/sq" in k})
