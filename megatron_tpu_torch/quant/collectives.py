"""Compressed tensor- and context-parallel collectives (counterpart of
megatron_tpu/quant/collectives.py).

Serving latency at tensor parallelism is dominated by the per-layer
output reductions (the row-parallel all-reduce after attention-out and
mlp-out) and the vocab-parallel logits gather. This module gives them
low-bit forms (Flash Communication, arXiv 2412.04964):

  * ``compressed_psum``: quantize the partial sums per chunk, all-to-all
    the low-bit payload with its scales, dequantize and reduce this
    rank's slice in fp32, re-quantize, all-gather, dequantize. Both
    wire phases move int8/fp8 bytes; the reduction itself stays fp32;
  * ``compressed_all_gather``: quantize locally, gather payload and
    scales, dequantize;
  * ``ring_permute``: one hop of the context-parallel ring
    (inference/context_parallel/ring_kv.py), optionally low-bit;
  * ``grouped_all_to_all`` / ``grouped_all_gather``: the 2d CP
    geometry's head legs inside a subgroup.

The JAX package runs them inside shard_map bodies over mesh axes; here
they take torch.distributed process groups (the MeshRuntime's tensor or
context group, or the 2d subgroups that make_cp_comm builds once with
new_group on every rank), and move their tensors through
parallel/mappings.py's collectives, so they run inside its comm.*
ranges and stage CUDA tensors through host memory on gloo. An fp8
payload travels as its bytes (uint8): neither gloo nor every NCCL build
takes float8 tensors. Each wrapper is the dense collective on a group
of one rank or in mode "dense".

The model-facing seams are ``tp_reduce`` (the row-parallel reduction at
the "attn_out" and "mlp_out" sites, models/transformer.py) and
``gather_logits`` (the "logits" site, models/language_model.py), picked
per site by a :class:`TpComm`; a site the policy leaves off keeps the
dense collective.

Numerics: two quantization stages per psum, each bounded by
quant/primitives.quantization_error_bound, so a site's output error is
at most the sum of both stages' chunk bounds.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from megatron_tpu_torch.parallel.mappings import (
    all_gather, all_reduce, all_to_all, exit_tp, group_size, p2p_start,
)
from megatron_tpu_torch.quant.policy import TP_SITES, resolve_policy
from megatron_tpu_torch.quant.primitives import (
    dequantize_chunked, effective_chunk, fp8_supported, from_wire,
    quantize_chunked, wire_view,
)

#: the modes --serve_compress_collectives exposes plus the explicit
#: "dense" baseline (the same decomposition at full precision)
MODES = ("none", "dense", "int8", "fp8")

#: the CP attention geometries --serve_cp_geometry exposes: "ring" is the
#: flat ring (cp - 1 hops); "2d" factors the context axis into cp_seq x
#: cp_head: a head all-to-all inside each `subgroup`-sized group, ring
#: hops only across subgroups
CP_GEOMETRIES = ("ring", "2d")


def wire_bytes_per_call(primitive: str, payload_bytes: int,
                        axis_size: int) -> int:
    """Estimated per-rank bytes one collective call moves, from its
    (result) payload size and the participating group size n (the JAX
    package's analysis/taxonomy.wire_bytes_per_call, kept here because
    the port imports nothing of that package): all-reduce 2 * payload *
    (n - 1) / n; all-gather and all-to-all payload * (n - 1) / n;
    reduce-scatter (n - 1) result-sized contributions; a ring hop or a
    broadcast the payload once. n <= 1 moves nothing; n == 0 (unknown)
    counts the payload."""
    if axis_size == 0:
        return payload_bytes
    n = int(axis_size)
    if n <= 1:
        return 0
    if primitive in ("psum", "pmax", "pmin"):
        return 2 * payload_bytes * (n - 1) // n
    if primitive in ("all_gather", "pgather", "all_to_all",
                     "ragged_all_to_all"):
        return payload_bytes * (n - 1) // n
    if primitive in ("reduce_scatter", "psum_scatter"):
        return payload_bytes * (n - 1)
    return payload_bytes


@dataclasses.dataclass(frozen=True)
class TpComm:
    """One engine's tensor-parallel communication plan: the tensor
    group, the transport precision, and which sites take it. Fixed at
    engine build."""

    group: object                # the tensor ProcessGroup
    tp: int
    mode: str                    # "dense" | "int8" | "fp8"
    chunk: int = 32
    sites: FrozenSet[str] = frozenset(TP_SITES)

    def compresses(self) -> bool:
        return self.mode in ("int8", "fp8")


def _check_mode(mode: str, what: str) -> None:
    if mode not in MODES:
        raise ValueError(f"{what} must be one of {MODES}, got {mode!r}")


def make_tp_comm(mesh, mode: str, cfg=None, policy=None,
                 chunk: int = 32) -> Optional[TpComm]:
    """The engine's TpComm, or None when the configuration is a no-op
    (mode "none", no mesh, or a tensor axis of one rank: the dense path
    then serves unchanged). mesh: a MeshRuntime. policy: None (every
    site), a CommPolicy, a {site: bool} dict or a policy-JSON path
    (quant/policy.py); only the tensor sites belong to this plan."""
    _check_mode(mode, "compress_collectives")
    if mode == "none" or mesh is None:
        return None
    if mesh.tp <= 1:
        warnings.warn(
            f"compress_collectives={mode!r} requested but the mesh has a "
            "trivial tensor axis — serving the dense path unchanged",
            stacklevel=2)
        return None
    if mode == "fp8" and not fp8_supported():
        raise ValueError("compress_collectives='fp8': this toolchain has "
                         "no fp8 dtype; use 'int8'")
    if chunk < 1:
        raise ValueError(f"comm chunk must be >= 1, got {chunk}")
    pol = resolve_policy(policy)
    sites = frozenset(s for s in pol.enabled_sites() if s in TP_SITES)
    if cfg is not None:
        _validate_cfg(cfg, mesh.tp, sites)
    return TpComm(group=mesh.group("tensor"), tp=mesh.tp, mode=mode,
                  chunk=int(chunk), sites=sites)


@dataclasses.dataclass(frozen=True)
class CpComm:
    """One engine's context-parallel communication plan: the context
    group the KV pages are striped over, the transport precision of the
    ring hop (site "cp_ring") and of the 2d geometry's head legs (site
    "cp_a2a"), the geometry, and the ring schedule (overlapped or
    serial). Fixed at engine build."""

    group: object                # the context ProcessGroup
    cp: int
    rank: int                    # this rank's index on the context axis
    mode: str                    # "dense" | "int8" | "fp8"
    chunk: int = 32
    compress_ring: bool = True   # the policy's "cp_ring" decision
    geometry: str = "ring"       # "ring" | "2d"
    subgroup: int = 1            # cp_head under "2d" (1 under "ring")
    overlap: bool = True         # hop l + 1 posted before hop l's merge
    compress_a2a: bool = True    # the policy's "cp_a2a" decision
    sub_group: object = None     # this rank's cp_head subgroup ("2d")
    tp: int = 1                  # the ring carries Hq / tp heads a rank

    def compresses(self) -> bool:
        return self.compress_ring and self.mode in ("int8", "fp8")

    def wire_mode(self) -> str:
        """The mode ring_permute runs with: the low-bit mode only where
        the policy enabled the cp_ring site."""
        return self.mode if self.compresses() else "dense"

    def a2a_compresses(self) -> bool:
        return self.compress_a2a and self.mode in ("int8", "fp8")

    def a2a_wire_mode(self) -> str:
        return self.mode if self.a2a_compresses() else "dense"

    def seq_groups(self) -> int:
        """cp_seq: the sequence-stripe subgroups the ring visits (cp
        under the flat ring)."""
        return self.cp // self.subgroup

    def ring_hops(self) -> int:
        """Ring hops a layer a forward: cp - 1 flat, cp_seq - 1 under 2d
        (the intra-subgroup merge rides the head legs)."""
        return self.seq_groups() - 1


def _subgroups(mesh, g: int):
    """new_group for every cp_head subgroup of every context fiber, on
    every rank in one order (new_group is collective); returns this
    rank's. None without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from megatron_tpu_torch.parallel.mesh import (
        AXIS_CONTEXT, MESH_AXES, rank_grid,
    )

    grid = rank_grid(mesh.parallel, mesh.world_size)
    fibers = np.moveaxis(grid, MESH_AXES.index(AXIS_CONTEXT), -1).reshape(
        -1, mesh.cp)
    mine = None
    for fiber in fibers:
        for i in range(mesh.cp // g):
            ranks = [int(r) for r in fiber[i * g:(i + 1) * g]]
            pg = dist.new_group(ranks)
            if mesh.rank in ranks:
                mine = pg
    return mine


def make_cp_comm(mesh, mode: str, cfg=None, policy=None, chunk: int = 32,
                 geometry: str = "ring", subgroup: int = 0,
                 overlap: bool = True) -> Optional[CpComm]:
    """The engine's CpComm, or None when context parallelism is a no-op
    (mode "none", no mesh, or a context axis of one rank). policy: as
    make_tp_comm's; only "cp_ring" and "cp_a2a" are read. geometry "2d"
    needs `subgroup` (cp_head) >= 2 dividing both cp and a rank's query
    heads: each member owns heads / subgroup of them through the
    merge."""
    _check_mode(mode, "cp_collectives")
    if geometry not in CP_GEOMETRIES:
        raise ValueError(f"cp geometry must be one of {CP_GEOMETRIES}, "
                         f"got {geometry!r}")
    if mode == "none" or mesh is None or mesh.cp <= 1:
        return None
    cp = mesh.cp
    if mode == "fp8" and not fp8_supported():
        raise ValueError("cp_collectives='fp8': this toolchain has no fp8 "
                         "dtype; use 'int8'")
    if chunk < 1:
        raise ValueError(f"comm chunk must be >= 1, got {chunk}")
    if geometry == "2d":
        if subgroup < 2:
            raise ValueError(
                "cp geometry '2d' needs a subgroup (cp_head) >= 2 — "
                f"got {subgroup}; pick the node-local device count "
                "(--serve_cp_subgroup)")
        if cp % subgroup:
            raise ValueError(
                f"cp geometry '2d': subgroup {subgroup} does not divide "
                f"the context axis {cp} (cp = cp_seq x cp_head needs an "
                "exact factorization)")
        heads = None if cfg is None else cfg.num_attention_heads // mesh.tp
        if heads is not None and heads % subgroup:
            raise ValueError(
                f"cp geometry '2d': query head count {heads} (a rank's) is "
                f"not divisible by the subgroup {subgroup} — the head "
                "all-to-all gives each member heads/subgroup heads")
    else:
        if subgroup not in (0, 1):
            raise ValueError(
                f"cp geometry 'ring' takes no subgroup (got {subgroup}); "
                "select --serve_cp_geometry 2d to factor the axis")
        subgroup = 1
    pol = resolve_policy(policy)
    return CpComm(group=mesh.group("context"), cp=cp, rank=mesh.cp_rank,
                  mode=mode, chunk=int(chunk),
                  compress_ring=pol.enabled("cp_ring"), geometry=geometry,
                  subgroup=int(subgroup), overlap=bool(overlap),
                  compress_a2a=pol.enabled("cp_a2a"),
                  sub_group=(_subgroups(mesh, subgroup)
                             if geometry == "2d" else None),
                  tp=mesh.tp)


def _validate_cfg(cfg, tp: int, sites) -> None:
    """Fail at engine build: every dimension an enabled site splits over
    the tensor group must divide by tp, the contracting dim and, for the
    reductions, the output width (the two-step reduce splits the
    payload's last dim across peers)."""
    dims = {
        "attn_out": (("attention width (heads x head_dim)",
                      cfg.num_attention_heads * cfg.head_dim),
                     ("hidden size", cfg.hidden_size)),
        "mlp_out": (("ffn width", cfg.ffn_size),
                    ("hidden size", cfg.hidden_size)),
        "logits": (("vocab size", cfg.vocab_size),),
    }
    for site in sorted(sites):
        for label, dim in dims[site]:
            if dim % tp:
                raise ValueError(
                    f"compressed collectives: {label} {dim} is not "
                    f"divisible by tensor_parallel {tp} (site {site!r}; "
                    "disable it in the comm policy or change the "
                    "geometry)")
    if cfg.num_experts is not None:
        raise ValueError(
            "compressed collectives do not cover MoE expert dispatch — "
            "serve MoE models with --serve_compress_collectives none")
    if cfg.fp8_format is not None:
        raise ValueError(
            "compressed collectives with fp8 training matmuls "
            "(cfg.fp8_format) is untested — drop one of the two")


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _split_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """[..., W] -> [n, ..., W/n]: piece j is columns [j W/n, (j+1) W/n)."""
    return t.reshape(*t.shape[:-1], n, t.shape[-1] // n).movedim(-2, 0) \
        .contiguous()


def _join_last(t: torch.Tensor) -> torch.Tensor:
    """Inverse of _split_last: the pieces side by side on the last dim."""
    n = t.shape[0]
    return t.movedim(0, -2).reshape(*t.shape[1:-1], n * t.shape[-1])


def _a2a_rows(t: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] -> [n, ...]: row j to group rank j; row i of the result
    from group rank i."""
    n = t.shape[0]
    return all_to_all(t, group, [1] * n, [1] * n)


def compressed_psum(x: torch.Tensor, group, mode: str = "int8",
                    chunk: int = 32) -> torch.Tensor:
    """Flash-AllReduce over `group`: quantize, all-to-all, exact fp32
    reduce of this rank's slice, re-quantize, all-gather, the scales
    riding alongside each phase. The dense all-reduce on a group of one
    rank or in mode "dense"."""
    tp = group_size(group)
    if tp == 1 or mode in ("none", "dense"):
        return all_reduce(x, group)
    w = x.shape[-1]
    if w % tp:
        raise ValueError(f"compressed_psum: last-dim width {w} not "
                         f"divisible by the group's {tp} ranks")
    # the chunk tiles a rank's slice, so the scale rows split evenly
    c = effective_chunk(w // tp, chunk)
    q, s = quantize_chunked(x, c, mode)
    q = from_wire(_join_last(_a2a_rows(_split_last(wire_view(q), tp),
                                       group)), mode)
    s = _join_last(_a2a_rows(_split_last(s, tp), group))
    # this rank now holds every peer's slice r: dequantize exactly, then
    # reduce in fp32 (only the wire is low-bit)
    part = dequantize_chunked(q, s, torch.float32)
    red = part.reshape(*part.shape[:-1], tp, w // tp).sum(-2)
    q2, s2 = quantize_chunked(red, c, mode)
    q2 = from_wire(all_gather(wire_view(q2), group, -1), mode)
    s2 = all_gather(s2, group, -1)
    return dequantize_chunked(q2, s2, x.dtype)


def compressed_all_gather(x: torch.Tensor, group, mode: str = "int8",
                          chunk: int = 32,
                          gather_axis: Optional[int] = None) -> torch.Tensor:
    """Low-bit all-gather over `group`: quantize this rank's tensor,
    gather payload and scales, dequantize. The dense all-gather on a
    group of one rank or in mode "dense". gather_axis defaults to the
    last (the quantized) axis, the only one a compressed gather takes."""
    last = x.dim() - 1
    ax = last if gather_axis is None else gather_axis % x.dim()
    if group_size(group) == 1 or mode in ("none", "dense"):
        return all_gather(x, group, ax)
    if ax != last:
        raise ValueError("compressed_all_gather quantizes along the last "
                         f"axis; gather_axis {ax} != {last}")
    c = effective_chunk(x.shape[-1], chunk)
    q, s = quantize_chunked(x, c, mode)
    q = from_wire(all_gather(wire_view(q), group, last), mode)
    s = all_gather(s, group, last)
    return dequantize_chunked(q, s, x.dtype)


def _peers(group, perm: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """(global rank this rank sends to, global rank it receives from)
    under `perm`'s (source, destination) group-rank pairs."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) != 1 or len(src) != 1:
        raise ValueError(f"ring permutation {list(perm)} does not send "
                         f"and receive exactly once on group rank {me}")
    return (dist.get_global_rank(group, dst[0]),
            dist.get_global_rank(group, src[0]))


def ring_start(tensors: Sequence[torch.Tensor], group,
               perm: Sequence[Tuple[int, int]], mode: str = "dense",
               chunk: int = 32, dense=()):
    """Post one ring hop of `tensors` over `group` (perm: (source,
    destination) group-rank pairs, every rank sending and receiving
    once); returns the wait, which returns what arrived, in order. In
    mode int8/fp8 each tensor moves low-bit with its fp32 scales
    (quantized along its last axis), except those whose index is in
    `dense` (the ring's lse rows, which feed the merge's exp/log)."""
    to, frm = _peers(group, perm)
    sends, recvs, plan = [], [], []
    for i, t in enumerate(tensors):
        if mode in ("none", "dense") or i in dense:
            parts = [t.contiguous()]
            plan.append(None)
        else:
            c = effective_chunk(t.shape[-1], chunk)
            q, s = quantize_chunked(t, c, mode)
            parts = [wire_view(q).contiguous(), s]
            plan.append(t.dtype)
        for p in parts:
            tag = len(sends)
            sends.append((p, to, tag))
            recvs.append((tuple(p.shape), p.dtype, p.device, frm, tag))
    wait = p2p_start(sends, recvs)

    def finish():
        got, j = [], 0
        arrived = wait()
        for dtype in plan:
            if dtype is None:
                got.append(arrived[j])
                j += 1
            else:
                got.append(dequantize_chunked(from_wire(arrived[j], mode),
                                              arrived[j + 1], dtype))
                j += 2
        return got

    return finish


def ring_permute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]],
                 mode: str = "dense", chunk: int = 32) -> torch.Tensor:
    """One ring hop of x over `group` (the JAX package's ppermute along
    an axis with perm's (source, destination) pairs), its payload
    optionally quantized for the wire and dequantized on arrival."""
    return ring_start([x], group, perm, mode, chunk)()[0]


def grouped_all_to_all(x: torch.Tensor, group, split_axis: int,
                       concat_axis: int, mode: str = "dense",
                       chunk: int = 32) -> torch.Tensor:
    """A tiled all-to-all inside `group` (a subgroup of the context
    axis): x split along split_axis into one piece a member, piece j to
    member j, the pieces received concatenated along concat_axis in
    member order (the 2d CP geometry's head scatter, site "cp_a2a").
    Optionally low-bit on the wire, quantized along the last axis."""
    n = group_size(group)
    split_axis %= x.dim()

    def exchange(t):
        rows = _a2a_rows(torch.stack(t.chunk(n, dim=split_axis)), group)
        return torch.cat(list(rows), dim=concat_axis)

    if mode in ("none", "dense"):
        return exchange(x)
    if split_axis == x.dim() - 1:
        raise ValueError("grouped_all_to_all quantizes along the last "
                         "axis: split another one")
    c = effective_chunk(x.shape[-1], chunk)
    q, s = quantize_chunked(x, c, mode)
    return dequantize_chunked(from_wire(exchange(wire_view(q)), mode),
                              exchange(s), x.dtype)


def grouped_all_gather(x: torch.Tensor, group, gather_axis: int,
                       mode: str = "dense", chunk: int = 32) -> torch.Tensor:
    """A tiled all-gather inside `group` along gather_axis (the 2d
    geometry's head gather, site "cp_a2a"); low-bit on the wire like
    grouped_all_to_all (quantized along the last axis, so another
    gather_axis still compresses)."""
    if mode in ("none", "dense"):
        return all_gather(x, group, gather_axis)
    if gather_axis % x.dim() == x.dim() - 1:
        raise ValueError("grouped_all_gather quantizes along the last "
                         "axis: gather along another one")
    c = effective_chunk(x.shape[-1], chunk)
    q, s = quantize_chunked(x, c, mode)
    q = from_wire(all_gather(wire_view(q), group, gather_axis), mode)
    return dequantize_chunked(q, all_gather(s, group, gather_axis), x.dtype)


# ---------------------------------------------------------------------------
# model-facing seams
# ---------------------------------------------------------------------------


def tp_reduce(partial: torch.Tensor, mesh, tpc: Optional[TpComm],
              site: str) -> torch.Tensor:
    """A row-parallel block's partial sums reduced over the tensor group:
    through compressed_psum at a site the plan covers (the JAX package's
    row_parallel_matmul), else parallel/mappings.exit_tp."""
    if tpc is None or site not in tpc.sites:
        return exit_tp(partial, mesh)
    return compressed_psum(partial, tpc.group, mode=tpc.mode,
                           chunk=tpc.chunk)


def gather_logits(local: torch.Tensor, mesh,
                  tpc: Optional[TpComm]) -> torch.Tensor:
    """This rank's vocab columns [..., V/tp] gathered to [..., V] over the
    tensor group: through compressed_all_gather where the plan covers
    the "logits" site (the JAX package's vocab_parallel_logits), else
    the dense all-gather."""
    group = mesh.group("tensor")
    if tpc is None or "logits" not in tpc.sites:
        return all_gather(local, group, -1)
    return compressed_all_gather(local, group, mode=tpc.mode,
                                 chunk=tpc.chunk)


# ---------------------------------------------------------------------------
# static byte accounting (the engines' counters and comm_policy record)
# ---------------------------------------------------------------------------


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _site_bytes(width: int, rows: int, tpc: TpComm, act_itemsize: int,
                kind: str) -> Dict[str, int]:
    """Wire bytes one site moves for `rows` tokens of a `width`-wide
    payload: {"dense": the dense collective's, "compressed": this
    mode's}, on wire_bytes_per_call's model."""
    n = tpc.tp
    payload = rows * width * act_itemsize
    dense = wire_bytes_per_call("psum" if kind == "all-reduce"
                                else "all_gather", payload, n)
    if not tpc.compresses():
        return {"dense": dense, "compressed": dense}
    c = effective_chunk(width // n if kind == "all-reduce" else width,
                        tpc.chunk)
    q = rows * width                      # int8/fp8: 1 byte an element
    s = rows * (width // c) * 4           # fp32 scales
    if kind == "all-reduce":
        comp = (wire_bytes_per_call("all_to_all", q + s, n)
                + wire_bytes_per_call("all_gather", q + s, n))
    else:
        comp = wire_bytes_per_call("all_gather", q + s, n)
    return {"dense": dense, "compressed": comp}


def forward_comm_bytes(cfg, tpc: Optional[TpComm], batch: int,
                       seq: int) -> Dict[str, int]:
    """Per-forward wire bytes of the plan's TP collectives for a
    [batch, seq] pass: {"dense", "compressed"}; zero without a plan. A
    parallel-attention block (Falcon) reduces its two branches in one
    collective, counted once at the "attn_out" site (the JAX package
    reduces them apart)."""
    out = {"dense": 0, "compressed": 0}
    if tpc is None:
        return out
    rows = batch * seq
    act = _itemsize(cfg.dtype)
    per_layer = []
    if "attn_out" in tpc.sites:
        per_layer.append(_site_bytes(cfg.hidden_size, rows, tpc, act,
                                     "all-reduce"))
    if "mlp_out" in tpc.sites and not fused_reduce(cfg):
        per_layer.append(_site_bytes(cfg.hidden_size, rows, tpc, act,
                                     "all-reduce"))
    for b in per_layer:
        out["dense"] += b["dense"] * cfg.num_layers
        out["compressed"] += b["compressed"] * cfg.num_layers
    if "logits" in tpc.sites:
        b = _site_bytes(cfg.vocab_size, rows, tpc, act, "all-gather")
        out["dense"] += b["dense"]
        out["compressed"] += b["compressed"]
    return out


def fused_reduce(cfg) -> bool:
    """Whether a layer reduces attention and MLP in one collective (the
    parallel block with a dense FFN, models/transformer.block_forward):
    that reduce takes the "attn_out" site's decision."""
    return bool(cfg.parallel_attn) and cfg.num_experts is None


def cp_ring_comm_bytes(cfg, cpc: Optional[CpComm], batch: int,
                       seq: int) -> Dict[str, int]:
    """Per-forward wire bytes of the CP attention merge for a [batch,
    seq] pass, a rank's: {"dense", "compressed"} the ring hops (cp - 1
    a layer flat; cp_seq - 1 at 1/subgroup the head payload under 2d),
    {"a2a_dense", "a2a_compressed"} the 2d geometry's head legs (zero
    under the flat ring). A hop moves the normalized partial output
    (fp32 [batch, seq, heads, head_dim]) and its log-sum-exp row (fp32,
    never compressed). heads are a rank's: Hq / tp. Zero without a
    plan."""
    out = {"dense": 0, "compressed": 0, "a2a_dense": 0,
           "a2a_compressed": 0}
    if cpc is None:
        return out
    g = cpc.subgroup
    heads = cfg.num_attention_heads // cpc.tp
    rows = batch * seq * heads
    ring_rows = batch * seq * (heads // g)
    o_payload = ring_rows * cfg.head_dim * 4
    lse_payload = ring_rows * 4
    hops = cpc.ring_hops() * cfg.num_layers
    dense_hop = (wire_bytes_per_call("ppermute", o_payload, cpc.cp)
                 + wire_bytes_per_call("ppermute", lse_payload, cpc.cp))
    out["dense"] = dense_hop * hops
    if not cpc.compresses():
        out["compressed"] = out["dense"]
    else:
        c = effective_chunk(cfg.head_dim, cpc.chunk)
        q = ring_rows * cfg.head_dim
        s = ring_rows * (cfg.head_dim // c) * 4
        comp_hop = (wire_bytes_per_call("ppermute", q + s, cpc.cp)
                    + wire_bytes_per_call("ppermute", lse_payload, cpc.cp))
        out["compressed"] = comp_hop * hops
    if cpc.geometry != "2d":
        return out
    # the head legs, a layer: the scatter moves the full-head partial
    # (o + lse) inside the subgroup; after the ring the gather
    # reassembles the heads from the members' slices. lse rides dense.
    o_full = rows * cfg.head_dim * 4
    lse_full = rows * 4
    legs = (wire_bytes_per_call("all_to_all", o_full + lse_full, g)
            + wire_bytes_per_call("all_gather", o_full, g))
    out["a2a_dense"] = legs * cfg.num_layers
    if not cpc.a2a_compresses():
        out["a2a_compressed"] = out["a2a_dense"]
        return out
    c = effective_chunk(cfg.head_dim, cpc.chunk)
    q = rows * cfg.head_dim
    s = rows * (cfg.head_dim // c) * 4
    comp_legs = (wire_bytes_per_call("all_to_all", q + s + lse_full, g)
                 + wire_bytes_per_call("all_gather", q + s, g))
    out["a2a_compressed"] = comp_legs * cfg.num_layers
    return out
