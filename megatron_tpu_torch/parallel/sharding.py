"""Sharding rules as slicing rules (counterpart of
megatron_tpu/parallel/sharding.py).

The JAX package hands XLA a PartitionSpec per parameter and lets the SPMD
partitioner place the data and insert the collectives. The port has no
partitioner: the same specs (models/params.py:_defs, the JAX package's
own) become the rule that cuts a full tensor into the slice one rank
holds (shard_leaf) and puts the slices back together (unshard), and the
collectives are written out in parallel/mappings.py.

Conventions (the JAX module's):
  * "column parallel" (output-dim split)  -> last axis "tensor"
  * "row parallel" (input-dim split)      -> contracting axis "tensor"
  * vocab-parallel embedding / lm head    -> vocab axis "tensor"
  * stacked layer params have a leading layer axis sharded over "pipe"

A dimension sharded over an axis of size n is cut into n contiguous
blocks, block i to the rank at index i on that axis. One exception keeps
the math local: a GLU input projection [..., 2F] holds the gate and the
up projection side by side, and a contiguous cut would hand one rank
only gates. Its "tensor" dimension is cut per half (rank i takes block i
of each half), which is the layout the reference's
ColumnParallelLinear gives a GLU (JAX's contiguous cut is resharded by
XLA at the split instead).

The checkpoint layout (training/checkpointing.py) reads the same rule as
boxes of the global tensor: block_pieces gives the offsets and sizes of
what a rank holds (one box for a plain cut, one per half of a GLU
dimension, one per virtual chunk of an interleaved layer axis), and
copy_overlap copies the intersection of a saved box into a target box,
so a load at another topology is "for each saved block that overlaps my
box, copy the overlap".
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from megatron_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_EXPERT, BATCH_AXES, MESH_AXES,
)


class P(tuple):
    """A PartitionSpec-like tuple: one entry per leading dimension, each
    None (unsharded), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Sequence) -> set:
    """Every axis name a spec shards over."""
    return {a for e in spec for a in _axes(e)}


def _block(sizes: Dict[str, int], coords: Dict[str, int], entry
           ) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dimension sharded over
    `entry`'s axes (several axes: the first is the slowest)."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + coords[a]
        n *= sizes[a]
    return idx, n


def shard_leaf(x: torch.Tensor, spec: Sequence, coords: Dict[str, int],
               sizes: Dict[str, int], glu_dim: Optional[int] = None
               ) -> torch.Tensor:
    """This rank's slice of the full tensor `x` under `spec` (a
    contiguous copy). sizes: axis -> degree; coords: axis -> this rank's
    index. glu_dim: a dimension cut per half (the module docstring)."""
    out = x
    for d, entry in enumerate(spec):
        idx, n = _block(sizes, coords, entry)
        if n == 1:
            continue
        if out.shape[d] % (2 * n if d == glu_dim else n):
            raise ValueError(
                f"dimension {d} of {tuple(x.shape)} not divisible by the "
                f"{n} ranks of {entry!r}")
        if d == glu_dim:
            halves = out.chunk(2, dim=d)
            out = torch.cat([h.chunk(n, dim=d)[idx] for h in halves], dim=d)
        else:
            out = out.chunk(n, dim=d)[idx]
    # a copy of its own, never a view that keeps all of x alive
    return out.clone() if out.numel() < x.numel() else out.contiguous()


def unshard(slice_at: Callable[[Dict[str, int]], torch.Tensor],
            spec: Sequence, sizes: Dict[str, int],
            glu_dim: Optional[int] = None) -> torch.Tensor:
    """The full tensor from its slices: slice_at(coords) returns the
    slice held at those axis coordinates (the inverse of shard_leaf)."""
    sharded = [(d, e) for d, e in enumerate(spec)
               if _block(sizes, dict.fromkeys(MESH_AXES, 0), e)[1] > 1]

    def build(coords, k):
        if k == len(sharded):
            return slice_at(coords)
        d, entry = sharded[k]
        axes = _axes(entry)
        parts = []
        n = 1
        for a in axes:
            n *= sizes[a]
        for idx in range(n):
            c, rem = dict(coords), idx
            for a in reversed(axes):
                c[a] = rem % sizes[a]
                rem //= sizes[a]
            parts.append(build(c, k + 1))
        if d == glu_dim:
            halves = [p.chunk(2, dim=d) for p in parts]
            return torch.cat([h[0] for h in halves]
                             + [h[1] for h in halves], dim=d)
        return torch.cat(parts, dim=d)

    return build(dict.fromkeys(MESH_AXES, 0), 0)


# ---------------------------------------------------------------------------
# ZeRO-1 distributed optimizer sharding (the JAX module's rule, copied)
# ---------------------------------------------------------------------------


def zero1_spec(spec: Sequence, shape: tuple, dp: int, ep: int = 1) -> P:
    """Extend a parameter spec so optimizer state also shards over "data":
    the data axis goes onto the first dimension that is unsharded and
    divisible by dp (megatron_tpu/parallel/sharding.py:122-161). The
    reference's distrib_optimizer.py reduce-scatters gradients into that
    shard and all-gathers the updated params (training/optimizer.py)."""
    spec = P(*spec)
    if dp <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def has(axis):
        return any(e == axis or (isinstance(e, tuple) and axis in e)
                   for e in entries)

    if has(AXIS_DATA):
        return spec
    if has(AXIS_EXPERT):
        add, degree = AXIS_DATA, dp // ep
    else:
        add, degree = BATCH_AXES, dp
    if degree <= 1:
        return spec
    for i, (axes, dim) in enumerate(zip(entries, shape)):
        if axes is None and dim % degree == 0:
            entries[i] = add
            return P(*entries)
    return spec  # nothing divisible — leave replicated over data


def zero1_axes(spec: Sequence):
    """The axes ZeRO-1 cuts a leaf's optimizer state over, the ranks its
    gradient is averaged over: "data" for a leaf already sharded over
    "expert" (degree dp/ep), BATCH_AXES (data x expert) for the rest."""
    return AXIS_DATA if AXIS_EXPERT in spec_axes(spec) else BATCH_AXES


def zero1_spec_tree(spec_tree: Any, params: Any, dp: int, ep: int = 1
                    ) -> Any:
    """zero1_spec over matching nested dicts of specs and tensors (or
    anything with a .shape, or plain shape tuples)."""
    if isinstance(spec_tree, dict):
        return {k: zero1_spec_tree(spec_tree[k], params[k], dp, ep)
                for k in spec_tree}
    shape = params if isinstance(params, tuple) else tuple(params.shape)
    return zero1_spec(spec_tree, shape, dp, ep)


def zero1_dim(spec: Sequence, shape: tuple, dp: int, ep: int = 1
              ) -> Optional[int]:
    """The dimension zero1_spec puts the data axis on, or None."""
    spec = P(*spec)
    z = zero1_spec(spec, shape, dp, ep)
    for i, (a, b) in enumerate(zip(z, list(spec) + [None] * len(z))):
        if a != b:
            return i
    return None


# ---------------------------------------------------------------------------
# blocks as boxes of the global tensor (the checkpoint layout)
# ---------------------------------------------------------------------------

#: (global offsets, offsets in the rank's own tensor, sizes)
Piece = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]


def block_pieces(spec: Sequence, shape: Sequence[int],
                 coords: Dict[str, int], sizes: Dict[str, int],
                 glu_dim: Optional[int] = None,
                 layer_chunks: Optional[Tuple[int, int]] = None
                 ) -> List[Piece]:
    """The boxes of the global tensor of `shape` that the rank at
    `coords` holds under `spec`, as contiguous pieces of its slice
    (shard_leaf's output). A plain cut is one piece. glu_dim: the
    dimension cut per half gives a piece per half. layer_chunks (V, pp):
    dimension 0 is a layer axis stored in interleaved order
    (models/params.vpp_place_indices), whose V chunks of one stage are
    V boxes of the canonical layer order."""
    per_dim = []
    for d, n_glob in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, n = _block(sizes, coords, entry)
        if n_glob % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} not "
                             f"divisible by the {n} ranks of {entry!r}")
        b = n_glob // n
        if n > 1 and d == glu_dim:
            half = n_glob // 2
            b = half // n
            per_dim.append([(idx * b, 0, b), (half + idx * b, b, b)])
        elif d == 0 and layer_chunks is not None and layer_chunks[0] > 1:
            v, pp = layer_chunks
            lv = b // v
            per_dim.append([((c * pp + idx) * lv, c * lv, lv)
                            for c in range(v)])
        else:
            per_dim.append([(idx * b, 0, b)])
    return [(tuple(g for g, _, _ in combo), tuple(o for _, o, _ in combo),
             tuple(n for _, _, n in combo))
            for combo in itertools.product(*per_dim)]


def copy_overlap(dst: torch.Tensor, dst_offsets: Sequence[int],
                 src: torch.Tensor, src_offsets: Sequence[int]) -> int:
    """Copy the intersection of src's box (src_offsets + src.shape, in
    global coordinates) into dst's box, in place (cast to dst's dtype
    and device). Returns the elements copied (0: the boxes are
    disjoint)."""
    lo = [max(a, b) for a, b in zip(dst_offsets, src_offsets)]
    hi = [min(a + n, b + m) for a, n, b, m in
          zip(dst_offsets, dst.shape, src_offsets, src.shape)]
    if any(h <= l for l, h in zip(lo, hi)):
        return 0
    d = dst[tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi,
                                                        dst_offsets))]
    s = src[tuple(slice(l - o, h - o) for l, h, o in zip(lo, hi,
                                                        src_offsets))]
    with torch.no_grad():
        d.copy_(s)
    return d.numel()
