"""The rank layout and its process groups (counterpart of
megatron_tpu/parallel/mesh.py).

The JAX package builds one ``jax.sharding.Mesh`` with axes ("data",
"expert", "pipe", "context", "tensor") and lets GSPMD place data on it.
Here the same layout is a grid of torch.distributed ranks in the same
axis order, tensor innermost (the reference's TP-innermost-contiguous
layout, parallel_state.py:68-82): rank r sits at
``np.unravel_index(r, (dp, ep, pp, cp, tp))``, which is exactly the mesh
position of device index r in the JAX mesh, so rank r holds the slice of
each parameter that JAX device r holds.

MeshRuntime holds the degrees, this rank's coordinates and one
ProcessGroup per axis of size > 1 (the reference's
get_tensor_model_parallel_group() & co.), plus the batch group: the
ranks that split one batch, (data, expert) together (the JAX batch
spec's two axes), over which the dense leaves' gradients, the loss and
the router's statistics are averaged; the expert leaves, sharded over
"expert", reduce over "data" alone. The context group holds the ranks
that split one sequence (context parallelism, ops/attention.py): every
parameter is replicated over it, its ranks read the same rows, and
context_prev / context_next are the ring's neighbors
(ops/ring_attention.py). Unlike the JAX package it also
holds the embedding group: under pipeline parallelism with tied
embeddings the first stage (the token embedding) and the last stage (the
LM head) each keep a copy of embed/tokens, and their gradients are summed
over that two-rank group every step (parallel_state.py:174-184). JAX
needs no such group (mesh.py:12-14 there): both uses read one shared
array and XLA sums the cotangents.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from megatron_tpu_torch.config import ParallelConfig

AXIS_DATA = "data"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
AXIS_CONTEXT = "context"
AXIS_TENSOR = "tensor"
MESH_AXES = (AXIS_DATA, AXIS_EXPERT, AXIS_PIPE, AXIS_CONTEXT, AXIS_TENSOR)
# the batch dimension shards over data AND expert
BATCH_AXES = (AXIS_DATA, AXIS_EXPERT)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshRuntime:
    """The resolved topology as seen by one rank."""

    parallel: ParallelConfig
    data_parallel: int
    rank: int
    world_size: int
    coords: Dict[str, int]              # this rank's index on each axis
    groups: Dict[Any, object]           # axis or BATCH_AXES -> ProcessGroup
                                        # (size > 1)
    embedding_group: Optional[object] = None
    # global ranks of the previous and next pipeline stage (a ring)
    pipe_prev: Optional[int] = None
    pipe_next: Optional[int] = None
    # global ranks of the previous and next context rank (a ring)
    context_prev: Optional[int] = None
    context_next: Optional[int] = None
    # a gloo group of every rank for host-side flags (the loop's exit
    # agreement), so agreeing on one never waits on the card
    control_group: Optional[object] = None

    @property
    def tp(self) -> int:
        return self.parallel.tensor_parallel

    @property
    def pp(self) -> int:
        return self.parallel.pipeline_parallel

    @property
    def vpp(self) -> int:
        return self.parallel.virtual_pipeline_parallel or 1

    @property
    def cp(self) -> int:
        return self.parallel.context_parallel

    @property
    def cp_rank(self) -> int:
        return self.coords[AXIS_CONTEXT]

    @property
    def dp(self) -> int:
        """Degree the batch is sharded over (data x expert)."""
        return self.data_parallel * self.parallel.expert_parallel

    @property
    def ep(self) -> int:
        return self.parallel.expert_parallel

    @property
    def sequence_parallel(self) -> bool:
        return self.parallel.sequence_parallel and self.tp > 1

    def size(self, axis) -> int:
        """An axis's degree; BATCH_AXES: data x expert."""
        if axis == BATCH_AXES:
            return self.dp
        return {AXIS_DATA: self.data_parallel,
                AXIS_EXPERT: self.parallel.expert_parallel,
                AXIS_PIPE: self.pp,
                AXIS_CONTEXT: self.parallel.context_parallel,
                AXIS_TENSOR: self.tp}[axis]

    def group(self, axis):
        """The ProcessGroup of an axis (or of BATCH_AXES), or None when
        it has one rank."""
        return self.groups.get(axis)

    def index(self, axis) -> int:
        """This rank's index on an axis (BATCH_AXES: dp_rank)."""
        return self.dp_rank if axis == BATCH_AXES else self.coords[axis]

    @property
    def tp_rank(self) -> int:
        return self.coords[AXIS_TENSOR]

    @property
    def pp_rank(self) -> int:
        return self.coords[AXIS_PIPE]

    @property
    def dp_rank(self) -> int:
        """Index in the batch's (data, expert) sharding."""
        return (self.coords[AXIS_DATA] * self.parallel.expert_parallel
                + self.coords[AXIS_EXPERT])

    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.pp - 1


def rank_grid(parallel: ParallelConfig, world_size: int) -> np.ndarray:
    """Global ranks laid out on the (data, expert, pipe, context, tensor)
    grid, tensor fastest (the JAX mesh's device order)."""
    parallel = parallel.validate()
    dp = parallel.derive_data_parallel(world_size)
    shape = (dp, parallel.expert_parallel, parallel.pipeline_parallel,
             parallel.context_parallel, parallel.tensor_parallel)
    return np.arange(world_size).reshape(shape)


def build_mesh(parallel: ParallelConfig,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> MeshRuntime:
    """This rank's MeshRuntime. With torch.distributed initialized the
    world comes from it and every axis group is created (new_group is
    collective: every rank creates every group, in one order); without
    it the world is this one process and there are no groups."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    parallel = parallel.validate()
    grid = rank_grid(parallel, world_size)
    dp = grid.shape[0]
    coords = dict(zip(MESH_AXES,
                      (int(c) for c in np.unravel_index(rank, grid.shape))))
    groups: Dict[Any, object] = {}
    embedding_group = control_group = None
    if initialized and world_size > 1:
        control_group = dist.new_group(backend="gloo")
        for i, axis in enumerate(MESH_AXES):
            n = grid.shape[i]
            if n == 1:
                continue
            fibers = np.moveaxis(grid, i, -1).reshape(-1, n)
            for fiber in fibers:
                g = dist.new_group([int(r) for r in fiber])
                if rank in fiber:
                    groups[axis] = g
        # the batch group: the data or expert group when the other has
        # one rank, else one group per (data, expert) plane
        ep = parallel.expert_parallel
        if dp > 1 and ep > 1:
            for fiber in np.moveaxis(grid, (0, 1), (-2, -1)).reshape(
                    -1, dp * ep):
                g = dist.new_group([int(r) for r in fiber])
                if rank in fiber:
                    groups[BATCH_AXES] = g
        elif dp * ep > 1:
            groups[BATCH_AXES] = groups[AXIS_DATA if dp > 1 else AXIS_EXPERT]
        if parallel.pipeline_parallel > 1:
            pipe = MESH_AXES.index(AXIS_PIPE)
            for fiber in np.moveaxis(grid, pipe, -1).reshape(
                    -1, parallel.pipeline_parallel):
                ends = [int(fiber[0]), int(fiber[-1])]
                g = dist.new_group(ends)
                if rank in ends:
                    embedding_group = g

    def neighbors(axis):
        """Global ranks one step back and forward along an axis (a
        ring), or (None, None) when it has one rank."""
        n = grid.shape[MESH_AXES.index(axis)]
        if n == 1:
            return None, None

        def at(i):
            c = dict(coords, **{axis: i % n})
            return int(grid[tuple(c[a] for a in MESH_AXES)])

        return at(coords[axis] - 1), at(coords[axis] + 1)

    pipe_prev, pipe_next = neighbors(AXIS_PIPE)
    context_prev, context_next = neighbors(AXIS_CONTEXT)
    return MeshRuntime(parallel=parallel, data_parallel=dp, rank=rank,
                       world_size=world_size, coords=coords, groups=groups,
                       embedding_group=embedding_group,
                       pipe_prev=pipe_prev, pipe_next=pipe_next,
                       context_prev=context_prev, context_next=context_next,
                       control_group=control_group)
