"""The collectives of tensor and sequence parallelism, written out (new:
the JAX package has no counterpart, XLA derives them from the specs).

The reference hand-writes them as autograd functions in
megatron/core/tensor_parallel/mappings.py:253-278; these are the same
five, each a torch.autograd.Function over the mesh's "tensor" group:

  copy_to_tp            forward identity, backward all-reduce (entry of a
                        column-parallel block, the input replicated)
  reduce_from_tp        forward all-reduce, backward identity (exit of a
                        row-parallel block)
  scatter_to_sp         forward this rank's sequence chunk, backward
                        all-gather
  gather_from_sp        forward all-gather along the sequence, backward
                        reduce-scatter (entry of a column-parallel block
                        under sequence parallelism)
  reduce_scatter_to_sp  forward reduce-scatter along the sequence,
                        backward all-gather (exit of a row-parallel block
                        under sequence parallelism)

Each is the identity at tp = 1 (no mesh, or a tensor axis of size 1), so
a world-size-1 run computes exactly the single-process path. Activations
are [B, S, h]; the sequence dimension is 1. A sixth, exchange, serves
expert parallelism (ops/moe.py): an all-to-all of rows over the expert
group whose backward is the mirrored all-to-all (the counterpart of the
JAX package's _ragged_exchange custom VJP, megatron_tpu/ops/moe.py:
254-292). A seventh, gather_context, is gather_from_sp over the
context group: the all-gathered K/V of context parallelism, whose
backward reduce-scatters their gradients (ops/attention.py). Two serve
the encoder families' heads: cls_row, the first row of a sequence the
tensor ranks split, broadcast from tensor rank 0 for the heads every
rank computes whole (its backward keeps rank 0's gradient: the
reference's gather with tensor_parallel_output_grad=False), and
gather_batch, the rows of the batch group concatenated (ICT's and
ORQA's in-batch negatives), whose backward reduce-scatters: each rank's
loss is the global loss, so the sum over the ranks holds it dp times,
and reduce_grads' 1/dp (training/train_step.py) makes the gradient the
global loss's.

The plain collectives below them route by backend in one place: NCCL
takes every collective natively on CUDA tensors; gloo has no send/recv,
no reduce-scatter and no all-to-all for CUDA tensors, so on a gloo
group a CUDA tensor is staged through host memory, and reduce-scatter
is composed from an all-reduce and a slice. Gloo runs only where the
caller asked for it (parallel/distributed.py). Each plain collective between two or more
ranks runs inside a torch.profiler range named "comm.<op>" (staging and
waits included), so a profiled step's collective share is the union of
those ranges.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

_all_gather_tensor = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _native(group) -> bool:
    """NCCL takes the collectives below natively; gloo is composed."""
    return dist.get_backend(group) == "nccl"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu") if t.is_cuda else t


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: t reduced (sum, max or min) over the group."""
    if group_size(group) == 1:
        return t
    with record_function("comm.all_reduce"):
        return _all_reduce(t, group, op)


def _all_reduce(t: torch.Tensor, group, op: str) -> torch.Tensor:
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    if _native(group) or not t.is_cuda:
        out = t.detach().clone()
        dist.all_reduce(out, op=red, group=group)
        return out
    host = _to_host(t)
    dist.all_reduce(host, op=red, group=group)
    return host.to(t.device)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank `src`'s t on every rank of the group, a new tensor on
    t's device (the other ranks' t gives the shape and dtype only)."""
    if group_size(group) == 1:
        return t
    with record_function("comm.broadcast"):
        root = dist.get_global_rank(group, src)
        if _native(group) or not t.is_cuda:
            out = t.detach().clone().contiguous()
            dist.broadcast(out, src=root, group=group)
            return out
        host = _to_host(t).contiguous().clone()
        dist.broadcast(host, src=root, group=group)
        return host.to(t.device)


def _all_gather_native(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    inp = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


def _all_gather_gloo(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    host = _to_host(t).contiguous()
    parts = [torch.empty_like(host) for _ in range(n)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in group-rank order."""
    if group_size(group) == 1:
        return t
    with record_function("comm.all_gather"):
        if _native(group):
            return _all_gather_native(t, group, dim)
        return _all_gather_gloo(t, group, dim)


def _reduce_scatter_native(t: torch.Tensor, group, dim: int
                           ) -> torch.Tensor:
    n = group_size(group)
    inp = t.detach().movedim(dim, 0).contiguous()
    out = torch.empty((inp.shape[0] // n,) + tuple(inp.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _reduce_scatter_tensor(out, inp, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_gloo(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = group_size(group), dist.get_rank(group)
    total = _all_reduce(t, group, "sum")
    return total.chunk(n, dim=dim)[r].contiguous()


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This group rank's block along `dim` of the sum over the group."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} not "
                         f"divisible by the group's {n} ranks")
    with record_function("comm.reduce_scatter"):
        if _native(group):
            return _reduce_scatter_native(t, group, dim)
        return _reduce_scatter_gloo(t, group, dim)


def all_to_all(t: torch.Tensor, group, send: Sequence[int],
               recv: Sequence[int]) -> torch.Tensor:
    """Rows of t [sum(send), ...] to the group's ranks: send[j] rows (in
    order) to group rank j; returns the [sum(recv), ...] rows received,
    recv[i] from group rank i, in group-rank order (uneven splits:
    dist.all_to_all_single's)."""
    if group_size(group) == 1:
        return t
    with record_function("comm.all_to_all"):
        src = t.detach().contiguous()
        host = not _native(group) and src.is_cuda
        if host:
            src = src.cpu()
        out = src.new_empty((int(sum(recv)),) + tuple(src.shape[1:]))
        dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=group)
        return out.to(t.device) if host else out


def p2p(sends: Sequence[Tuple[torch.Tensor, int, int]],
        recvs: Sequence[Tuple[tuple, torch.dtype, torch.device, int, int]]
        ) -> List[torch.Tensor]:
    """Point-to-point exchange, every operation posted before any is
    waited on (so two neighbors that send to each other cannot block
    each other). sends: (tensor, global peer rank, tag); recvs: (shape,
    dtype, device, global peer rank, tag). Returns the received tensors.
    NCCL batches the operations (batch_isend_irecv matches same-peer
    messages in posting order; tags are gloo's); gloo stages CUDA
    tensors through host memory."""
    return p2p_start(sends, recvs)()


def p2p_start(sends: Sequence[Tuple[torch.Tensor, int, int]],
              recvs: Sequence[Tuple[tuple, torch.dtype, torch.device, int,
                                    int]]
              ) -> Callable[[], List[torch.Tensor]]:
    """p2p's exchange posted now and waited on later: returns the wait,
    which returns the received tensors (the overlapped ring of
    inference/context_parallel/ring_kv.py posts hop l + 1 before it
    merges hop l). Posting and waiting each run in a "comm.p2p" range."""
    if not sends and not recvs:
        return lambda: []
    with record_function("comm.p2p"):
        wait = _p2p_post(sends, recvs)

    def finish() -> List[torch.Tensor]:
        with record_function("comm.p2p"):
            return wait()

    return finish


def _p2p_post(sends, recvs) -> Callable[[], List[torch.Tensor]]:
    native = dist.get_backend() == "nccl"
    if native:
        bufs = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype, device, _, _ in recvs]
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer, tag=tag)
               for t, peer, tag in sends]
        ops += [dist.P2POp(dist.irecv, b, peer, tag=tag)
                for b, (_, _, _, peer, tag) in zip(bufs, recvs)]
        works = dist.batch_isend_irecv(ops)

        def wait_native():
            for w in works:
                w.wait()
            return bufs

        return wait_native
    host_sends = [_to_host(t).contiguous() for t, _, _ in sends]
    host_bufs = [torch.empty(shape, dtype=dtype)
                 for shape, dtype, _, _, _ in recvs]
    works = [dist.isend(h, peer, tag=tag)
             for h, (_, peer, tag) in zip(host_sends, sends)]
    works += [dist.irecv(b, peer, tag=tag)
              for b, (_, _, _, peer, tag) in zip(host_bufs, recvs)]

    def wait_gloo():
        for w in works:
            w.wait()
        host_sends.clear()          # the sends' host copies live until here
        return [b.to(device) for b, (_, _, device, _, _)
                in zip(host_bufs, recvs)]

    return wait_gloo


# ---------------------------------------------------------------------------
# autograd collectives over the tensor-parallel group
# ---------------------------------------------------------------------------

SEQ_DIM = 1


def _tp_group(mesh):
    """The tensor group, or None when there is no tensor parallelism."""
    if mesh is None or mesh.tp == 1:
        return None
    return mesh.group("tensor")


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = group_size(group), dist.get_rank(group)
        return x.chunk(n, dim=SEQ_DIM)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, SEQ_DIM), None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, SEQ_DIM), None


class _ReduceScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, SEQ_DIM), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group, ctx.recv, ctx.send), None, None, None


def exchange(x: torch.Tensor, group, send: Sequence[int],
             recv: Sequence[int]) -> torch.Tensor:
    """all_to_all with a gradient: the rows' gradients travel back along
    the mirrored route (the split sizes swapped)."""
    if group_size(group) == 1:
        return x
    return _Exchange.apply(x, group, tuple(int(n) for n in send),
                           tuple(int(n) for n in recv))


class _ClsRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.first = dist.get_rank(group) == 0
        ctx.shape = x.shape
        return broadcast(x[:, 0].contiguous(), group, 0)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        if ctx.first:
            out[:, 0] = g
        return out, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, 0), None


def cls_row(hidden: torch.Tensor, mesh) -> torch.Tensor:
    """hidden[:, 0] of the whole sequence [B, h] on every tensor rank:
    under sequence parallelism `hidden` is this rank's chunk and the
    row is tensor rank 0's, broadcast (the module docstring); else the
    row itself."""
    if mesh is None or not mesh.sequence_parallel:
        return hidden[:, 0]
    return _ClsRow.apply(hidden, mesh.group("tensor"))


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The batch group's rows of x concatenated in batch-rank order (the
    module docstring); x itself at dp 1."""
    if mesh is None or mesh.dp == 1:
        return x
    return _GatherRows.apply(x, mesh.group(("data", "expert")))


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    group = _tp_group(mesh)
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    group = _tp_group(mesh)
    return x if group is None else _ReduceFromTP.apply(x, group)


def scatter_to_sp(x: torch.Tensor, mesh) -> torch.Tensor:
    group = _tp_group(mesh)
    return x if group is None else _ScatterToSP.apply(x, group)


def gather_from_sp(x: torch.Tensor, mesh) -> torch.Tensor:
    group = _tp_group(mesh)
    return x if group is None else _GatherFromSP.apply(x, group)


def reduce_scatter_to_sp(x: torch.Tensor, mesh) -> torch.Tensor:
    group = _tp_group(mesh)
    return x if group is None else _ReduceScatterToSP.apply(x, group)


def enter_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Into a column-parallel block: the sequence gathered under
    sequence parallelism, else the replicated input whose gradient is
    summed over the tensor group."""
    if mesh is not None and mesh.sequence_parallel:
        return gather_from_sp(x, mesh)
    return copy_to_tp(x, mesh)


def exit_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Out of a row-parallel block: the partial sums reduced, and
    scattered along the sequence under sequence parallelism."""
    if mesh is not None and mesh.sequence_parallel:
        return reduce_scatter_to_sp(x, mesh)
    return reduce_from_tp(x, mesh)


def gather_context(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole sequence of a context-parallel activation [B, S/cp, ...]
    (the context ranks' pieces in rank order), its gradient
    reduce-scattered back; the identity at cp 1."""
    if mesh is None or mesh.cp == 1:
        return x
    return _GatherFromSP.apply(x, mesh.group("context"))


def sp_slice(x: torch.Tensor, mesh, dim: int = SEQ_DIM) -> torch.Tensor:
    """This rank's sequence chunk of a tensor every rank holds whole (no
    autograd collective: e.g. the positions of its tokens)."""
    if mesh is None or not mesh.sequence_parallel:
        return x
    return x.chunk(mesh.tp, dim=dim)[mesh.tp_rank]
