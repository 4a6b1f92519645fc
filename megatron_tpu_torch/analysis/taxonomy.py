"""Collective-op taxonomy shared by the trace reader and the comm
contracts (counterpart of megatron_tpu/analysis/taxonomy.py, stdlib
only, so tools/trace_report.py reads a trace without torch).

The JAX package names collectives by their HLO mnemonics
(``all-reduce.12``). The port's collectives show up in a torch.profiler
trace under three other names, all mapped onto the same bases:

  * the ``comm.*`` ranges that parallel/mappings.py and
    quant/collectives.py open around every collective (``comm.all_reduce``,
    ``comm.p2p``, ...) — the host's record of one call, and the one that
    counts;
  * the NCCL kernels on the card's timeline
    (``ncclDevKernel_AllReduce_Sum_bf16_RING_LL``,
    ``ncclDevKernel_SendRecv``): their time is communication, but the
    call was already counted by its range (``is_collective_done_half``);
  * the process groups' own host ops inside a range (``gloo:all_reduce``,
    ``nccl:all_reduce``, ``c10d::allreduce_``, ``record_param_comms``):
    likewise time only.

The HLO mnemonics themselves still map, so the port's analyzer also
reads the JAX package's manifests and synthetic events.
"""

from __future__ import annotations

import re
from typing import Optional

#: explicit collective primitives at jaxpr level (the JAX manifests'
#: jaxpr sections key on these)
COLLECTIVE_PRIMITIVES = {
    "psum", "pmax", "pmin", "ppermute", "pbroadcast", "all_gather",
    "all_to_all", "reduce_scatter", "psum_scatter", "pgather",
    "ragged_all_to_all",
}

#: the collective bases (HLO mnemonics, the JAX package's names)
HLO_COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "all-to-all", "collective-permute",
    "reduce-scatter", "collective-broadcast", "ragged-all-to-all",
)

#: ops that move data between host and device rather than computing
HLO_TRANSFER_OPS = ("infeed", "outfeed", "copy-start", "copy-done",
                    "send", "recv", "send-done", "recv-done")

#: the port's comm.* range suffix -> base (parallel/mappings.py)
COMM_RANGE_BASES = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "p2p": "collective-permute",
    "broadcast": "collective-broadcast",
}

#: a process group's op name (NCCL kernel infix, gloo/nccl host op,
#: c10d op) -> base; matched case- and underscore-insensitively
_GROUP_OP_BASES = {
    "allreduce": "all-reduce",
    "allgather": "all-gather",
    "allgatherbase": "all-gather",
    "reducescatter": "reduce-scatter",
    "reducescatterbase": "reduce-scatter",
    "alltoall": "all-to-all",
    "alltoallbase": "all-to-all",
    "sendrecv": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
    "broadcast": "collective-broadcast",
}

_COLLECTIVE_RE = re.compile(
    r"^(" + "|".join(HLO_COLLECTIVE_OPS) + r")(-start|-done)?(\.\d+)?$")
_TRANSFER_RE = re.compile(
    r"^(" + "|".join(HLO_TRANSFER_OPS) + r")(\.\d+)?$")
_COMM_RANGE_RE = re.compile(r"^comm\.(\w+)$")
_NCCL_KERNEL_RE = re.compile(r"^nccl(?:Dev)?Kernel_([A-Za-z]+)")
_GROUP_OP_RE = re.compile(r"^(?:gloo|nccl|c10d):+_?([A-Za-z_]+?)_?$")


def _group_op_base(op: str) -> Optional[str]:
    return _GROUP_OP_BASES.get(op.replace("_", "").lower())


def collective_base(op_name: str) -> Optional[str]:
    """The collective base an event name belongs to, or None for
    non-collectives: an HLO instruction (``all-gather-start.3`` ->
    ``all-gather``), a comm.* range (``comm.p2p`` ->
    ``collective-permute``), an NCCL kernel or a process group's op."""
    m = _COLLECTIVE_RE.match(op_name)
    if m:
        return m.group(1)
    m = _COMM_RANGE_RE.match(op_name)
    if m:
        return COMM_RANGE_BASES.get(m.group(1))
    m = _NCCL_KERNEL_RE.match(op_name)
    if m:
        return _group_op_base(m.group(1))
    m = _GROUP_OP_RE.match(op_name)
    if m:
        return _group_op_base(m.group(1))
    return None


def is_comm_range(op_name: str) -> bool:
    """True for a comm.* range the port opens around one collective."""
    m = _COMM_RANGE_RE.match(op_name)
    return bool(m) and m.group(1) in COMM_RANGE_BASES


def is_collective_done_half(op_name: str) -> bool:
    """True for a collective event whose call is counted elsewhere: the
    ``-done`` half of an async HLO pair, an NCCL kernel or a process
    group's own op (each inside the comm.* range that counts the call).
    Its time is still communication."""
    m = _COLLECTIVE_RE.match(op_name)
    if m:
        return m.group(2) == "-done"
    return (collective_base(op_name) is not None
            and not is_comm_range(op_name))


def is_transfer(op_name: str) -> bool:
    """True for infeed/outfeed/host-transfer instruction names."""
    return _TRANSFER_RE.match(op_name) is not None
