"""Process-group bring-up and per-rank data rows (counterpart of
megatron_tpu/parallel/distributed.py).

The reference's multi-process path: torch.distributed init_process_group
from the launcher's rank/world environment (megatron/initialize.py:
124-167), and each data-parallel rank loading its own rows of the global
batch (data_samplers.py:49-95). The JAX package bootstraps
jax.distributed from MEGATRON_TPU_* variables; here the variables of
``python -m torch.distributed.run`` (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) come first and the JAX module's
(MEGATRON_TPU_PROCESS_ID, MEGATRON_TPU_NUM_PROCESSES,
MEGATRON_TPU_COORDINATOR="host:port") are read when they are absent.

Backend: NCCL on CUDA; gloo only when the caller asks for the CPU or
names backend="gloo" itself (two ranks sharing one card: NCCL refuses
two ranks on one device, so only gloo ranks beyond the card count share
cards, rank LOCAL_RANK taking card LOCAL_RANK mod count). Nothing falls
back from one to the other.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from megatron_tpu_torch.parallel.mesh import MeshRuntime


def launch_env() -> Optional[Tuple[int, int, int, str]]:
    """(rank, world_size, local_rank, init_method) from the launcher's
    environment, or None when this process was not launched as a rank."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", env["RANK"])), "env://")
    if "MEGATRON_TPU_NUM_PROCESSES" in env:
        rank = int(env.get("MEGATRON_TPU_PROCESS_ID", "0"))
        coord = env.get("MEGATRON_TPU_COORDINATOR")
        if not coord:
            raise ValueError("MEGATRON_TPU_NUM_PROCESSES without "
                             "MEGATRON_TPU_COORDINATOR=host:port")
        return (rank, int(env["MEGATRON_TPU_NUM_PROCESSES"]),
                int(env.get("LOCAL_RANK", rank)), f"tcp://{coord}")
    return None


# a collective waits this long for its peers before the group errors out
_TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(device: str = "cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group this process was launched into.

    Returns False (and does nothing) when the environment names no
    rank: a plain single-process run. On CUDA the process takes card
    LOCAL_RANK (torch.cuda.set_device) before the group exists, as NCCL
    requires. backend: "nccl" (the default on CUDA) or "gloo" (the
    default on the CPU; on CUDA only when named)."""
    import torch.distributed as dist

    env = launch_env()
    if env is None:
        return False
    rank, world, local_rank, init_method = env
    if dist.is_initialized():
        return True
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend nccl needs device cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device cuda asked for but torch.cuda.is_available() is "
                "False (pass --device cpu to run the ranks on the CPU)")
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            if backend != "gloo":
                raise ValueError(
                    f"LOCAL_RANK {local_rank} with {cards} card(s): NCCL "
                    "takes one card per rank (ranks may share a card only "
                    "over gloo: --distributed_backend gloo)")
            local_rank %= cards         # gloo ranks share the cards
        torch.cuda.set_device(local_rank)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world, timeout=_TIMEOUT, **kw)
    return True


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: "cuda" resolves to the card set by
    initialize_distributed (LOCAL_RANK), the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def destroy_distributed() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_batch_slice(rt: MeshRuntime, global_rows: int) -> Tuple[int, int]:
    """[start, stop) of the global batch rows this rank must load (the
    JAX function's contract, distributed.py:114): the batch shards over
    (data, expert) in contiguous blocks, and every rank of one data
    replica (all tensor, pipe and context coordinates) gets the same
    block."""
    dp = rt.dp
    if global_rows % dp:
        raise ValueError(f"global batch of {global_rows} rows not "
                         f"divisible by the data-parallel degree {dp}")
    per = global_rows // dp
    return rt.dp_rank * per, (rt.dp_rank + 1) * per
