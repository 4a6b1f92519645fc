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

Serving (tools/run_text_generation_server under torch.distributed.run)
takes the same bring-up and a tensor-parallel mesh (serving_mesh: tp
over the whole world, no data or pipeline ranks, no sequence
parallelism). Rank 0 alone binds the HTTP port and logs; it drives the
other ranks through a ServingChannel, one broadcast command before each
piece of work whose collectives every rank must enter in the same
order, and the other ranks run the follower loop
(inference/server.GenerationService.follow).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
import threading
import time
from typing import Any, Optional, Tuple

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


def serving_mesh(tensor_parallel: int) -> MeshRuntime:
    """The mesh of a tensor-parallel server: every rank of the world on
    the tensor axis (the engine's sequences are not split)."""
    import torch.distributed as dist

    from megatron_tpu_torch.config import ParallelConfig
    from megatron_tpu_torch.parallel.mesh import build_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tensor_parallel:
        raise ValueError(
            f"serving at tensor_parallel={tensor_parallel} needs exactly "
            f"that many ranks, not {world}: data-parallel replicas and "
            "pipeline stages are not served yet (ROADMAP.md queue A item "
            "7b)")
    return build_mesh(ParallelConfig(tensor_parallel=tensor_parallel))


# an idle rank 0 tells the followers it is alive this often, well inside
# the process group's timeout
HEARTBEAT_S = 2.0


class ServingChannel:
    """Rank 0's commands to the other ranks of a tensor-parallel server.

    Every piece of work that runs collectives (a one-shot request, an
    engine tick) is announced by one broadcast of (op, payload) over the
    host-side group before rank 0 starts it (announce(), under `lock`,
    which rank 0 holds until the work is done), so the followers enter
    the collectives in rank 0's order. recv() is the followers' wait,
    bounded by the process group's timeout: a dead rank 0 fails a
    follower instead of hanging it. While rank 0 is idle a heartbeat
    thread sends ("idle", None) every HEARTBEAT_S, so an idle server
    never reaches that timeout; stop() sends ("stop", None).

    Once a command is announced, a failure on any rank leaves the ranks'
    collectives out of step, and nothing can put them back: it is a
    fault of the group. A follower's loop lets it end the process;
    on rank 0 announce() records it in `fault` and calls `on_fault` (the
    server stops and exits non-zero), and every later send raises. The
    launcher then tears the group down. A request is checked before it
    is announced, so a refusal never reaches the other ranks."""

    def __init__(self, group, rank: int):
        self.group = group
        self.rank = rank
        self.lock = threading.RLock()
        self.fault: Optional[BaseException] = None
        self.on_fault = None
        self._last = time.monotonic()
        self._stopped = False
        self._beat: Optional[threading.Thread] = None

    def send(self, op: str, payload: Any = None) -> None:
        """Rank 0: announce `op` (the caller holds `lock` through the
        work it announces). A failed broadcast is a fault."""
        import torch.distributed as dist

        with self.lock:
            if self.fault is not None:
                raise RuntimeError("the tensor-parallel group failed "
                                   f"earlier: {self.fault}")
            if self._stopped:
                raise RuntimeError("the serving channel is stopped")
            try:
                dist.broadcast_object_list([(op, payload)], src=0,
                                           group=self.group)
            except BaseException as e:
                self.fail(e)
                raise
            self._last = time.monotonic()

    @contextlib.contextmanager
    def announce(self, op: str, payload: Any = None):
        """Rank 0: announce `op`, then run the body (the work itself)
        under `lock`; any failure from the announcement on is a fault."""
        with self.lock:
            self.send(op, payload)
            try:
                yield
            except BaseException as e:
                self.fail(e)
                raise

    def fail(self, exc: BaseException) -> None:
        """Rank 0: record a fault of the group (the first one) and run
        on_fault once."""
        with self.lock:
            if self.fault is not None:
                return
            self.fault = exc
        print(f"tensor-parallel group fault on rank {self.rank}: {exc!r}; "
              "the ranks' collectives are out of step, the server stops",
              file=sys.stderr, flush=True)
        if self.on_fault is not None:
            self.on_fault(exc)

    def recv(self) -> Tuple[str, Any]:
        """A follower: the next command."""
        import torch.distributed as dist

        box: list = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def start_heartbeat(self) -> None:
        def beat():
            while True:
                time.sleep(HEARTBEAT_S / 4)
                with self.lock:
                    if self._stopped or self.fault is not None:
                        return
                    if time.monotonic() - self._last >= HEARTBEAT_S:
                        try:
                            self.send("idle")
                        except Exception:  # noqa: BLE001 - a fault:
                            return         # send() recorded it

        self._beat = threading.Thread(target=beat, daemon=True,
                                      name="serving-heartbeat")
        self._beat.start()

    def stop(self) -> None:
        """Rank 0: the followers leave their loop (after a fault there
        is nothing to tell them: they fail with the group)."""
        with self.lock:
            if self._stopped or self.fault is not None:
                self._stopped = True
                return
            self.send("stop")
            self._stopped = True
        if self._beat is not None:
            self._beat.join(timeout=HEARTBEAT_S)
