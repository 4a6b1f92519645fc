"""ContextParallelEngine: paged serving with sequence-sharded KV
(counterpart of megatron_tpu/inference/context_parallel/engine.py).

A subclass of the paged engine (inference/paging/engine.py) that keeps
every host policy (one global radix prefix tree, one chunked-prefill
queue, LIFO preemption, sliding-window release, the global [N,
max_pages] table rows) and changes the device side:

  * the KV page pools are striped over the context group: logical page
    l of any row lives on context rank ``l % cp`` (pool.StripedPagePool
    allocates so), and each rank holds only its stripe, pools [L,
    num_pages / cp, ps, nkv / tp, D];
  * the decode tick and each prefill chunk address this rank's LOCAL
    table ([rows, mpl]: entry [i, j] is the local pool index of logical
    page ``j * cp + rank`` of row i, or the sentinel npl), and every
    layer's attention is ring_kv.paged_ring_attention: the rank's stripe
    attended alone (the decode partial on B5, csrc/flash_decode.cu in
    its partial form), then the partials merged over the ring or the 2d
    geometry;
  * the merge's transport is a quant.collectives.CpComm: dense fp32 or
    int8/fp8 (site "cp_ring", and "cp_a2a" for the 2d head legs),
    composable with the compressed TP collectives on a tensor x context
    mesh.

Rank 0 alone keeps the pool, the radix tree and the queue, and announces
each chunk and tick through the ServingChannel (the paged engine's tensor
-parallel record, inference/paging/engine.py), so every rank enters the
ring hops in rank 0's order; the other ranks follow with no scheduler
state. The tick runs eagerly (cuda_graph=True is refused above one rank,
as at tp > 1: the ring's collectives cannot be captured).

Host bookkeeping is the paged engine's, so radix hits, mid-prefill
preempt/resume and ragged prompt tails are exact by the same arguments;
greedy tokens equal the one-process paged engine's. int8 KV pools,
speculative decoding and cp_collectives "none" are refused, as in the
JAX engine.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from megatron_tpu_torch.config import ModelConfig
from megatron_tpu_torch.inference.context_parallel.pool import (
    StripedPagePool,
)
from megatron_tpu_torch.inference.paging.engine import PagedInferenceEngine
from megatron_tpu_torch.inference.paging.pool import SCRATCH_PAGE
from megatron_tpu_torch.inference.paging.radix import RadixPrefixCache
from megatron_tpu_torch.ops.kv_quant import kv_buffers
from megatron_tpu_torch.parallel.mesh import AXIS_CONTEXT
from megatron_tpu_torch.quant.collectives import (
    cp_ring_comm_bytes, make_cp_comm,
)
from megatron_tpu_torch.telemetry.metrics import MetricsRegistry


class ContextParallelEngine(PagedInferenceEngine):
    """Paged serving engine over a tensor x context mesh (cp >= 2)."""

    serves_context = True

    def __init__(self, cfg: ModelConfig, params, num_slots: int = 8,
                 max_seq_len: Optional[int] = None,
                 page_size: int = 16, prefill_chunk: int = 32,
                 num_pages: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, device="cuda",
                 cuda_graph: bool = True, max_queue: Optional[int] = None,
                 mesh=None, channel=None,
                 compress_collectives: str = "none", comm_policy=None,
                 comm_chunk: int = 32, cp_collectives: str = "dense",
                 cp_comm_policy=None, cp_geometry: str = "ring",
                 cp_subgroup: int = 0, cp_overlap: bool = True,
                 kv_cache_int8: bool = False, speculative=None):
        if mesh is None:
            raise ValueError(
                "ContextParallelEngine requires a mesh with a non-trivial "
                f"'{AXIS_CONTEXT}' axis")
        if mesh.cp <= 1:
            raise ValueError(
                f"ContextParallelEngine needs {AXIS_CONTEXT} >= 2 on the "
                f"mesh (got {mesh.cp}); use PagedInferenceEngine for "
                "cp == 1")
        if kv_cache_int8 or speculative is not None:
            raise ValueError(
                "context-parallel serving supports neither int8 KV pools "
                "nor speculative decoding")
        self.cp, self.cp_rank = mesh.cp, mesh.cp_rank
        # before super().__init__: the pools and tables it builds are
        # this rank's stripe
        self.cp_comm = make_cp_comm(mesh, cp_collectives, cfg=cfg,
                                    policy=cp_comm_policy, chunk=comm_chunk,
                                    geometry=cp_geometry,
                                    subgroup=cp_subgroup, overlap=cp_overlap)
        if self.cp_comm is None:
            raise ValueError(
                f"cp_collectives={cp_collectives!r} disables the ring "
                "transport the CP engine is built on (use 'dense', 'int8' "
                "or 'fp8')")
        super().__init__(
            cfg, params, num_slots=num_slots, max_seq_len=max_seq_len,
            page_size=page_size, prefill_chunk=prefill_chunk,
            num_pages=num_pages, vocab_size=vocab_size, metrics=metrics,
            device=device, cuda_graph=cuda_graph, max_queue=max_queue,
            mesh=mesh, channel=channel,
            compress_collectives=compress_collectives,
            comm_policy=comm_policy, comm_chunk=comm_chunk)
        if self._npl - 1 < self._mpl:
            raise ValueError(
                f"num_pages={self.num_pages} over cp={self.cp} leaves "
                f"{self._npl} pages per rank — rank 0 (minus scratch) "
                f"cannot hold one full sequence ({self._mpl} pages)")
        # the striped allocator under the same refcount and scratch
        # contract (nothing is allocated yet)
        self.pool = StripedPagePool(self.num_pages, self.cp)
        self.prefix_cache = RadixPrefixCache(self.pool, self.page_size)
        self._m_pages_free.set(self.pool.free_pages)

        # the ring's static wire prices of a decode tick and of a chunk
        self._cp_tick_bytes = cp_ring_comm_bytes(cfg, self.cp_comm,
                                                 num_slots, 1)
        self._cp_chunk_bytes = cp_ring_comm_bytes(cfg, self.cp_comm, 1,
                                                  self.prefill_chunk)
        self.stats.update({"cp_ring_steps": 0, "cp_comm_dense_bytes": 0,
                           "cp_comm_compressed_bytes": 0,
                           "cp_comm_a2a_dense_bytes": 0,
                           "cp_comm_a2a_compressed_bytes": 0,
                           "cp_admission_blocked": 0})
        self._cp_dry_shards: tuple = ()
        m = self.metrics
        self._m_cp_ring = m.counter(
            "engine_cp_ring_steps_total",
            "context-parallel ring hops executed (per layer per forward)")
        self._m_cp_dense = m.counter(
            "engine_cp_comm_dense_bytes_total",
            "wire bytes the CP ring hops would move dense")
        self._m_cp_comp = m.counter(
            "engine_cp_comm_compressed_bytes_total",
            "wire bytes the CP ring hops move at the configured mode")
        self._m_cp_a2a_dense = m.counter(
            "engine_cp_a2a_dense_bytes_total",
            "wire bytes the 2d geometry's head a2a legs would move dense")
        self._m_cp_a2a_comp = m.counter(
            "engine_cp_a2a_compressed_bytes_total",
            "wire bytes the 2d geometry's head a2a legs move at the "
            "configured mode")
        self._m_cp_shard_free = m.gauge(
            "engine_cp_shard_pages_free",
            "free pages in each CP rank's pool shard",
            label_names=("shard",))
        self._m_cp_blocked = m.counter(
            "engine_cp_admission_blocked_total",
            "page allocations blocked by an exhausted CP pool shard "
            "(striped-pool pressure, distinct from queue depth)",
            label_names=("shard",))
        self._set_shard_gauges()

    # ----- cache + shape policy -------------------------------------------

    def _fresh_caches(self):
        """This rank's stripe of the paged pools: [L, num_pages / cp, ps,
        nkv / tp, D] x2, zeroed. The page count is rounded up to a
        multiple of cp so every rank holds an equal shard."""
        self.max_pages = -(-self.max_seq_len // self.page_size)
        if self.num_pages is None:
            self.num_pages = self.num_slots * self.max_pages + 1
        self.num_pages += (-self.num_pages) % self.cp
        self._npl = self.num_pages // self.cp      # pool pages a rank
        self._mpl = -(-self.max_pages // self.cp)  # table slots a rank
        cfg = self.cfg
        shape = (cfg.num_layers, self._npl, self.page_size,
                 cfg.n_kv_heads // self.tp, cfg.head_dim)
        return kv_buffers(shape, cfg.dtype, False, self.device)

    def _init_static(self) -> None:
        # this rank's [N, mpl] local table of the decode tick, refreshed
        # in place from the host tables after an edit
        self._device_table = torch.full(
            (self.num_slots, self._mpl),
            SCRATCH_PAGE if self.cp_rank == 0 else self._npl,
            dtype=torch.int32, device=self.device)

    # ----- page accounting -------------------------------------------------

    def _alloc_pages(self, n: int,
                     logical_start: int = 0) -> Optional[List[int]]:
        """Striped allocation with eviction: a failed alloc means some
        rank's shard is dry, so evict LRU cache-only pages (on whatever
        ranks) and retry until the striped grab fits or eviction runs
        dry. A final failure is put on the dry shard(s): counter, journal
        (once an episode) and the 503 detail (_overload_detail)."""
        pages = self.pool.alloc(n, logical_start)
        while pages is None and self.prefix_cache.evict(max(n, 1)) > 0:
            pages = self.pool.alloc(n, logical_start)
        if pages is not None:
            self._m_pages_free.set(self.pool.free_pages)
            self._cp_dry_shards = ()
            return pages
        need = [0] * self.cp
        for j in range(n):
            need[(logical_start + j) % self.cp] += 1
        free = self.pool.free_pages_by_rank()
        dry = tuple(r for r in range(self.cp) if need[r] > free[r])
        self.stats["cp_admission_blocked"] += 1
        for r in dry:
            self._m_cp_blocked.inc(shard=str(r))
        if dry != self._cp_dry_shards:
            from megatron_tpu_torch.telemetry import journal

            j = journal.get_global_journal()
            if j is not None:
                j.emit("cp_admission_blocked", shards=list(dry),
                       need=need, free_by_rank=list(free), pages=n)
        self._cp_dry_shards = dry
        return None

    def _overload_detail(self) -> str:
        """Queue-full rejections name the dry shard(s) while striped-pool
        exhaustion, not decode throughput, stalls admission."""
        if self._cp_dry_shards:
            shards = ",".join(str(r) for r in self._cp_dry_shards)
            return (f"cp shard(s) {shards} exhausted (striped KV pool "
                    "pressure); ")
        return ""

    # ----- local tables ----------------------------------------------------

    def _loc_tables(self, rows: np.ndarray) -> np.ndarray:
        """Global table rows [M, max_pages] -> per-rank local tables
        [cp, M, mpl]: entry [r, i, j] is rank r's local pool index of
        logical page ``j * cp + r`` of row i. Unallocated entries (global
        SCRATCH_PAGE) map to the local scratch on rank 0 and to the
        sentinel npl elsewhere."""
        rows = np.asarray(rows, np.int32)
        cp, npl, mpl = self.cp, self._npl, self._mpl
        loc = np.full((cp, rows.shape[0], mpl), npl, np.int32)
        for r in range(cp):
            cols = rows[:, r::cp]
            if ((cols != SCRATCH_PAGE) & (cols // npl != r)).any():
                raise AssertionError(
                    f"page-striping invariant violated on rank {r}: a "
                    "logical page maps outside its owner's pool shard")
            loc[r, :, :cols.shape[1]] = np.where(
                cols == SCRATCH_PAGE, 0 if r == 0 else npl, cols - r * npl)
        return loc

    def _decode_extra_args(self) -> dict:
        return {"page_table": self._device_table, "cp_comm": self.cp_comm}

    def _refresh_carry(self, rows: List[int]) -> None:
        if self._table_dirty:
            self._device_table.copy_(torch.from_numpy(
                self._loc_tables(self.tables)[self.cp_rank]))
            self._table_dirty = False
        super()._refresh_carry(rows)

    def _chunk_table_args(self, row: np.ndarray) -> dict:
        local = self._loc_tables(np.asarray(row)[None, :])[self.cp_rank]
        return {"page_table": torch.from_numpy(local).to(self.device),
                "cp_comm": self.cp_comm}

    # ----- telemetry -------------------------------------------------------

    def _count_tick(self) -> None:
        super()._count_tick()
        self._count_ring(self._cp_tick_bytes)

    def _count_chunk(self) -> None:
        super()._count_chunk()
        self._count_ring(self._cp_chunk_bytes)

    def _count_ring(self, cp_pair) -> None:
        """Advance the engine_cp_* counters by one forward's ring hops
        and their static wire price."""
        hops = self.cp_comm.ring_hops() * self.cfg.num_layers
        self.stats["cp_ring_steps"] += hops
        self.stats["cp_comm_dense_bytes"] += cp_pair["dense"]
        self.stats["cp_comm_compressed_bytes"] += cp_pair["compressed"]
        self._m_cp_ring.inc(hops)
        self._m_cp_dense.inc(cp_pair["dense"])
        self._m_cp_comp.inc(cp_pair["compressed"])
        if cp_pair.get("a2a_dense"):
            self.stats["cp_comm_a2a_dense_bytes"] += cp_pair["a2a_dense"]
            self.stats["cp_comm_a2a_compressed_bytes"] += (
                cp_pair["a2a_compressed"])
            self._m_cp_a2a_dense.inc(cp_pair["a2a_dense"])
            self._m_cp_a2a_comp.inc(cp_pair["a2a_compressed"])

    def _set_shard_gauges(self) -> None:
        for r, free in enumerate(self.pool.free_pages_by_rank()):
            self._m_cp_shard_free.set(free, shard=str(r))

    def step(self) -> int:
        served = super().step()
        self._set_shard_gauges()
        return served
