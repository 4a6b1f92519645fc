"""Sequence-striped page allocator for context-parallel serving (a
copy of megatron_tpu/inference/context_parallel/pool.py over the port's
PagePool).

Same host-side contract as inference/paging/pool.PagePool (all-or-
nothing alloc, refcounts, scratch page 0), plus one invariant the CP
attention island depends on: **logical page l of any sequence lives on
CP rank ``l % cp``**. The global page-id space [0, num_pages) is split
into cp contiguous ranges of ``num_pages // cp`` ids; rank r owns
global ids [r*npl, (r+1)*npl). ``alloc(n, logical_start)`` draws page j
of the run from the free list of rank ``(logical_start + j) % cp``, so
a freshly-allocated table row is striped by construction — and every
radix-cache hit re-uses pages that were inserted from striped rows, so
shared prefixes keep the invariant for free.

The scratch page (global 0) sits in rank 0's range; ranks r > 0 map
unallocated/out-of-span table entries to a per-rank sentinel instead
(the local-table builder in engine.py).
"""

from __future__ import annotations

from typing import List, Optional

from megatron_tpu_torch.inference.paging.pool import PagePool


class StripedPagePool(PagePool):
    """PagePool whose free space is partitioned by owning CP rank."""

    def __init__(self, num_pages: int, cp: int):
        if cp < 1:
            raise ValueError(f"cp must be >= 1, got {cp}")
        if num_pages % cp:
            raise ValueError(
                f"num_pages {num_pages} must be a multiple of cp {cp} "
                "(equal per-rank pool shards)")
        super().__init__(num_pages)
        self.cp = cp
        self.pages_per_rank = num_pages // cp
        # re-home the flat LIFO free list into per-rank LIFO lists;
        # rank 0 loses one slot to the reserved scratch page
        npl = self.pages_per_rank
        self._free_by_rank: List[List[int]] = [
            [p for p in range((r + 1) * npl - 1, r * npl - 1, -1) if p != 0]
            for r in range(cp)
        ]
        self._free = None  # the flat list must never be touched again

    def owner(self, page: int) -> int:
        """CP rank whose pool shard holds this global page id."""
        return page // self.pages_per_rank

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free_by_rank)

    def free_pages_by_rank(self) -> List[int]:
        """Per-CP-rank free page counts (the per-shard gauges)."""
        return [len(f) for f in self._free_by_rank]

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    def alloc(self, n: int = 1,
              logical_start: int = 0) -> Optional[List[int]]:
        """n fresh pages honoring the striping invariant: page j of the
        run comes from rank ``(logical_start + j) % cp``. All-or-nothing
        — None when ANY needed rank's shard can't cover its share (the
        caller evicts/preempts and retries; there is deliberately no
        cross-rank fallback, a page on the wrong rank would be invisible
        to that rank's attention shard)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        need = [0] * self.cp
        for j in range(n):
            need[(logical_start + j) % self.cp] += 1
        if any(need[r] > len(self._free_by_rank[r]) for r in range(self.cp)):
            return None
        pages = []
        for j in range(n):
            p = self._free_by_rank[(logical_start + j) % self.cp].pop()
            self._refs[p] = 1
            pages.append(p)
        return pages

    def release(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to
        their OWNER rank's free list."""
        freed = 0
        for p in pages:
            if p == 0:  # SCRATCH_PAGE
                continue
            if self._refs[p] <= 0:
                raise ValueError(f"release of free page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free_by_rank[self.owner(p)].append(p)
                freed += 1
        return freed
