"""Free-list page allocator with refcounts (a copy of
megatron_tpu/inference/paging/pool.py).

Host-side bookkeeping only — the physical pages live in the device
pools (``[layers, num_pages, page_size, kv_heads, head_dim]``); this
class decides which page index a logical block maps to. Page 0 is
reserved as the SCRATCH page: unallocated page-table entries point at
it, so out-of-range writes (padded prefill-chunk tails, decode writes
of idle slots) land somewhere harmless and reads of it are always
masked off by the valid-prefix length.

Refcounts make sharing safe: a slot's table and the radix prefix cache
each hold one reference per page they map; a page returns to the free
list only when the last holder releases it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

SCRATCH_PAGE = 0


class PagePool:
    """Fixed-capacity page allocator (page ids ``1..num_pages-1``)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved scratch "
                f"page), got {num_pages}")
        self.num_pages = num_pages
        # LIFO free list: recently-released pages are re-used first (their
        # contents are dead by construction — refcount reached zero)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n fresh pages with refcount 1 each, or None when the pool
        can't cover the request (caller evicts/preempts and retries) —
        all-or-nothing, so a partial grab never leaks."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: Iterable[int]) -> None:
        """Add one reference per page (a new table row / radix node maps
        an already-live page)."""
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            if self._refs[p] <= 0:
                raise ValueError(f"retain of free page {p}")
            self._refs[p] += 1

    def release(self, pages: Iterable[int]) -> int:
        """Drop one reference per page; pages reaching zero return to
        the free list. Returns how many were actually freed."""
        freed = 0
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            if self._refs[p] <= 0:
                raise ValueError(f"release of free page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed
