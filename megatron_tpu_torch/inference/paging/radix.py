"""Radix tree over token IDs at page granularity (a copy of
megatron_tpu/inference/paging/radix.py).

Requests that share a prompt prefix should share the K/V pages that
prefix produced instead of recomputing them — the dominant prefill cost
for shared-system-prompt traffic. The tree maps token-ID paths (in
whole-page steps of `page_size` tokens) to physical page ids in the
PagePool; a lookup walks the request's prompt and returns the longest
fully-matched run of pages, which the engine aliases into the new
slot's page table (one pool.retain per sharer).

Sharing is safe because shared pages are READ-ONLY by construction —
copy-on-write semantics: a slot never writes through its table into a
page the cache (or another slot) also references. The engine enforces
this two ways: (1) only FULL pages enter the tree, so the partially
filled tail page a sequence appends to during decode is always private;
(2) the first recomputed chunk after a hit starts one position inside
the shared span (to recompute the boundary token's teacher-forced
logprob exactly) and fences that overlap write onto the scratch page
(transformer.attention_block page_write_start). Divergence after the
shared span lands in freshly allocated pages — the "copy" of
copy-on-write is recomputation into a private page, never an in-place
edit of a shared one.

Each node also carries the teacher-forced logprobs of its page's tokens
(logprob of token t given tokens[0..t-1] depends only on the node's own
path, so it is as cacheable as the K/V), letting a cache hit return the
same prompt_logprobs a full prefill would.

Eviction is LRU over leaf nodes whose page no live slot references
(pool refcount 1 = the cache's own ref): under memory pressure the
engine asks for n pages back, oldest-touched leaves first; freeing a
leaf can expose its parent as the next candidate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from megatron_tpu_torch.inference.paging.pool import PagePool


class _Node:
    __slots__ = ("key", "page", "lp", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int, lp: np.ndarray,
                 parent: Optional["_Node"]):
        self.key = key          # this page's page_size token ids
        self.page = page        # physical page id (cache holds one ref)
        self.lp = lp            # teacher-forced logprobs of this span
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = int(page_size)
        self._children: Dict[Tuple[int, ...], _Node] = {}  # root level
        self._clock = 0
        self._nodes = 0

    def __len__(self) -> int:
        return self._nodes

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def lookup(self, tokens: Sequence[int]
               ) -> Tuple[List[int], List[np.ndarray]]:
        """Longest fully-cached whole-page prefix of `tokens`:
        (physical pages, per-page logprob arrays). The caller aliases
        the pages (pool.retain) — the cache's own references are
        untouched."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        pages: List[int] = []
        lps: List[np.ndarray] = []
        level = self._children
        for off in range(0, (len(toks) // ps) * ps, ps):
            node = level.get(tuple(toks[off:off + ps]))
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            lps.append(node.lp)
            level = node.children
        return pages, lps

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               logprobs: Sequence[float]) -> int:
        """Register a computed prefix: full page m of `tokens` maps to
        pages[m]. logprobs[t-1] is the teacher-forced logprob of
        tokens[t] (the engine's prompt_logprobs layout). Pages already in
        the tree are skipped (the existing copy stays authoritative);
        new nodes retain their page in the pool. Returns the number of
        nodes added."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        n_pages = min(len(toks) // ps, len(pages))
        level = self._children
        parent: Optional[_Node] = None
        added = 0
        for m in range(n_pages):
            key = tuple(toks[m * ps:(m + 1) * ps])
            node = level.get(key)
            if node is None:
                # lp for token positions [m*ps, (m+1)*ps) — position 0
                # has no logprob, so page 0's slice starts at index 0 of
                # the (position-1)-indexed logprob row
                lo = max(m * ps, 1)
                lp = np.asarray(logprobs[lo - 1:(m + 1) * ps - 1],
                                np.float32)
                node = _Node(key, int(pages[m]), lp, parent)
                self.pool.retain([node.page])
                level[key] = node
                self._nodes += 1
                added += 1
            self._touch(node)
            parent = node
            level = node.children
        return added

    def _evictable(self) -> List[_Node]:
        """Leaves whose page only the cache references, LRU first."""
        out = []

        def walk(level):
            for node in level.values():
                if node.children:
                    walk(node.children)
                elif self.pool.refcount(node.page) == 1:
                    out.append(node)

        walk(self._children)
        out.sort(key=lambda n: n.last_used)
        return out

    def evict(self, n_pages: int) -> int:
        """Release up to n_pages cache-only pages back to the pool,
        strictly LRU: candidates are re-derived after every removal,
        because freeing a leaf can expose its parent as an OLDER
        candidate than the next stale leaf. Returns how many pages were
        actually freed."""
        freed = 0
        while freed < n_pages:
            cands = self._evictable()
            if not cands:
                break
            self._remove(cands[0])
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every node (engine cache-rebuild path). Returns pages
        released."""
        released = 0

        def walk(level):
            nonlocal released
            for node in level.values():
                walk(node.children)
                self.pool.release([node.page])
                released += 1

        walk(self._children)
        self._children = {}
        self._nodes = 0
        return released

    def _remove(self, node: _Node) -> None:
        level = (node.parent.children if node.parent is not None
                 else self._children)
        del level[node.key]
        self.pool.release([node.page])
        self._nodes -= 1
