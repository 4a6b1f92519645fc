"""Paged KV-cache serving: block pool + radix prefix cache + chunked
prefill (counterpart of megatron_tpu/inference/paging/).

The slot engine (inference/engine.py) reserves `max_seq_len` cache rows
per slot up front — a young sequence in a long cache wastes almost all
of them, and two requests sharing a system prompt each recompute and
store it. This package replaces the per-slot reservation with a shared
pool of fixed-size pages:

  * :mod:`pool` — the free-list page allocator with refcounts. KV
    storage becomes ``[layers, num_pages, page_size, kv_heads, head_dim]``
    and each slot holds an int32 page table mapping logical blocks to
    physical pages.
  * :mod:`radix` — a radix tree over token IDs at page granularity:
    requests sharing a prompt prefix map their tables onto the same
    refcounted pages and skip prefill for the shared span.
  * :mod:`scheduler` — the chunked-prefill queue: long prompts enter the
    cache `prefill_chunk` tokens per engine tick, interleaved with the
    batched decode, so one long prompt can never stall the batch.
  * :mod:`engine` — :class:`PagedInferenceEngine`, the paged mode of the
    serving engine (``--serve_kv_paging``).

The decode attention path reads through the table: the paged
flash-decode kernel (csrc/flash_decode.cu, wrapper
ops/flash/flash_template.py paged_flash_decode) resolves pages on the
card; a prefill chunk, and every path on the CPU, gathers the pages
into a dense view (ops/attention.py).
"""

from megatron_tpu_torch.inference.paging.engine import PagedInferenceEngine
from megatron_tpu_torch.inference.paging.pool import PagePool
from megatron_tpu_torch.inference.paging.radix import RadixPrefixCache
from megatron_tpu_torch.inference.paging.scheduler import ChunkedPrefillQueue

__all__ = [
    "PagedInferenceEngine",
    "PagePool",
    "RadixPrefixCache",
    "ChunkedPrefillQueue",
]
