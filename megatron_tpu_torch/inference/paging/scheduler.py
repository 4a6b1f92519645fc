"""Chunked-prefill queue: long prompts enter the cache chunk by chunk (a
copy of megatron_tpu/inference/paging/scheduler.py).

The slot engine prefills a whole prompt in one bucketed pass — a 2k-token
prompt stalls every active decode for the full prefill. The paged engine
instead admits the request immediately (slot + pages assigned) and
queues its prefill here; every engine tick runs AT MOST ONE chunk of
`chunk` tokens before the batched decode, so prefill work interleaves
with decode ticks and one long prompt can never stall the batch.

FIFO across requests: the oldest incomplete prefill finishes first
(chunks of one prompt are sequential anyway — chunk c+1 attends chunk
c's cache rows), which bounds time-to-first-token for the request at
the head of the line instead of spreading starvation evenly.

One difference from the JAX package: `key` is the saved state of the
request's torch.Generator (None for a greedy request), not a jax.random
key.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PrefillTask:
    """One request's remaining prefill work."""

    slot: int
    tokens: np.ndarray        # [p] int32 — the full logical prompt
    start: int                # first position to compute (prefix-cache skip)
    off: int                  # next chunk offset (start <= off <= p)
    # teacher-forced logprob pieces accumulated chunk by chunk
    # (host-side; assembled into Request.prompt_logprobs at completion)
    plp_parts: List[np.ndarray] = dataclasses.field(default_factory=list)
    # first position whose K/V write lands in a real page — positions
    # below it sit in prefix-cache-shared pages, so the overlap query's
    # write is fenced onto the scratch page (copy-on-write)
    write_start: int = 0
    # generator state the final chunk samples with: a generator seeded
    # with the request's seed for a fresh request, the state saved at
    # preemption for a resume; None for a greedy request (draws nothing)
    key: Optional[torch.Tensor] = None
    # resume of a preempted request: `tokens` is prompt + generated, the
    # recompute is teacher-forced, and prompt_logprobs/radix bookkeeping
    # for the original prompt already happened on the first admission
    resumed: bool = False
    # admission timestamp (monotonic) for the prefill-latency histogram
    t_start: float = 0.0

    @property
    def total(self) -> int:
        return int(len(self.tokens))

    @property
    def done(self) -> bool:
        return self.off >= self.total


class ChunkedPrefillQueue:
    def __init__(self, chunk: int):
        if chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
        self.chunk = int(chunk)
        self._tasks: deque[PrefillTask] = deque()

    def __len__(self) -> int:
        return len(self._tasks)

    @property
    def slots(self) -> set:
        """Slots currently mid-prefill (excluded from decode ticks)."""
        return {t.slot for t in self._tasks}

    def add(self, task: PrefillTask) -> None:
        if task.start >= task.total:
            raise ValueError(
                f"prefill task has nothing to compute (start {task.start} "
                f">= {task.total}); the prefix cache must leave at least "
                "the final prompt token to recompute")
        task.off = task.start
        self._tasks.append(task)

    def peek(self) -> Optional[PrefillTask]:
        """The task owed the next chunk (None when idle)."""
        return self._tasks[0] if self._tasks else None

    def advance(self, task: PrefillTask, n: int) -> bool:
        """Consume n computed tokens; True when the task completed (and
        was removed)."""
        task.off += n
        if task.done:
            self._tasks.remove(task)
            return True
        return False

    def drop_slot(self, slot: int) -> Optional[PrefillTask]:
        """Remove the task for a preempted/failed slot (None if that
        slot wasn't mid-prefill)."""
        for t in self._tasks:
            if t.slot == slot:
                self._tasks.remove(t)
                return t
        return None
