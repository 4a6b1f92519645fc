"""Deterministic data-parallel samplers + a numpy batch loader.

(A copy of megatron_tpu/data/samplers.py with its imports rewritten.)

Equivalent of megatron/data/data_samplers.py (187 LoC). The reference wraps
torch DataLoader; here the loader is a plain Python iterator producing
numpy dicts — device placement happens at the train loop where shardings
are known. Resume-exactness contract is identical: the sampler is a pure
function of consumed_samples, so restoring that one integer reproduces the
data order (ref: data_samplers.py:49-95 and checkpoint consumed_samples).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class PretrainingSampler:
    """Sequential sampler: each global batch is a contiguous range of
    sample ids; this DP rank takes its slice."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True):
        if total_samples <= 0:
            raise ValueError("no samples to consume")
        if data_parallel_rank >= data_parallel_size:
            raise ValueError("data_parallel_rank out of range")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[list]:
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_dp:
                start = self.dp_rank * self.micro_batch_size
                yield batch[start:start + self.micro_batch_size]
                batch = []
        if batch and not self.drop_last:
            start = self.dp_rank * self.micro_batch_size
            yield batch[start:start + self.micro_batch_size]


class PretrainingRandomSampler:
    """Epoch-seeded random order with exact resume inside an epoch
    (ref: MegatronPretrainingRandomSampler).

    Elastic-resume caveat: the epoch size, per-rank bucket partition,
    and permutation are all functions of micro_batch_size * dp_size, so
    the random ORDER is only invariant across a topology change when the
    sampler is driven at GLOBAL-batch granularity — which is how the
    entry points use it (pretrain_gpt.py passes the whole global batch
    as micro_batch_size with data_parallel_size=1, the single-controller
    shape). Per-rank constructions (micro_batch_size=per-rank share,
    data_parallel_size=dp) re-partition the buckets when dp changes and
    do NOT preserve sample order; the sequential PretrainingSampler is
    order-invariant either way."""

    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, seed: int = 1234):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.micro_batch_times_dp = micro_batch_size * data_parallel_size
        self.last_batch_size = self.total_samples % self.micro_batch_times_dp
        self.seed = seed

    def __iter__(self) -> Iterator[list]:
        active_total = self.total_samples - self.last_batch_size
        epoch = self.consumed_samples // active_total
        current_epoch_samples = self.consumed_samples % active_total
        if current_epoch_samples % self.micro_batch_times_dp:
            # a real error, not an assert (stripped under -O): resuming
            # with a batch geometry that doesn't divide the restored
            # consumed_samples watermark would silently misalign the
            # random order — the elastic-resume contract is that the
            # GLOBAL batch (and hence the watermark granularity) stays
            # invariant across topology changes
            raise ValueError(
                f"consumed_samples={self.consumed_samples} is not a "
                f"multiple of micro_batch*dp={self.micro_batch_times_dp} "
                "within the epoch — the resumed batch geometry does not "
                "match the one the watermark was written with (keep "
                "global_batch_size invariant across topology changes)")

        bucket_size = (active_total // self.micro_batch_times_dp) \
            * self.micro_batch_size
        bucket_offset = current_epoch_samples // self.dp_size
        start = self.dp_rank * bucket_size

        g = np.random.RandomState(self.seed + epoch)
        random_idx = g.permutation(bucket_size) + start
        idx_range = random_idx[bucket_offset:]

        batch = []
        for idx in idx_range:
            batch.append(int(idx))
            if len(batch) == self.micro_batch_size:
                yield batch
                batch = []


def build_data_loader(
    dataset,
    sampler,
    collate_fn=None,
    prefetch: int = 2,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield collated numpy batches for ONE pass over the sampler; the
    train loop rebuilds the loader at epoch/rampup boundaries (sampler
    order is a pure function of consumed_samples, advanced by the caller).

    prefetch > 0 runs dataset access + collation on a background thread
    with a bounded queue, overlapping host input work with device steps —
    the stand-in for the reference's torch DataLoader
    worker pool (--num_workers; order and determinism are unchanged,
    batches are produced strictly in sampler order). prefetch=0 is the
    plain synchronous path. Closing/abandoning the iterator stops the
    worker thread (generator finalization sets the stop flag).
    """
    def default_collate(items):
        out: Dict[str, np.ndarray] = {}
        for k in items[0]:
            out[k] = np.stack([it[k] for it in items])
        return out

    collate = collate_fn or default_collate

    if prefetch <= 0:
        for idx_batch in sampler:
            yield collate([dataset[i] for i in idx_batch])
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    _END = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for idx_batch in sampler:
                if not _put(collate([dataset[i] for i in idx_batch])):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 - worker thread: every
            # failure (incl. KeyboardInterrupt) must surface on the
            # consuming thread, not die silently here
            _put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
