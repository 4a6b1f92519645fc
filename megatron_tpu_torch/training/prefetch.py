"""Pipelined host->device batch prefetch for the async train loop
(counterpart of megatron_tpu/training/prefetch.py).

The synchronous loop serializes three phases per iteration: host data
fetch (``next(data_iter)``), host->device copy, and the device step, so
the card idles while the host collates and copies. DevicePrefetcher is
a background thread that pulls host batches IN SAMPLER ORDER, copies
them to the device and keeps the landed tensors in a bounded queue:
step N+1's data is on the card while step N computes, and the loop's
queue pop is the only data cost left on its path (journaled as
``data_wait_ms``).

On a CUDA device the worker thread

  * calls torch.cuda.set_device, then copies each array from a pinned
    host tensor (``non_blocking`` from pageable memory would be a
    synchronous copy, hiding exactly what this module is for) on a CUDA
    stream of its own;
  * records one event per batch after its copies and, with ``land``
    (the default), waits for it on the worker, so a pop hands the loop
    a batch that is already on the card.

The consumer makes its current (compute) stream wait on that event and
calls ``record_stream`` on every tensor it hands out, so the caching
allocator never gives the memory, which the copy stream allocated, to
another tensor before the compute stream is done with it. On the CPU a
batch's tensors share the numpy arrays' memory.

Rollback/resume contract, as in the JAX package: the prefetcher NEVER
owns data-order state. The sampler order is a pure function of
``consumed_samples``, which only the train loop advances, one batch per
pop. On divergence rollback, epoch boundary or batch-size rampup the
loop ``close()``s the prefetcher, discarding everything in flight, and
builds a fresh one from ``train_iter_factory(consumed_samples, gbs)``.
``transform(batch, iteration)`` runs on the HOST copy before the copy
to the device, with the iteration the batch will be consumed at
(``first_iteration + i``), so fault injection poisons the batches the
synchronous loop would poison.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              stream: Optional["torch.cuda.Stream"] = None
              ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device`. With a CUDA `stream`
    each array goes through a pinned host tensor and is copied
    asynchronously on that stream; without one the copy is the caller's
    stream's (synchronous from pageable memory). On the CPU no copy is
    made."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
    if device.type != "cuda":
        return {k: t.to(device) for k, t in host.items()}
    if stream is None:
        return {k: t.to(device, non_blocking=True) for k, t in host.items()}
    out = {}
    with torch.cuda.stream(stream):
        for k, t in host.items():
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned.copy_(t)
            out[k] = pinned.to(device, non_blocking=True)
    return out


class DevicePrefetcher:
    """Bounded background host->device prefetcher over one iterator.

    Iterator protocol: ``next(pf, None)`` yields device batches in strict
    source order and ``None`` once the source iterator is exhausted (the
    plain host iterator's shape, so the train loop's epoch-boundary
    rebuild is path-independent). Exceptions raised by the source
    iterator, the transform or the copy surface on the consuming thread.
    """

    def __init__(
        self,
        iterator: Iterator[Dict[str, np.ndarray]],
        device,
        depth: int = 2,
        first_iteration: int = 1,
        transform: Optional[Callable[[Dict[str, np.ndarray], int],
                                     Dict[str, np.ndarray]]] = None,
        land: bool = True,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._iterator = iterator
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the constructing thread's current card; the worker sets it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._transform = transform
        self._first_iteration = int(first_iteration)
        self._land = land
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._end = object()
        self._done = False
        # stats read by the consumer (single writer on the worker side;
        # a torn read of a float is harmless for telemetry)
        self.batches_put = 0
        self.put_s = 0.0        # pin + enqueue seconds (worker-side)
        self.land_s = 0.0       # waiting for the copies (worker-side)
        self._thread = threading.Thread(
            target=self._worker, name="batch-prefetcher", daemon=True)
        self._thread.start()

    # -- worker side ---------------------------------------------------------

    def _enqueue(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            stream = None
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
            for i, batch in enumerate(self._iterator):
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    batch = self._transform(batch, self._first_iteration + i)
                t0 = time.perf_counter()
                device_batch = to_device(batch, self.device, stream)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                t1 = time.perf_counter()
                if self._land and event is not None:
                    # land the copy in the worker so a pop hands the loop
                    # a batch on the card, not one in flight
                    event.synchronize()
                t2 = time.perf_counter()
                self.put_s += t1 - t0
                self.land_s += t2 - t1
                self.batches_put += 1
                if not self._enqueue((device_batch, event)):
                    return
            self._enqueue(self._end)
        except BaseException as e:  # noqa: BLE001 - worker thread: every
            # failure (incl. KeyboardInterrupt) must surface on the
            # consuming thread, not die silently here
            self._enqueue(e)

    # -- consumer side -------------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Dict[str, Any]:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._end:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        device_batch, event = item
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in device_batch.values():
                t.record_stream(compute)
        return device_batch

    def close(self) -> None:
        """Stop the worker and discard everything in flight (idempotent).

        The loop calls this on rollback / epoch / rampup boundaries and
        rebuilds from a fresh iterator at its consumed_samples watermark;
        queued batches are dropped, never consumed."""
        self._stop.set()
        # unblock a worker parked on a full queue
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
