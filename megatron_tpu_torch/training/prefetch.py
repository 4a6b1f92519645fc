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
    a batch that is already on the card;
  * reuses a ring of pinned host buffers, depth + 2 batches of them,
    instead of pinning fresh memory per array per batch (a new pinned
    block is a cudaHostAlloc whenever the caching host allocator has no
    free block of the size); a slot is refilled only after the event of
    the copies that last read it.

Each pop records ``last_pop``: the queue's fill before the pop, the
queue get's wait, the hand-off to the compute stream, and the worker's
pin-and-issue and landing times of that batch;
the train loop keeps them in its per-step records (the attribution of
the pop's wait).

The worker stays off the interpreter lock while the loop pops and
dispatches a step: it starts a batch only on a permit. The loop gives
one back with ``release()`` after it has dispatched a step, just before
the step's first blocking read, so the worker's fetch, pin and issue
run while the loop's thread waits on the card with the lock released,
instead of waking the moment a pop frees a queue slot. The first step
is the exception: under a metrics lag nothing is read after its
dispatch, so its permit would run the worker into the next pop. That
permit is granted at the start instead, with the ``depth`` that fill the
queue (the batch it makes waits in the queue's put until the first pop),
and the first ``release()`` is spent on it. A pop that finds the queue
empty and no permit outstanding grants one itself, so a consumer that
never releases still gets every batch (one at a time).

A landed batch's device tensors are allocated on the constructing
thread's current stream (the loop's compute stream), the copies first
waiting for the work queued there, so the pop hands them over with no
stream call. With ``land=False`` the consumer makes its current stream
wait on the batch's event and calls ``record_stream`` on every tensor
it hands out, so the caching allocator never gives the memory, which
the copy stream allocated, to another tensor before the compute stream
is done with it. On the CPU a batch's tensors share the numpy arrays'
memory.

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
              stream: Optional["torch.cuda.Stream"] = None,
              pinned: Optional[Dict[str, torch.Tensor]] = None,
              consumer: Optional["torch.cuda.Stream"] = None
              ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device`. With a CUDA `stream`
    each array goes through a pinned host tensor and is copied
    asynchronously on that stream; without one the copy is the caller's
    stream's (synchronous from pageable memory). On the CPU no copy is
    made. pinned: reusable pinned buffers by key (the prefetcher's ring
    slot), refilled in place where the shape and dtype match; the
    caller makes sure no copy still reads them. consumer: allocate the
    device tensors on this stream (the one that will read them), and
    make the copies wait for the work already queued there, which may
    still read a block the allocator hands out again; the consumer then
    needs no record_stream once the copies have landed."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}
    if device.type != "cuda":
        return {k: t.to(device) for k, t in host.items()}
    if stream is None:
        return {k: t.to(device, non_blocking=True) for k, t in host.items()}
    out = {}
    if consumer is not None:
        with torch.cuda.stream(consumer):
            out = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                   for k, t in host.items()}
        stream.wait_stream(consumer)
    with torch.cuda.stream(stream):
        for k, t in host.items():
            buf = None if pinned is None else pinned.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if pinned is not None:
                    pinned[k] = buf
            buf.copy_(t)
            if consumer is not None:
                out[k].copy_(buf, non_blocking=True)
            else:
                out[k] = buf.to(device, non_blocking=True)
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
        # landed batches are allocated on the constructing thread's
        # stream (the loop's compute stream), so a pop on that stream
        # hands them over with no stream call at all
        self._consumer = (torch.cuda.current_stream(self.device)
                          if self.device.type == "cuda" and land else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._end = object()
        self._done = False
        # stats read by the consumer (single writer on the worker side;
        # a torn read of a float is harmless for telemetry)
        self.batches_put = 0
        self.put_s = 0.0        # pin + enqueue seconds (worker-side)
        self.land_s = 0.0       # waiting for the copies (worker-side)
        # the latest pop: fill (queue length before it), get_ms (the
        # queue get's wait), handoff_ms (the compute stream's wait on the
        # batch's event and record_stream), and the popped batch's
        # worker put_ms / land_ms
        self.last_pop: Dict[str, float] = {}
        self._ring_size = depth + 2
        # the worker's permits to start a batch, the first step's included,
        # and the release that permit stands for (the module docstring)
        self._permits = depth + 1
        self._prepaid = 1
        self._in_flight = False     # a permitted batch not yet queued
        self._permit_cv = threading.Condition()
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

    def _take_permit(self) -> bool:
        """Wait for a permit to start the next batch; False once close()
        stops the worker."""
        with self._permit_cv:
            while self._permits <= 0 and not self._stop.is_set():
                self._permit_cv.wait(0.1)
            if self._stop.is_set():
                return False
            self._permits -= 1
            self._in_flight = True
            return True

    def release(self) -> None:
        """Let the worker start one more batch: the train loop calls this
        once per pop, after dispatching the step (the first call is the
        permit granted at the start)."""
        with self._permit_cv:
            if self._prepaid:
                self._prepaid -= 1
                return
            self._permits += 1
            self._permit_cv.notify()

    def _worker(self):
        try:
            stream = None
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
            # [pinned buffers, event of the copies that last read them]
            ring = [[{}, None] for _ in range(self._ring_size)]
            source = iter(self._iterator)
            i = 0
            while True:
                if not self._take_permit():
                    return
                batch = next(source, self._end)
                if batch is self._end:
                    break
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    batch = self._transform(batch, self._first_iteration + i)
                t0 = time.perf_counter()
                slot = ring[i % self._ring_size]
                if slot[1] is not None:
                    slot[1].synchronize()
                device_batch = to_device(batch, self.device, stream,
                                         pinned=slot[0],
                                         consumer=self._consumer)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                    slot[1] = event
                t1 = time.perf_counter()
                if self._land and event is not None:
                    # land the copy in the worker so a pop hands the loop
                    # a batch on the card, not one in flight
                    event.synchronize()
                t2 = time.perf_counter()
                self.put_s += t1 - t0
                self.land_s += t2 - t1
                self.batches_put += 1
                stats = {"put_ms": (t1 - t0) * 1e3,
                         "land_ms": (t2 - t1) * 1e3}
                if not self._enqueue((device_batch, event, stats)):
                    return
                with self._permit_cv:
                    self._in_flight = False
                i += 1
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
        fill = self._q.qsize()
        if fill == 0:
            with self._permit_cv:
                if (self._permits <= 0 and not self._in_flight
                        and self._q.qsize() == 0):
                    # nothing queued, in flight or granted: the worker
                    # could never fill this pop
                    self._permits += 1
                    self._permit_cv.notify()
        t0 = time.perf_counter()
        item = self._q.get()
        get_ms = (time.perf_counter() - t0) * 1e3
        if item is self._end:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        device_batch, event, stats = item
        t1 = time.perf_counter()
        if event is not None and self._consumer is None:
            # the copies may still be in flight (land=False): the compute
            # stream waits for them, and record_stream keeps the memory,
            # which the copy stream allocated, from being handed to
            # another tensor before the compute stream is done with it
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in device_batch.values():
                t.record_stream(compute)
        self.last_pop = dict(stats, fill=fill, get_ms=get_ms,
                             handoff_ms=(time.perf_counter() - t1) * 1e3)
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
