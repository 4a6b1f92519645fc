"""Named span timers (a copy of megatron_tpu/training/timers.py).

Hierarchical named timers with a log-level gate and elapsed reporting,
the same Timers, levels and log_string format as the JAX package. A span
measures the host clock: around work queued on the card it measures the
enqueue unless the span's caller synchronizes. The train loop does that
where the JAX loop blocks: the `batch-transfer` span waits for the copy
only at --timing_log_level >= 1, and `forward-backward-optimizer` holds
the metrics read in the synchronous loop. The deep profiling story is
torch.profiler's trace window (training/pretrain.py, --profile).
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self._count = 0
        self._last = 0.0

    def start(self):
        if self._start is not None:
            raise RuntimeError(f"timer {self.name} already started")
        self._start = time.perf_counter()

    def stop(self):
        if self._start is None:
            raise RuntimeError(f"timer {self.name} not started")
        self._last = time.perf_counter() - self._start
        self._elapsed += self._last
        self._count += 1
        self._start = None

    def elapsed(self, reset: bool = True) -> float:
        running = self._start is not None
        if running:
            self.stop()
        out = self._elapsed
        if reset:
            self._elapsed = 0.0
            self._count = 0
        if running:
            self.start()
        return out


    def last(self) -> float:
        """Duration of the most recently completed span (not reset by
        elapsed() — the telemetry journal reads per-step spans while the
        log-interval window keeps accumulating)."""
        return self._last


class _DummyTimer:
    def start(self):
        pass

    def stop(self):
        pass

    def elapsed(self, reset: bool = True) -> float:
        return 0.0

    def last(self) -> float:
        return 0.0


class Timers:
    """timers('span', level)(start/stop); below-threshold spans are no-ops
    (ref: Timers with --timing_log_level).

    Span truthfulness: a start/stop pair measures host wall-clock only, so
    a span around work queued on the card (a copy, a kernel launch)
    measures the ENQUEUE, not the work. Spans that must cover the work
    either sync inside the span (the train loop's `batch-transfer` span
    holds a stream synchronize; `forward-backward-optimizer` holds the
    metrics host-fetch in the synchronous loop) or are split into an honest
    dispatch span plus a landed/completion span credited via record() from
    wherever the completion is actually observed (the async loop's
    prefetcher measures transfer time on its worker thread and the loop
    credits it at pop time; the lagged metrics fetch is recorded as
    `metrics-fetch`)."""

    def __init__(self, log_level: int = 0):
        self.log_level = log_level
        self._timers: Dict[str, _Timer] = {}
        self._dummy = _DummyTimer()

    def __call__(self, name: str, level: int = 0):
        if level > self.log_level:
            return self._dummy
        if name not in self._timers:
            self._timers[name] = _Timer(name)
        return self._timers[name]

    def record(self, name: str, seconds: float, level: int = 0) -> None:
        """Credit an externally measured duration as one completed span of
        `name` (level-gated like __call__). For spans whose wall-clock is
        observed somewhere a start/stop pair cannot reach: another thread
        (the prefetcher's device transfers) or a pipelined completion (the
        async loop's lagged metrics fetch). Must be called from the loop
        thread — _Timer is not thread-safe."""
        if level > self.log_level or seconds < 0:
            return
        if name not in self._timers:
            self._timers[name] = _Timer(name)
        t = self._timers[name]
        t._last = seconds
        t._elapsed += seconds
        t._count += 1

    def elapsed_ms(self, names=None, reset: bool = True) -> Dict[str, float]:
        """{span: accumulated ms since last reset} (for writer scalars)."""
        names = names if names is not None else sorted(self._timers)
        return {n: self._timers[n].elapsed(reset) * 1000.0
                for n in names if n in self._timers}

    def last_s(self, name: str) -> float:
        """Most recent completed span of `name` in SECONDS (0.0 for a
        never-stopped or below-log-level timer) — per-step telemetry."""
        t = self._timers.get(name)
        return t.last() if t is not None else 0.0

    def log_string(self, names=None, normalizer: float = 1.0,
                   reset: bool = True) -> str:
        names = names if names is not None else sorted(self._timers)
        parts = []
        for n in names:
            if n in self._timers:
                ms = self._timers[n].elapsed(reset) * 1000.0 / normalizer
                parts.append(f"{n}: {ms:.2f}")
        return "time (ms) | " + " | ".join(parts) if parts else ""
