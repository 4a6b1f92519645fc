"""Goodput accounting: where did the wall-clock go, and was it training?
(counterpart of megatron_tpu/telemetry/goodput.py)

Goodput = productive step seconds / total wall seconds. Everything else
is attributed to a named stall category so regressions are diagnosable:

  productive        forward+backward+optimizer device time actually
                    advancing the model (warm-up subtracted)
  compile           the warm-up of a step function's first call
  data_wait         blocked on the input pipeline
  checkpoint_stall  train-loop stall of a save (async: barrier + host copy)
  rollback_replay   divergence rollback + fast-forward through the poison
                    window
  eval              validation loops
  other             unattributed remainder (loop overhead, logging, ...)

GoodputTracker is the JAX package's, line for line. RecompileTracker is
not: the JAX one listens to jax.monitoring's compile events, and eager
PyTorch has no compiler to listen to. Here the `compile` bucket holds
the first step's warm-up instead, i.e. the whole first call of each
step function (on the card: the flash kernels' build or load by
ops/flash/build.py, the first cuBLAS calls and the caching allocator's
first allocations), which the train loop reports through note_warmup().
Its `compiles` counter stays 0, and so does every cache counter: a
journal's step records carry `compile_ms` with `compiles: 0`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

#: canonical category names (journal `goodput` events and the report tool
#: rely on these strings)
CATEGORIES = ("productive", "compile", "data_wait", "checkpoint_stall",
              "rollback_replay", "eval", "other")


class GoodputTracker:
    """Wall-clock ledger over the categories above."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = clock()
        self._seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}

    def attribute(self, category: str, seconds: float) -> None:
        if category not in self._seconds:
            raise ValueError(
                f"unknown goodput category {category!r}; one of {CATEGORIES}")
        if seconds < 0:
            return
        with self._lock:
            self._seconds[category] += seconds

    class _Span:
        def __init__(self, tracker, category):
            self._tracker, self._category = tracker, category

        def __enter__(self):
            self._start = self._tracker._clock()
            return self

        def __exit__(self, *exc):
            self._tracker.attribute(
                self._category, self._tracker._clock() - self._start)
            return False

    def track(self, category: str) -> "GoodputTracker._Span":
        """with tracker.track("eval"): ..."""
        if category not in self._seconds:
            raise ValueError(
                f"unknown goodput category {category!r}; one of {CATEGORIES}")
        return self._Span(self, category)

    def report(self) -> Dict[str, float]:
        """{"wall_s", "goodput", per-category seconds, "other_s"} — other
        absorbs the unattributed remainder so the split always sums to
        wall (concurrent attributions, e.g. an async-checkpoint commit
        overlapping compute, can push the sum past wall; other floors at
        0 and goodput stays productive/wall either way)."""
        with self._lock:
            wall = max(self._clock() - self._t0, 1e-9)
            seconds = dict(self._seconds)
        attributed = sum(v for k, v in seconds.items() if k != "other")
        seconds["other"] += max(wall - attributed - seconds["other"], 0.0)
        out = {"wall_s": round(wall, 4),
               "goodput": round(seconds["productive"] / wall, 4)}
        for c in CATEGORIES:
            out[f"{c}_s"] = round(seconds[c], 4)
        return out


class RecompileTracker:
    """The JAX tracker's snapshot/delta interface over the warm-up the
    train loop reports (see the module docstring): compile_seconds sums
    note_warmup(); compiles, trace_seconds and the cache counters stay
    0, since eager PyTorch compiles nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_seconds = 0.0
        self.trace_seconds = 0.0
        self.cache_hits = 0
        self.cache_misses = 0

    def note_warmup(self, seconds: float) -> None:
        with self._lock:
            self.compile_seconds += max(float(seconds), 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"compiles": self.compiles,
                    "compile_seconds": self.compile_seconds,
                    "trace_seconds": self.trace_seconds,
                    "cache_hits": self.cache_hits,
                    "cache_misses": self.cache_misses}

    def delta(self, since: Dict[str, float]) -> Dict[str, float]:
        now = self.snapshot()
        return {k: now[k] - since[k] for k in now}


_tracker: Optional[RecompileTracker] = None
_tracker_lock = threading.Lock()


def recompile_tracker() -> RecompileTracker:
    """The process-wide tracker (the JAX package's accessor)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = RecompileTracker()
        return _tracker
