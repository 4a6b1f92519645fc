"""Crash-safe structured event journal: append-only JSONL with rotation.

A copy of megatron_tpu/telemetry/journal.py (host code with no jax in
it), kept here so the port imports nothing of the JAX package: the same
event kinds, fields and rotation, so read_events reads either package's
journal.

One line per event: {"ts": <unix seconds>, "kind": "<event kind>", ...}.
The journal is the flight-data-recorder of a run — per-step records, the
goodput ledger, checkpoint/rollback/fault events — and its value is
precisely that it survives the crash that killed the process, so:

  * every emit() is write+flush of ONE line (the OS file buffer, not a
    library buffer, owns durability; fsync per step would serialize the
    train loop on disk latency for no recovery value — a lost final line
    is exactly what replay tolerates anyway);
  * a torn final line (SIGKILL mid-write) is expected, not corruption:
    read_events() parses what it can and reports the tail as truncated;
  * rotation renames the live file to `<name>.1` (shifting older
    segments up) so the journal is O(max_bytes * keep) on disk for an
    unbounded run, and replay can walk segments newest-first.

Thread-safe: emit() may be called from the train loop, the checkpoint
finalizer thread, and the flight-recorder watchdog concurrently.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

JOURNAL_NAME = "events.jsonl"


class EventJournal:
    """Append-only JSONL event sink with size-based rotation."""

    def __init__(self, path: str, max_bytes: int = 64 * (1 << 20),
                 keep_segments: int = 2):
        """path may be a directory (the canonical `events.jsonl` is created
        inside) or an explicit file path. max_bytes <= 0 disables
        rotation; keep_segments older segments are retained."""
        if not path:
            raise ValueError("journal path must be non-empty")
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, JOURNAL_NAME)
        self.path = os.path.abspath(path)
        self.max_bytes = int(max_bytes)
        self.keep_segments = max(int(keep_segments), 1)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._f: Optional[io.TextIOWrapper] = None
        self._open()

    def _open(self):
        self._f = open(self.path, "a", encoding="utf-8")

    # -- write --------------------------------------------------------------

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        """Append one event; returns the record written. Never raises on a
        full/unwritable disk — the journal must not take the run down with
        it (the failure is reported once on stderr)."""
        rec = {"ts": round(time.time(), 6), "kind": str(kind)}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            try:
                if (self.max_bytes > 0 and self._f is not None
                        and self._f.tell() + len(line) + 1 > self.max_bytes):
                    self._rotate_locked()
                if self._f is not None:
                    self._f.write(line + "\n")
                    self._f.flush()
            except OSError as e:  # pragma: no cover - disk-full path
                self._report_write_error(e)
        return rec

    _write_error_reported = False

    def _report_write_error(self, e: OSError):
        if not EventJournal._write_error_reported:
            EventJournal._write_error_reported = True
            import sys

            print(f"telemetry journal write failed ({e}); further events "
                  "to this journal may be lost", file=sys.stderr)

    def _rotate_locked(self):
        self._f.close()
        self._f = None
        for i in range(self.keep_segments, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            dst = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        self._open()

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -- read ---------------------------------------------------------------

    def segments(self) -> List[str]:
        """Existing journal files, oldest first (…, .2, .1, live)."""
        out = []
        for i in range(self.keep_segments, 0, -1):
            p = f"{self.path}.{i}"
            if os.path.exists(p):
                out.append(p)
        if os.path.exists(self.path):
            out.append(self.path)
        return out

    def events(self) -> List[Dict[str, Any]]:
        """Replay every event across segments, oldest first."""
        out: List[Dict[str, Any]] = []
        for seg in self.segments():
            evs, _ = read_events(seg)
            out.extend(evs)
        return out

    def tail(self, n: int) -> List[Dict[str, Any]]:
        """The last n events (cross-segment), oldest first."""
        out: List[Dict[str, Any]] = []
        for seg in reversed(self.segments()):
            evs, _ = read_events(seg)
            out = evs[-(n - len(out)):] + out if len(evs) else out
            if len(out) >= n:
                return out[-n:]
        return out


def read_events(path: str) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """(events, truncated_tail) for one journal file.

    A torn final line — the expected signature of a crash mid-write — is
    returned as truncated_tail rather than raising; a torn line ANYWHERE
    else would mean real corruption and still only skips that line (the
    journal is diagnostics: salvage beats purity)."""
    events: List[Dict[str, Any]] = []
    truncated: Optional[str] = None
    if not os.path.exists(path):
        return events, truncated
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.read().split("\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            truncated = line
    return events, truncated


def _jsonable(v: Any) -> Any:
    """Journal fields come from torch/numpy scalars as often as floats."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:  # noqa: BLE001 - non-scalar array etc.
            pass
    return str(v)


# -- process-global journal ---------------------------------------------------
#
# Low-dependency emit point for modules that must not own telemetry wiring
# (training/resilience.py fault injection): the train loop installs its
# journal here; emitters no-op when none is installed.

_global: Optional[EventJournal] = None
_global_lock = threading.Lock()


def set_global_journal(journal: Optional[EventJournal]) -> None:
    global _global
    with _global_lock:
        _global = journal


def get_global_journal() -> Optional[EventJournal]:
    with _global_lock:
        return _global
