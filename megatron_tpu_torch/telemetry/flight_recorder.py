"""Flight recorder: a heartbeat watchdog that turns a silent hang into a
diagnosable bundle.

A copy of megatron_tpu/telemetry/flight_recorder.py (host code with no
jax in it), kept here so the port imports nothing of the JAX package.

PR 2 made crashes safe (atomic checkpoints, auto-fallback resume) but a
HANG — a wedged collective, a deadlocked host callback, an engine step
loop stuck on a device transfer — leaves nothing: the process sits there
until the scheduler kills it, and the kill destroys the evidence. The
flight recorder closes that gap:

  * the owning loop arms it and calls heartbeat() once per train step /
    engine tick;
  * a daemon watchdog thread checks the heartbeat age; past `deadline_s`
    it writes a bundle directory:
      - meta.json        last heartbeat (age, note, count), deadline, pid
      - stacks.txt       every thread's Python stack (sys._current_frames)
      - events.jsonl     the last N journal events (the steps leading in)
  * then either keeps watching (default) or SIGABRTs the process
    (`abort=True`) so a supervisor restarts it with the bundle on disk —
    the moral equivalent of a kernel crash dump.

The watchdog never fires while stopped/disarmed (checkpointed exits,
engine shutdown) and fires at most once per stall (re-arms only after a
fresh heartbeat), so a long diagnosed stall produces one bundle, not one
per poll interval.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Optional

from megatron_tpu_torch.telemetry.journal import EventJournal


def dump_all_stacks() -> str:
    """Every live thread's Python stack, main thread first."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    chunks = []
    order = sorted(frames, key=lambda i: (by_ident.get(i) is None,
                                          by_ident.get(i) is not threading.main_thread()))
    for ident in order:
        t = by_ident.get(ident)
        name = t.name if t is not None else f"unknown-{ident}"
        daemon = " daemon" if (t is not None and t.daemon) else ""
        chunks.append(f"--- thread {name} (ident {ident}{daemon}) ---")
        chunks.append("".join(traceback.format_stack(frames[ident])).rstrip())
    return "\n".join(chunks) + "\n"


class FlightRecorder:
    """Stall watchdog with heartbeat + bundle dump."""

    def __init__(self, out_dir: str, deadline_s: float,
                 journal: Optional[EventJournal] = None,
                 tail_events: int = 200, abort: bool = False,
                 poll_s: Optional[float] = None, log=print):
        if deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        self.out_dir = os.path.abspath(out_dir)
        self.deadline_s = float(deadline_s)
        self.journal = journal
        self.tail_events = int(tail_events)
        self.abort = bool(abort)
        # poll fast enough that a stall is detected within ~1.25x deadline
        self.poll_s = float(poll_s) if poll_s else max(deadline_s / 4, 0.05)
        self.log = log
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._beat_count = 0
        self._note = "armed (watchdog live from the first heartbeat)"
        self._fired_for_beat = -1  # at most one bundle per stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.bundles = []  # paths of written bundles (tests, reporting)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FlightRecorder":
        """Spawn the watchdog. The deadline clock only starts at the
        FIRST heartbeat: the window between arming and the first step —
        which contains the first step's warm-up (the kernels' build or
        load) — must not be judged against a deadline sized for
        steady-state steps (a false fire there with abort=True would
        crash-loop a healthy process through warm-up after warm-up)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="flight-recorder")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.poll_s * 4 + 5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- heartbeat ----------------------------------------------------------

    def heartbeat(self, note: str = "") -> None:
        """Record liveness; called once per step/tick by the owning loop."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._beat_count += 1
            if note:
                self._note = note

    # -- watchdog -----------------------------------------------------------

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                age = time.monotonic() - self._last_beat
                beat = self._beat_count
                fired = self._fired_for_beat
            if beat == 0:  # not live until the first heartbeat (start())
                continue
            if age < self.deadline_s or beat == fired:
                continue
            try:
                path = self.dump(reason=f"no heartbeat for {age:.1f}s "
                                        f"(deadline {self.deadline_s:.1f}s)")
                self.log(f"flight recorder: stall detected — bundle written "
                         f"to {path}")
            except Exception as e:  # noqa: BLE001 - the watchdog must
                # survive a full disk; a dead watchdog is a silent hang
                self.log(f"flight recorder: bundle dump FAILED: {e}")
            with self._lock:
                self._fired_for_beat = beat
            if self.abort:
                self.log("flight recorder: aborting (SIGABRT) so the "
                         "supervisor restarts this process with the bundle "
                         "on disk")
                # flush whatever the journal buffered before dying
                if self.journal is not None:
                    try:
                        self.journal.flush()
                    except OSError:
                        pass
                os.kill(os.getpid(), signal.SIGABRT)

    def dump(self, reason: str = "manual") -> str:
        """Write one bundle dir; returns its path. Public so crash paths
        (signal handlers, except blocks) can force a dump."""
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(self.out_dir, f"flight-{ts}-pid{os.getpid()}")
        # a second stall in the same second must not clobber the first
        suffix = 0
        final = path
        while os.path.exists(final):
            suffix += 1
            final = f"{path}.{suffix}"
        os.makedirs(final, exist_ok=True)
        with self._lock:
            meta = {
                "reason": reason,
                "pid": os.getpid(),
                "deadline_s": self.deadline_s,
                "heartbeat_age_s": round(
                    time.monotonic() - self._last_beat, 3),
                "heartbeat_count": self._beat_count,
                "last_note": self._note,
                "abort": self.abort,
                "ts": time.time(),
            }
        with open(os.path.join(final, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(final, "stacks.txt"), "w") as f:
            f.write(dump_all_stacks())
        if self.journal is not None:
            events = self.journal.tail(self.tail_events)
            with open(os.path.join(final, "events.jsonl"), "w") as f:
                for ev in events:
                    f.write(json.dumps(ev, separators=(",", ":")) + "\n")
        self.bundles.append(final)
        return final
