"""Graceful-exit signal handling (a copy of
megatron_tpu/training/signal_handler.py, single host).

The handler records the signal and nothing more: the train loop polls it
between steps and checkpoints, then exits, on its own thread. SIGTERM
(the cluster scheduler's preemption notice) and SIGINT (a human) are
handled by default, the handler records which arrived and when, and a
SECOND signal of any handled kind force-exits at once via os._exit with
the conventional 128+signum, so a checkpoint flush wedged on a dead
filesystem can never block termination forever.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from types import FrameType
from typing import Optional, Sequence, Tuple


class DistributedSignalHandler:
    def __init__(self, sig: Optional[int] = None,
                 signals: Optional[Sequence[int]] = None):
        """signals: which to trap (default SIGTERM + SIGINT); the legacy
        single-signal `sig` kwarg is kept for callers that trap one."""
        if signals is None:
            signals = (sig,) if sig is not None else (signal.SIGTERM,
                                                      signal.SIGINT)
        self.signals: Tuple[int, ...] = tuple(signals)
        self.sig = self.signals[0]  # backward-compat attribute
        self._received: list = []
        self._received_at: list = []
        self._prev: dict = {}

    def signals_received(self) -> Tuple[int, ...]:
        """Signal numbers received so far, in arrival order (empty tuple —
        falsy — when none)."""
        return tuple(self._received)

    def first_signal(self) -> Optional[Tuple[int, float]]:
        """(signum, time.monotonic arrival) of the first handled signal,
        or None. The arrival stamp is what preemption latency is measured
        from: a SIGTERM notice gives a fixed grace budget, and the
        notice->committed-checkpoint wall time (--preempt_save_timeout,
        bench `preempt_save_latency_ms`) must be judged against the
        moment the notice LANDED, not when the loop got around to
        noticing it."""
        if not self._received:
            return None
        return self._received[0], self._received_at[0]

    def __enter__(self) -> "DistributedSignalHandler":
        self._received = []
        self._received_at = []

        def handler(signum: int, frame: Optional[FrameType]):
            if self._received:
                # second signal: the graceful path (checkpoint flush) is
                # presumed wedged — die NOW, unmaskably
                sys.stderr.write(
                    f"received {signal.Signals(signum).name} after "
                    f"{signal.Signals(self._received[0]).name}; "
                    "forcing exit without waiting for checkpoint flush\n")
                sys.stderr.flush()
                os._exit(128 + signum)
            self._received.append(signum)
            self._received_at.append(time.monotonic())

        for s in self.signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            if prev is not None:
                signal.signal(s, prev)
        self._prev = {}
        return False
