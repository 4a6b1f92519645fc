"""Fault tolerance for the train loop (counterpart of
megatron_tpu/training/resilience.py).

  * DivergenceSentinel: host-side watchdog over the per-step metrics.
    Trips on a streak of consecutive non-finite/skipped optimizer steps
    (metrics["skip_streak"], the optimizer's TrainState.nonfinite_streak)
    or on a sustained loss spike against an EMA baseline. The train loop
    aborts with DivergenceError or, with --rollback_on_divergence,
    reloads the newest valid checkpoint and fast-forwards the data past
    the poison window (training/pretrain.py _handle_divergence).
  * StepWatchdog: a per-step deadline that turns a hang into a flight
    bundle and exit HANG_EXIT_CODE (70).
  * CheckpointCadenceTuner: --save_interval auto.
  * The fault harness driven by the MEGATRON_TPU_FAULT variable, under the
    JAX package's name and spec grammar (comma-separated kind:int[:int]),
    so the kill/resume, preemption, hang, SDC and rollback paths run in
    real subprocesses rather than mocks:

      kill_during_save:ITER   SIGKILL while finalizing ITER's checkpoint
                              (after the state files, before the commit)
      kill_at:ITER            SIGKILL right before iteration ITER
      preempt_at:ITER         self-deliver SIGTERM right before iteration
                              ITER (a preemption notice at an exact step)
      hang_step:ITER          wedge the loop forever before iteration ITER
      corrupt_step:ITER       flip one bit in the params after ITER's
                              update (found by --replay_check_interval)
      nan_loss:ITER[:N]       poison the batch loss_mask for iterations
                              [ITER, ITER+N) so loss and grads go
                              non-finite through the real skip path
      slow_save:MS            sleep MS ms inside checkpoint finalization
      kill_host:HOST:ITER     kill_at on the one process whose
                              coordination host id is HOST (its peers
                              must exit PEER_ABORT_EXIT_CODE, not hang)
      preempt_host:HOST:ITER  preempt_at on host HOST only: the signal
                              agreement (training/coordination.py) must
                              drain every host

    and the serving faults the engines read in their tick loop and at
    admission (inference/engine.py): kill_replica:N, hang_replica:N,
    slow_tick:MS, reject_admission, preempt_replica:N, and the server's
    migrate_fail:N (maybe_corrupt: the first N outbound KV-state
    migration frames are torn; the importer's crc check rejects each and
    the exporter walks down its migrate -> recompute -> retry ladder,
    inference/server.py).

  * batch_fingerprint (the JAX package's crc32 string for the same numpy
    batch) and bitwise tree comparison over torch tensors.

The variable is re-parsed when its value changes, so tests can
monkeypatch it without reimporting.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

FAULT_ENV = "MEGATRON_TPU_FAULT"

#: exit code of the step watchdog's clean abort on a detected hang
#: (EX_SOFTWARE): the supervisor sees a deliberate failure with a flight
#: bundle on disk, not a timeout kill that destroyed the evidence
HANG_EXIT_CODE = 70
#: exit code when a preemption checkpoint misses --preempt_save_timeout
#: (EX_TEMPFAIL): the notice window closed with the save still in flight
PREEMPT_TIMEOUT_EXIT_CODE = 75
#: exit code when a host exits because a PEER died or published a poison
#: record (EX_PROTOCOL): the cluster agreement said stop — distinct from
#: this host's own hang (70) / preempt-timeout (75) verdicts so a fleet
#: supervisor can tell the originating host from the collateral ones
PEER_ABORT_EXIT_CODE = 76

_parse_cache: Tuple[Optional[str], Dict[str, Tuple[int, ...]]] = (None, {})


class DivergenceError(RuntimeError):
    """Training diverged and the sentinel decided recovery is impossible
    (or was not requested). Carries the full diagnostic in str(e)."""


class SDCError(RuntimeError):
    """The --replay_check_interval integrity replay found a bitwise
    mismatch between a committed step and its replay from the same
    (state, batch) — silent data corruption. str(e) names the
    mismatching leaf paths; the journal carries `sdc_detected`."""


def parse_fault_env(value: Optional[str] = None) -> Dict[str, Tuple[int, ...]]:
    """'kill_during_save:4,nan_loss:3:2' -> {'kill_during_save': (4,),
    'nan_loss': (3, 2)}. Malformed specs raise (a typo'd fault silently
    not firing would invalidate the test run it was meant to drive)."""
    raw = os.environ.get(FAULT_ENV, "") if value is None else value
    global _parse_cache
    if _parse_cache[0] == raw:
        return _parse_cache[1]
    out: Dict[str, Tuple[int, ...]] = {}
    for spec in filter(None, (s.strip() for s in raw.split(","))):
        kind, _, args = spec.partition(":")
        try:
            out[kind] = tuple(int(a) for a in args.split(":")) if args else ()
        except ValueError:
            raise ValueError(
                f"{FAULT_ENV}: malformed fault spec {spec!r} "
                "(form is kind:int[:int...])")
    _parse_cache = (raw, out)
    return out


def fault_args(kind: str) -> Optional[Tuple[int, ...]]:
    return parse_fault_env().get(kind)


def fault_armed(kind: str) -> bool:
    """Whether `kind` appears in the fault env at all — for faults with no
    iteration argument (reject_admission) that fire for as long as they
    are armed."""
    return fault_args(kind) is not None


def fault_active(kind: str, iteration: int) -> bool:
    """Whether `kind` fires at `iteration`. kill_* faults fire at exactly
    their ITER; nan_loss fires over [ITER, ITER+N)."""
    args = fault_args(kind)
    if args is None or not args:
        return False
    if kind == "nan_loss":
        count = args[1] if len(args) > 1 else 1
        return args[0] <= iteration < args[0] + count
    return iteration == args[0]


def _journal_fault(kind: str, **fields) -> None:
    """Record the injected fault in the telemetry journal (when the run
    has one): a post-mortem of a faulted test run should show the fault
    the way a real incident timeline would show the preemption."""
    from megatron_tpu_torch.telemetry import journal as tj

    j = tj.get_global_journal()
    if j is not None:
        j.emit("fault_injection", fault=kind, **fields)
        j.flush()  # kill_* faults SIGKILL right after; make the line land


def maybe_kill(kind: str, iteration: int) -> None:
    """SIGKILL this process if the fault is armed for `iteration` — an
    unmaskable death, like a preemption or OOM kill, so nothing downstream
    (atexit, finally, signal handlers) can tidy up after it."""
    if fault_active(kind, iteration):
        sys.stderr.write(
            f"MEGATRON_TPU_FAULT: {kind} firing at iteration {iteration} — "
            "killing process\n")
        sys.stderr.flush()
        _journal_fault(kind, iteration=iteration)
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_signal(kind: str, iteration: int,
                 signum: int = signal.SIGTERM) -> None:
    """Self-deliver `signum` if the fault is armed for `iteration` — a
    preemption NOTICE, as opposed to maybe_kill's unmaskable death: the
    process's own signal handler sees it and gets to run the expedited
    checkpoint-and-exit path, exactly like a real scheduler SIGTERM."""
    if fault_active(kind, iteration):
        name = signal.Signals(signum).name
        sys.stderr.write(
            f"MEGATRON_TPU_FAULT: {kind} firing at iteration {iteration} — "
            f"delivering {name}\n")
        sys.stderr.flush()
        _journal_fault(kind, iteration=iteration, signal=name)
        os.kill(os.getpid(), signum)


_corrupt_counts: Dict[str, int] = {}


def maybe_corrupt(kind: str, blob: bytes) -> bytes:
    """Truncate `blob` for the first N occurrences of the fault (form
    kind:N): a torn wire transfer, which the receiver's integrity check
    (crc + committed payload length) must reject. The count is
    process-wide, so migrate_fail:2 tears exactly the first two
    transfers a replica attempts."""
    args = fault_args(kind)
    if args is None:
        return blob
    limit = args[0] if args else 1
    seen = _corrupt_counts.get(kind, 0)
    if seen >= limit:
        return blob
    _corrupt_counts[kind] = seen + 1
    sys.stderr.write(f"MEGATRON_TPU_FAULT: {kind} corrupting transfer "
                     f"{seen + 1}/{limit} ({len(blob)} bytes)\n")
    sys.stderr.flush()
    _journal_fault(kind, transfer=seen + 1, bytes=len(blob))
    # drop the final third: the manifest header usually survives, the
    # payload does not (the torn-TCP shape)
    return blob[:max(len(blob) - max(len(blob) // 3, 1), 0)]


def host_fault_active(kind: str, host: int, iteration: int) -> bool:
    """Whether the per-host fault `kind` (form kind:HOST:ITER) fires for
    this (host, iteration): the fault hits exactly one host of the
    cluster, and the test asserts what the others do about it."""
    args = fault_args(kind)
    return (args is not None and len(args) >= 2
            and args[0] == host and args[1] == iteration)


def maybe_kill_host(host: int, iteration: int) -> None:
    """SIGKILL this process iff kill_host:HOST:ITER names its coordination
    host id: one host of the cluster dying unmaskably."""
    if host_fault_active("kill_host", host, iteration):
        sys.stderr.write(
            f"MEGATRON_TPU_FAULT: kill_host firing on host {host} at "
            f"iteration {iteration} — killing process\n")
        sys.stderr.flush()
        _journal_fault("kill_host", host=host, iteration=iteration)
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_signal_host(host: int, iteration: int,
                      signum: int = signal.SIGTERM) -> None:
    """Self-deliver SIGTERM iff preempt_host:HOST:ITER names this host:
    the preemption notice landing on one host of the cluster."""
    if host_fault_active("preempt_host", host, iteration):
        name = signal.Signals(signum).name
        sys.stderr.write(
            f"MEGATRON_TPU_FAULT: preempt_host firing on host {host} at "
            f"iteration {iteration} — delivering {name}\n")
        sys.stderr.flush()
        _journal_fault("preempt_host", host=host, iteration=iteration,
                       signal=name)
        os.kill(os.getpid(), signum)


#: sleep-fault kinds already journaled once this process (see
#: maybe_sleep's journal_once)
_journaled_sleeps: set = set()


def maybe_sleep(kind: str = "slow_save", journal_once: bool = False) -> None:
    """Sleep args[0] milliseconds if the fault is armed (no iteration).

    journal_once=True journals only the FIRST firing per process — for
    faults that fire on every decode tick (slow_tick), where a per-tick
    line would drown the journal. Per-occurrence faults (slow_save: one
    firing per checkpoint) keep the default and journal every firing, so
    a two-save run still shows two fault_injection events."""
    args = fault_args(kind)
    if args:
        if not (journal_once and kind in _journaled_sleeps):
            _journaled_sleeps.add(kind)
            _journal_fault(kind, ms=args[0])
        time.sleep(args[0] / 1000.0)


def maybe_hang(kind: str, iteration: int) -> None:
    """Wedge the calling thread forever if the fault is armed for
    `iteration` — a hung device step or deadlocked driver: the process
    stays alive (liveness probes still answer) but never makes progress,
    which only request deadlines and the router's circuit breaker catch."""
    if fault_active(kind, iteration):
        sys.stderr.write(
            f"MEGATRON_TPU_FAULT: {kind} firing at iteration {iteration} — "
            "hanging thread forever\n")
        sys.stderr.flush()
        _journal_fault(kind, iteration=iteration)
        while True:
            time.sleep(3600)


def poison_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Inject a non-finite loss through the real numerics: an inf in the
    loss_mask makes the masked-mean loss NaN, its grads non-finite, and the
    optimizer skip the step (found-inf path) — exactly what a fp16 overflow
    or corrupted batch produces, with no mocked metrics."""
    _journal_fault("nan_loss")
    out = dict(batch)
    ref = out.get("loss_mask")
    if ref is None:
        ref = np.ones(np.asarray(out["tokens"]).shape, np.float32)
    mask = np.array(ref, dtype=np.float32, copy=True)
    mask.flat[0] = np.inf
    out["loss_mask"] = mask
    return out


def host_batch_faults(batch: Dict[str, np.ndarray], iteration: int,
                      log=None) -> Dict[str, np.ndarray]:
    """Apply the host-side batch faults armed for `iteration` (currently
    nan_loss poisoning); identity otherwise. The ONE hook both loop modes
    share: the synchronous loop calls it right before placement, the async
    loop's prefetcher calls it as its per-batch transform (with the
    iteration each batch will be consumed at), so an injected fault
    poisons exactly the same batches either way and the two loops stay
    bitwise-comparable under faults (tests/test_prefetch.py)."""
    if fault_active("nan_loss", iteration):
        if log is not None:
            log(f"fault injection: nan_loss poisoning iteration {iteration}")
        return poison_batch(batch)
    return batch


def batch_fingerprint(batch: Dict[str, np.ndarray]) -> str:
    """Order-independent crc32 over every array in a host batch (the
    JAX package's string for the same numpy batch): two runs fed the same
    samples in the same order give the same per-step fingerprints
    (--log_data_fingerprint journals it as `data_crc`). Computed BEFORE
    fault poisoning so an injected nan_loss never reads as a data-order
    change."""
    crc = 0
    for key in sorted(batch):
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(batch[key]).tobytes(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def tree_leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] of nested dicts, lists, tuples and dataclasses (a
    TrainState) in a fixed order; None subtrees have no leaves. Paths are
    slash-joined names, e.g. "params/layers/attn_qkv/w"."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Same-width integer view of a float tensor, so NaN payloads match
    only bit for bit and -0.0 != 0.0."""
    if x.is_floating_point():
        return x.contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[x.element_size()])
    return x


def bitwise_equal_tree(a: Any, b: Any) -> Dict[str, torch.Tensor]:
    """{path: scalar bool tensor} of per-leaf bitwise equality, computed
    where the leaves live: only the verdicts ever cross to the host
    (mismatch_paths reads them in one transfer)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise ValueError("bitwise_equal_tree: the trees differ in structure")
    out: Dict[str, Any] = {}
    for (path, x), (_, y) in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape != y.shape or x.dtype != y.dtype:
            out[path] = False
        else:
            out[path] = torch.all(_bits(x) == _bits(y.to(x.device)))
    return out


def mismatch_paths(eq_tree: Dict[str, Any], limit: int = 8) -> List[str]:
    """Leaf paths whose bitwise_equal_tree verdict is False, read in one
    device-to-host transfer. [] means identical."""
    paths = list(eq_tree)
    verdicts = [eq_tree[p] for p in paths]
    devices = [v.device for v in verdicts if isinstance(v, torch.Tensor)]
    flags = torch.stack([torch.as_tensor(v, device=devices[0]).reshape(())
                         for v in verdicts]).tolist() if devices else \
        [bool(v) for v in verdicts]
    return [p for p, ok in zip(paths, flags) if not ok][:limit]


def tree_bitwise_mismatch(a, b, limit: int = 8) -> List[str]:
    """Leaf paths where two same-structure trees differ BITWISE (a
    replayed step must reproduce the committed one exactly)."""
    return mismatch_paths(bitwise_equal_tree(a, b), limit=limit)


def corrupt_params(params: Any, iteration: int) -> Any:
    """Flip one bit of the first parameter leaf in place: simulated
    silent data corruption (the corrupt_step fault's payload). The model
    keeps training plausibly; only a bitwise integrity check sees it."""
    path, leaf = tree_leaves(params)[0]
    with torch.no_grad():
        flat = leaf.detach().view(-1)
        word = flat[:1].view(torch.uint8) if leaf.is_floating_point() \
            else flat[:1]
        word[0] ^= 1
    _journal_fault("corrupt_step", iteration=iteration)
    sys.stderr.write(
        f"MEGATRON_TPU_FAULT: corrupt_step firing at iteration {iteration} "
        f"— flipped one bit in the first params leaf ({path})\n")
    sys.stderr.flush()
    return params


class StepWatchdog:
    """Per-step deadline watchdog: turns an infinite hang into a bounded,
    diagnosable abort.

    The train loop beat()s once per processed step (and after save/eval
    stalls); a daemon thread fires `on_hang(age_seconds)` ONCE when the
    heartbeat goes stale past `timeout_s`. The clock starts at the FIRST
    beat, so the first step's warm-up is never judged against
    a deadline sized for steady-state steps (same policy as the flight
    recorder). The callback runs on the watchdog thread and is expected
    not to return (the loop's handler dumps a flight bundle, journals
    `hang_detected`, and os._exits HANG_EXIT_CODE); if it does return the
    watchdog stays stopped — one hang, one verdict.

    Deliberately separate from the telemetry FlightRecorder (whose
    watchdog observes the same heartbeats): the recorder is a coarse
    liveness monitor that dumps-and-keeps-watching (or SIGABRTs), while
    this is a per-step DEADLINE with pause() windows for known warm-ups
    and a clean conventional exit code — folding the two would couple
    the train loop's abort policy to the observability layer's. When
    both are armed the loop's hang handler parks the recorder's thread
    before dumping, so one hang still yields one bundle and one abort
    (pretrain.py _on_hang)."""

    def __init__(self, timeout_s: float, on_hang: Callable[[float], None],
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError("step watchdog timeout_s must be > 0")
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.poll_s = float(poll_s) if poll_s else max(timeout_s / 4, 0.02)
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self.beats = 0
        self.fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._watch, name="step-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll_s * 4 + 5)

    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self.beats += 1

    def pause(self) -> None:
        """Go dormant until the next beat — the loop calls this before a
        step that will warm up a fresh step function (batch-size rampup
        builds one per level; the first eval), the same reason the clock
        only starts at the first beat: a legitimate warm-up must never be
        declared a hang. A REAL hang during a paused window is missed,
        which is the documented cost of not false-killing healthy
        warm-ups."""
        with self._lock:
            self._last_beat = None

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                last = self._last_beat
            if last is None:  # clock starts at the first beat
                continue
            age = time.monotonic() - last
            if age < self.timeout_s:
                continue
            self._stop.set()  # single-shot: one hang, one verdict
            self.fired = True
            self.on_hang(age)
            return


class DivergenceSentinel:
    """Host-side divergence watchdog over per-step (loss, skipped) pairs.

    Two independent detectors:
      * non-finite streak: `patience` CONSECUTIVE steps that were skipped
        by the optimizer or produced a non-finite loss. Isolated skips
        (fp16 loss-scale backoff) reset the streak and never trip.
      * loss spike: after `warmup_steps` finite losses establish an EMA
        baseline, `spike_patience` consecutive losses above
        `spike_factor * ema` trip. Spiking losses are NOT folded into the
        EMA (a slow blow-up must not drag its own baseline up after it).

    observe() returns None while healthy, or a human-readable trip reason.
    Either detector is disabled by setting its knob to 0.

    Async-loop lag: with --metrics_lag K the train loop feeds observe()
    each step's metrics K steps after dispatch, so a trip DECISION lands K
    steps late — but it still names the step that tripped, the loop rolls
    back with that step as the poison-window bound, and the <=K newer
    in-flight steps are discarded wholesale by the checkpoint restore. Net
    effect: trip *latency* grows by K (bounded, documented in
    docs/fault_tolerance.md); the post-rollback trajectory is identical to
    the synchronous loop's.
    """

    def __init__(self, patience: int = 100, spike_factor: float = 0.0,
                 spike_patience: int = 5, ema_alpha: float = 0.05,
                 warmup_steps: int = 20):
        self.patience = int(patience)
        self.spike_factor = float(spike_factor)
        self.spike_patience = max(int(spike_patience), 1)
        self.ema_alpha = float(ema_alpha)
        self.warmup_steps = int(warmup_steps)
        self.reset()

    def reset(self) -> None:
        """Fresh streaks and EMA — called after a rollback so the replayed
        window is judged from scratch."""
        self.nonfinite_streak = 0
        self.spike_streak = 0
        self.ema: Optional[float] = None
        self.n_finite = 0

    def observe(self, loss: Optional[float], skipped: bool = False,
                streak: Optional[int] = None) -> Optional[str]:
        """streak: the optimizer's device-tracked consecutive-skip count
        (metrics["skip_streak"], persisted in TrainState.nonfinite_streak).
        When given it OVERRIDES the host counter, so a run that resumes
        mid-NaN — or crash-loops faster than `patience` steps — still
        accumulates toward the trip instead of restarting from zero."""
        bad = skipped or loss is None or not math.isfinite(loss)
        if bad:
            self.nonfinite_streak = (int(streak) if streak is not None
                                     else self.nonfinite_streak + 1)
            if self.patience and self.nonfinite_streak >= self.patience:
                return (f"{self.nonfinite_streak} consecutive non-finite/"
                        f"skipped optimizer steps (divergence_patience="
                        f"{self.patience})")
            return None
        self.nonfinite_streak = 0
        if (self.spike_factor > 0 and self.ema is not None
                and self.n_finite >= self.warmup_steps
                and loss > self.spike_factor * self.ema):
            self.spike_streak += 1
            if self.spike_streak >= self.spike_patience:
                return (f"loss {loss:.6g} above loss_spike_factor="
                        f"{self.spike_factor} x EMA {self.ema:.6g} for "
                        f"{self.spike_streak} consecutive steps")
            return None
        self.spike_streak = 0
        self.ema = (loss if self.ema is None
                    else (1 - self.ema_alpha) * self.ema
                    + self.ema_alpha * loss)
        self.n_finite += 1
        return None


class CheckpointCadenceTuner:
    """--save_interval auto: derive the checkpoint cadence from MEASURED
    commit latency instead of a guessed constant.

    The contract a preemption imposes: when the SIGTERM notice lands, the
    expedited save must commit inside the grace window
    (--preempt_save_timeout). The work at risk between checkpoints is
    save_interval steps, so the rational cadence spends the window on
    steps and reserves the measured p95 commit latency for the save:

        save_interval ~= (grace_window - p95_commit) / p50_step_time

    clamped below by --save_interval_floor (a pathological latency sample
    must never collapse the run into saving every step). Inputs: per-step
    wall seconds from the live run, commit latencies from the live run's
    `checkpoint_commit` events plus — so the FIRST interval of a restart
    is already informed — the journal's history of `checkpoint_commit`
    and `preemption.save_latency_ms` records (seed_from_journal). Every
    interval change is journaled as `cadence_retune`.
    """

    def __init__(self, grace_s: float, floor_steps: int = 25,
                 max_steps: int = 100_000, window: int = 256):
        if grace_s <= 0:
            raise ValueError(
                "--save_interval auto needs a positive --preempt_save_timeout"
                " (the grace window the cadence is derived from)")
        self.grace_s = float(grace_s)
        self.floor_steps = max(int(floor_steps), 1)
        self.max_steps = int(max_steps)
        self._steps: List[float] = []
        self._window = int(window)
        self._commits: List[float] = []
        self._last: Optional[int] = None

    def seed_from_journal(self, events) -> int:
        """Pre-load commit/preemption latencies from a prior journal;
        returns how many samples were adopted."""
        n = 0
        for e in events:
            kind = e.get("kind")
            if kind == "checkpoint_commit" and "seconds" in e:
                self.note_commit(float(e["seconds"]))
                n += 1
            elif kind == "preemption" and "save_latency_ms" in e:
                self.note_commit(float(e["save_latency_ms"]) / 1e3)
                n += 1
        return n

    def note_step(self, seconds: float) -> None:
        self._steps.append(float(seconds))
        if len(self._steps) > self._window:
            del self._steps[:-self._window]

    def note_commit(self, seconds: float) -> None:
        self._commits.append(float(seconds))
        if len(self._commits) > self._window:
            del self._commits[:-self._window]

    @staticmethod
    def _pct(vals: List[float], q: float) -> float:
        s = sorted(vals)
        return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]

    def interval(self) -> Optional[int]:
        """Current best interval in steps, or None while there is no step
        sample yet (callers keep their previous/floor cadence)."""
        if not self._steps:
            return None
        p50_step = self._pct(self._steps, 0.50)
        p95_commit = self._pct(self._commits, 0.95) if self._commits else 0.0
        budget = max(self.grace_s - p95_commit, 0.0)
        raw = int(budget / max(p50_step, 1e-9))
        return max(self.floor_steps, min(raw, self.max_steps))

    def retune(self) -> Optional[Dict[str, float]]:
        """interval() plus change tracking: returns a `cadence_retune`
        journal payload when the interval moved, else None."""
        it = self.interval()
        if it is None or it == self._last:
            return None
        prev, self._last = self._last, it
        return {
            "from_interval": prev, "to_interval": it,
            "grace_s": self.grace_s,
            "p95_commit_ms": round(
                self._pct(self._commits, 0.95) * 1e3, 1
            ) if self._commits else 0.0,
            "p50_step_ms": round(self._pct(self._steps, 0.50) * 1e3, 3),
            "floor": self.floor_steps,
        }
