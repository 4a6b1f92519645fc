"""Per-run telemetry bundle for the train loop (and batch tools).

A copy of megatron_tpu/telemetry/run.py over the port's telemetry
modules: the same collectors, metric names and journal records. Its
recompile tracker counts no compiles (telemetry/goodput.py): the
`compile` bucket holds the first step's warm-up.

One object owning the enabled subset of {journal, goodput ledger,
recompile tracker, metrics collectors, sidecar /metrics server, flight
recorder}, so megatron_tpu_torch/training/pretrain.py wires telemetry with a
handful of calls instead of six objects' lifecycles. Construction is
driven by TrainingConfig's telemetry fields; everything is optional and
for_training() returns None when nothing is enabled (zero overhead for
runs that don't ask).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from megatron_tpu_torch.telemetry.flight_recorder import FlightRecorder
from megatron_tpu_torch.telemetry.goodput import (
    GoodputTracker, recompile_tracker,
)
from megatron_tpu_torch.telemetry.http import (
    MetricsServer, start_metrics_server,
)
from megatron_tpu_torch.telemetry.journal import (
    JOURNAL_NAME, EventJournal, set_global_journal,
)
from megatron_tpu_torch.telemetry.metrics import (
    MetricsRegistry, default_registry,
)


class RunTelemetry:
    """The enabled telemetry components of one training run."""

    def __init__(self, journal: Optional[EventJournal],
                 goodput: GoodputTracker,
                 metrics: MetricsRegistry,
                 server: Optional[MetricsServer],
                 flight: Optional[FlightRecorder]):
        self.journal = journal
        self.goodput = goodput
        self.recompiles = recompile_tracker()
        self.metrics = metrics
        self.server = server
        self.flight = flight
        # train-side collectors (get-or-create: stable across restarts in
        # one process, shared with anything else publishing to `metrics`)
        self.steps_total = metrics.counter(
            "train_steps_total", "optimizer steps completed")
        self.tokens_total = metrics.counter(
            "train_tokens_total", "tokens consumed by completed steps")
        self.recompiles_total = metrics.gauge(
            "jit_backend_compiles_total",
            "backend compiles in this process (0: eager PyTorch "
            "compiles nothing)")
        self.loss_gauge = metrics.gauge(
            "train_loss", "last completed step's loss")
        self.goodput_gauge = metrics.gauge(
            "train_goodput", "productive fraction of wall-clock so far")
        self.step_seconds = metrics.histogram(
            "train_step_seconds", "per-step wall time")
        self.stall_seconds = metrics.counter(
            "train_stall_seconds_total",
            "non-productive wall seconds by category",
            label_names=("category",))
        self.compile_cache_hits = metrics.gauge(
            "jit_compile_cache_hits_total",
            "persistent compilation cache hits in this process")
        # the async loop's sync-freedom invariant as a live number: in
        # steady state this advances by exactly 1 per step (the lagged
        # metrics fetch); growth beyond that is a hidden host sync on the
        # hot path (tests/test_prefetch.py regression-gates it)
        self.host_syncs = metrics.counter(
            "train_host_syncs_total",
            "blocking device->host transfers issued by the train loop")
        # resilience event counters (ROADMAP item 5: today's journal-only
        # events surfaced on /metrics so alerting needs no log scraping):
        # keyed by the journal kind, incremented transparently by emit()
        self.event_counters = {
            kind: metrics.counter(name, help_)
            for kind, name, help_ in (
                ("preemption", "train_preemptions_total",
                 "SIGTERM preemption notices that completed the expedited "
                 "checkpoint-and-exit path"),
                ("preemption_timeout", "train_preemption_timeouts_total",
                 "preemption checkpoints that missed --preempt_save_timeout"
                 " (forced exit 75)"),
                ("hang_detected", "train_hangs_total",
                 "step-watchdog hang verdicts (--step_timeout_s, exit 70)"),
                ("sdc_detected", "train_sdc_total",
                 "silent-data-corruption verdicts from the "
                 "--replay_check_interval bitwise replay"),
                ("elastic_resume", "train_elastic_resumes_total",
                 "resumes that re-derived the topology (dp/micro-batch/"
                 "tp/pp/host-count change)"),
                ("peer_abort", "train_peer_aborts_total",
                 "exits taken because a PEER host died or published a "
                 "poison record (exit 76)"),
                ("commit_abort", "train_commit_aborts_total",
                 "two-phase checkpoint commits aborted because the "
                 "cluster could not agree"),
                ("cadence_retune", "train_cadence_retunes_total",
                 "--save_interval auto interval changes"),
            )
        }

    # -- event plumbing -----------------------------------------------------

    def emit(self, kind: str, **fields: Any) -> None:
        c = self.event_counters.get(kind)
        if c is not None:
            c.inc()
        if self.journal is not None:
            self.journal.emit(kind, **fields)

    def journal_sink(self) -> "_CountingJournal":
        """Journal-shaped object (emit/flush) that ALSO feeds the event
        counters — for components that hold a journal handle rather than
        the RunTelemetry (AsyncCheckpointSaver: its commit_abort events
        must reach train_commit_aborts_total on /metrics)."""
        return _CountingJournal(self)

    def heartbeat(self, note: str = "") -> None:
        if self.flight is not None:
            self.flight.heartbeat(note)

    def compile_snapshot(self) -> Dict[str, float]:
        return self.recompiles.snapshot()

    def step(self, iteration: int, step_s: float, ntokens: int,
             compile_delta: Dict[str, float], **fields: Any) -> None:
        """One completed optimizer step: journal record + metrics +
        goodput attribution (warm-up seconds carved out of the span)."""
        compile_s = (compile_delta.get("compile_seconds", 0.0)
                     + compile_delta.get("trace_seconds", 0.0))
        compile_s = min(max(compile_s, 0.0), step_s)
        self.goodput.attribute("compile", compile_s)
        self.goodput.attribute("productive", step_s - compile_s)
        self.steps_total.inc()
        self.tokens_total.inc(ntokens)
        self.step_seconds.observe(step_s)
        snap = self.recompiles.snapshot()
        self.recompiles_total.set(snap["compiles"])
        self.compile_cache_hits.set(snap.get("cache_hits", 0))
        if "loss" in fields and fields["loss"] is not None:
            self.loss_gauge.set(fields["loss"])
        rec = dict(fields)
        rec.update(iteration=iteration, step_ms=round(step_s * 1e3, 3),
                   ntokens=int(ntokens))
        if compile_s > 0:
            rec["compile_ms"] = round(compile_s * 1e3, 3)
            rec["compiles"] = int(compile_delta.get("compiles", 0))
        # persistent-cache traffic for this step (always 0 here; kept so
        # the record matches the JAX package's)
        hits = int(compile_delta.get("cache_hits", 0))
        if hits:
            rec["cache_hits"] = hits
        self.emit("step", **rec)

    def stall(self, category: str, seconds: float, **fields: Any) -> None:
        """Attribute a named non-productive span + journal it."""
        self.goodput.attribute(category, seconds)
        self.stall_seconds.inc(max(seconds, 0.0), category=category)
        self.emit(category, seconds=round(seconds, 4), **fields)

    def goodput_report(self) -> Dict[str, float]:
        rep = self.goodput.report()
        self.goodput_gauge.set(rep["goodput"])
        return rep

    def close(self, **fields: Any) -> None:
        """Final goodput event, then tear down server/recorder/journal.

        fields land on the run_end record — the train loop passes
        received_signal so a post-mortem can tell a cluster preemption
        (SIGTERM) from an operator interrupt (SIGINT) without scraping
        stderr."""
        try:
            self.emit("goodput", final=True, **self.goodput_report())
            self.emit("run_end", **fields)
        finally:
            if self.flight is not None:
                self.flight.stop()
            if self.server is not None:
                self.server.close()
            if self.journal is not None:
                set_global_journal(None)
                self.journal.flush()
                self.journal.close()


class _CountingJournal:
    """EventJournal facade over a RunTelemetry: emit() routes through
    RunTelemetry.emit (journal + event counters), flush() reaches the
    underlying journal when one exists. Safe when the run has metrics but
    no journal (the counters still move; nothing is written)."""

    def __init__(self, rt: RunTelemetry):
        self._rt = rt

    def emit(self, kind: str, **fields: Any) -> None:
        self._rt.emit(kind, **fields)

    def flush(self) -> None:
        if self._rt.journal is not None:
            self._rt.journal.flush()


def for_training(tcfg, log=print, registry: Optional[MetricsRegistry] = None
                 ) -> Optional[RunTelemetry]:
    """Build the RunTelemetry a TrainingConfig asks for, or None.

    telemetry_dir enables the journal (and gives the flight recorder its
    bundle dir); metrics_port enables the sidecar /metrics listener (None
    disables; 0 binds a free port — tests read it back off server.port);
    flight_recorder arms the watchdog.
    """
    journal_on = bool(tcfg.telemetry_dir)
    server_on = tcfg.metrics_port is not None
    flight_on = bool(tcfg.flight_recorder)
    if not (journal_on or server_on or flight_on):
        return None
    metrics = registry if registry is not None else default_registry()
    journal = None
    if journal_on:
        # join the canonical name explicitly: telemetry_dir may not exist
        # yet, which would defeat EventJournal's dir-vs-file sniffing
        journal = EventJournal(
            os.path.join(tcfg.telemetry_dir, JOURNAL_NAME),
            max_bytes=int(tcfg.journal_max_mb * (1 << 20)))
        set_global_journal(journal)
    server = None
    if server_on:
        server = start_metrics_server(metrics, int(tcfg.metrics_port))
        log(f"telemetry: /metrics listening on port {server.port}")
    flight = None
    if flight_on:
        base = tcfg.telemetry_dir or tcfg.save
        out = (os.path.join(base, "flight_bundles") if base
               else "flight_bundles")
        flight = FlightRecorder(
            out_dir=out,
            deadline_s=tcfg.flight_recorder_deadline_s,
            journal=journal,
            abort=tcfg.flight_recorder_abort,
            log=log).start()
        log(f"telemetry: flight recorder armed "
            f"(deadline {tcfg.flight_recorder_deadline_s:.0f}s, "
            f"abort={tcfg.flight_recorder_abort})")
    return RunTelemetry(journal, GoodputTracker(), metrics, server, flight)
