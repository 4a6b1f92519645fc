"""Journal -> Chrome trace-event JSON: the whole run as one timeline
(counterpart of megatron_tpu/telemetry/perfetto.py, stdlib only).

``python -m megatron_tpu_torch.tools.telemetry_report DIR --perfetto
out.json`` renders the JSONL
event journals (one per host of a multi-host run) as a trace-event file
loadable in Perfetto (https://ui.perfetto.dev) or chrome://tracing —
steps, data waits, checkpoint stage->commit, eval/rollback stalls,
per-request serve spans, profiler windows, and the incident instants
(preemption, hang, SDC, peer abort, divergence) across every host of
the cluster in one scrollable view.

Format: the "JSON Array Format" of the Trace Event spec — an object
with ``traceEvents`` (list of events with ``ph``/``ts``/``pid``/
``tid``; ``ts`` in MICROseconds), ``displayTimeUnit``, and free
``metadata``. Each journal becomes one process (pid = host id when the
journal records one, else its index); lanes within it are threads with
``thread_name`` metadata. Durations the journal only records at
completion (step_ms, wall_s, seconds) become complete ("X") events
drawn backwards from their end timestamp; point incidents become
instant ("i") events.

No torch import: like the rest of the report tooling this runs on
journals copied off the training hosts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

#: lane (tid) layout per host process — stable ordering in the UI
LANES = (
    (1, "train steps"),
    (2, "data wait / prefetch"),
    (3, "checkpoint"),
    (4, "eval + rollback + stalls"),
    (5, "serve requests"),
    (6, "profiler"),
    (7, "events"),
)
_TID = {name: tid for tid, name in LANES}

#: point events rendered as instants on the "events" lane
INSTANT_KINDS = (
    "run_start", "run_end", "preemption", "preemption_timeout",
    "hang_detected", "sdc_detected", "peer_abort", "commit_abort",
    "divergence", "elastic_resume", "fault_injection", "cadence_retune",
    "step_skipped", "serve_route",
    "serve_drain_begin", "serve_drain_done", "serve_readmit",
    "serve_weight_reload", "weight_reload", "replica_breaker_open",
    "replica_readmitted",
)


def _x(name: str, pid: int, tid: int, start_s: float, dur_s: float,
       t0: float, args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
          "ts": round((start_s - t0) * 1e6, 3),
          "dur": round(max(dur_s, 0.0) * 1e6, 3), "cat": "journal"}
    if args:
        ev["args"] = args
    return ev


def _instant(name: str, pid: int, tid: int, ts_s: float, t0: float,
             args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
          "ts": round((ts_s - t0) * 1e6, 3), "s": "p", "cat": "journal"}
    if args:
        ev["args"] = args
    return ev


def _meta(name: str, pid: int, value: str,
          tid: Optional[int] = None) -> Dict[str, Any]:
    ev = {"ph": "M", "name": name, "pid": pid, "ts": 0,
          "args": {"name": value}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def _clean_args(e: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in e.items() if k not in ("ts", "kind")}


def _host_pid(events: List[Dict[str, Any]], index: int) -> Tuple[int, str]:
    """(pid, label) for one journal: the coordination host id when the
    run_start recorded one (multi-host runs), else the journal's
    position on the command line."""
    for e in events:
        if e.get("kind") == "run_start" and e.get("host") is not None:
            try:
                return int(e["host"]), f"host {e['host']}"
            except (TypeError, ValueError):
                break
    return index, f"journal {index}"


def journals_to_trace_events(
        journals: Sequence[Tuple[str, List[Dict[str, Any]]]]
) -> Dict[str, Any]:
    """(label, events) per journal -> the trace-event JSON object."""
    all_ts = [e["ts"] for _, events in journals for e in events
              if isinstance(e.get("ts"), (int, float))]
    t0 = min(all_ts) if all_ts else 0.0
    out: List[Dict[str, Any]] = []
    used_pids: Dict[int, int] = {}
    for index, (label, events) in enumerate(journals):
        pid, host_label = _host_pid(events, index)
        if pid in used_pids:  # two journals claiming one host id
            pid = max(used_pids) + 1
        used_pids[pid] = 1
        out.append(_meta("process_name", pid, f"{host_label} ({label})"))
        for tid, name in LANES:
            out.append(_meta("thread_name", pid, name, tid=tid))
        out.extend(_journal_events(events, pid, t0))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "metadata": {"tool": "megatron_tpu_torch tools/telemetry_report.py",
                     "journals": [label for label, _ in journals],
                     "t0_unix_s": t0},
    }


def _journal_events(events: List[Dict[str, Any]], pid: int, t0: float
                    ) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    profile_open: Optional[Dict[str, Any]] = None
    ckpt_begin: Dict[Any, float] = {}
    for e in events:
        kind = e.get("kind")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if kind == "step":
            dur = float(e.get("step_ms", 0.0)) / 1e3
            start = ts - dur
            out.append(_x(f"step {e.get('iteration')}", pid,
                          _TID["train steps"], start, dur, t0,
                          _clean_args(e)))
            wait = float(e.get("data_wait_ms", 0.0)) / 1e3
            if wait > 0:
                # the queue-pop wait precedes the step's processing span
                out.append(_x("data_wait", pid,
                              _TID["data wait / prefetch"],
                              start - wait, wait, t0,
                              {"iteration": e.get("iteration")}))
        elif kind == "checkpoint_begin":
            ckpt_begin[e.get("iteration")] = ts
        elif kind == "checkpoint_commit":
            begin = ckpt_begin.pop(e.get("iteration"), None)
            dur = (ts - begin if begin is not None
                   else float(e.get("seconds", 0.0)))
            out.append(_x(f"checkpoint {e.get('iteration')}", pid,
                          _TID["checkpoint"], ts - dur, dur, t0,
                          _clean_args(e)))
        elif kind == "checkpoint_stall":
            dur = float(e.get("seconds", 0.0))
            out.append(_x("checkpoint_stall", pid, _TID["checkpoint"],
                          ts - dur, dur, t0, _clean_args(e)))
        elif kind in ("eval", "rollback_replay", "data_wait"):
            dur = float(e.get("seconds", 0.0))
            out.append(_x(kind, pid, _TID["eval + rollback + stalls"],
                          ts - dur, dur, t0, _clean_args(e)))
        elif kind in ("serve_request", "serve_warmup"):
            dur = float(e.get("wall_s", 0.0))
            name = (f"req {e.get('status')}" if kind == "serve_request"
                    else kind)
            out.append(_x(name, pid, _TID["serve requests"],
                          ts - dur, dur, t0, _clean_args(e)))
        elif kind == "profile_begin":
            profile_open = e
        elif kind == "profile_end" and profile_open is not None:
            start = profile_open["ts"]
            out.append(_x("profile window", pid, _TID["profiler"],
                          start, ts - start, t0,
                          _clean_args(profile_open)))
            profile_open = None
        elif kind == "profile_aborted":
            # an abort CLOSES any open window (preemption/hang flush, or
            # a busy-rejected /admin/profile) so the next begin/end pair
            # isn't mis-paired across it; the instant keeps the reason
            out.append(_instant(kind, pid, _TID["profiler"], ts, t0,
                                _clean_args(e)))
            if profile_open is not None:
                start = profile_open["ts"]
                out.append(_x("profile window (aborted)", pid,
                              _TID["profiler"], start, ts - start, t0,
                              _clean_args(profile_open)))
                profile_open = None
        elif kind in INSTANT_KINDS:
            out.append(_instant(kind, pid, _TID["events"], ts, t0,
                                _clean_args(e)))
    if profile_open is not None:
        # window never closed (abort path): render what we know
        out.append(_instant("profile window (unclosed)", pid,
                            _TID["profiler"], profile_open["ts"], t0,
                            _clean_args(profile_open)))
    return out
