"""Summarize telemetry event journals (counterpart of
tools/telemetry_report.py) — the journals the port's training loop and
server write under --telemetry_dir (telemetry/journal.py).

    python -m megatron_tpu_torch.tools.telemetry_report runs/tele/events.jsonl
    python -m megatron_tpu_torch.tools.telemetry_report runs/tele
    python -m megatron_tpu_torch.tools.telemetry_report runs/tele --format json
    python -m megatron_tpu_torch.tools.telemetry_report host0/tele host1/tele
    python -m megatron_tpu_torch.tools.telemetry_report host*/tele \\
        --perfetto run.json
                                  # -> one Perfetto/chrome://tracing
                                  #    timeline of the whole cluster

Several journals (one per host of a coordinated multi-host run) merge
into ONE report: events are attributed to the host recorded on each
journal's `run_start`, and a "coordination" section counts preemption
notices by `notice_host`, peer aborts by (host, cause), and two-phase
commit aborts — a multi-host post-mortem is one command.

Reads the append-only JSONL journal a training run writes under
--telemetry_dir (rotated segments included automatically) and reports:

  * goodput %: productive step seconds over wall-clock, with the stall
    split (checkpoint stalls, data waits, compile, rollback replay, eval)
  * stall top-list: the longest individual non-productive events, so "the
    run lost 4% to checkpoint_stall" comes with the receipts
  * latency percentiles: per-step wall time p50/p90/p99 (+ tokens/s), the
    training counterpart of the serving histograms on /metrics

It imports neither torch nor the rest of the port beyond its stdlib-only
telemetry modules, so it runs anywhere the journals are copied to.
"""

import argparse
import json
import os
import sys
from typing import Any, Dict, List

from megatron_tpu_torch.telemetry.goodput import CATEGORIES
from megatron_tpu_torch.telemetry.journal import JOURNAL_NAME, read_events

#: journal kinds counted as discrete stall events for the top-list
STALL_KINDS = ("checkpoint_stall", "eval", "rollback_replay")


def load_journal(path: str) -> List[Dict[str, Any]]:
    """All events, oldest first, across rotated segments (.N oldest)."""
    if os.path.isdir(path):
        path = os.path.join(path, JOURNAL_NAME)
    if not os.path.exists(path) and not _segments(path):
        raise FileNotFoundError(f"no journal at {path}")
    events: List[Dict[str, Any]] = []
    for seg in _segments(path) + ([path] if os.path.exists(path) else []):
        evs, torn = read_events(seg)
        events.extend(evs)
        if torn is not None:
            print(f"# note: {seg} ends in a torn line "
                  "(crash mid-write; expected after a kill)",
                  file=sys.stderr)
    return events


def _segments(path: str) -> List[str]:
    out = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        out.append(f"{path}.{i}")
        i += 1
    return list(reversed(out))  # oldest first


def load_journals(paths: List[str]) -> List[Dict[str, Any]]:
    """Merge several hosts' journals into one event stream (one path per
    host). Per-host attribution needs no annotation: every coordination
    event already embeds the host ids that matter (`run_start.host`,
    `preemption.notice_host`, `peer_abort.host`/`observed_by`,
    `commit_abort.host`), which is exactly what _summarize_coordination
    aggregates over."""
    merged: List[Dict[str, Any]] = []
    for path in paths:
        merged.extend(load_journal(path))
    return merged


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(events: List[Dict[str, Any]], top_n: int = 5) -> Dict[str, Any]:
    steps = [e for e in events if e.get("kind") == "step"]
    goodputs = [e for e in events if e.get("kind") == "goodput"]
    stalls = [e for e in events
              if e.get("kind") in STALL_KINDS and "seconds" in e]
    out: Dict[str, Any] = {
        "events": len(events),
        "steps": len(steps),
        "checkpoints": sum(1 for e in events
                           if e.get("kind") == "checkpoint_commit"),
        "faults": [e.get("fault") for e in events
                   if e.get("kind") == "fault_injection"],
        "divergences": sum(1 for e in events
                           if e.get("kind") == "divergence"),
        # preemption / hang / SDC sentinel ledger (docs/fault_tolerance.md
        # "Preemption and elastic resume")
        "preemptions": sum(1 for e in events
                           if e.get("kind") == "preemption"),
        "preemption_timeouts": sum(1 for e in events
                                   if e.get("kind") == "preemption_timeout"),
        "hangs": sum(1 for e in events
                     if e.get("kind") == "hang_detected"),
        "sdc_detected": sum(1 for e in events
                            if e.get("kind") == "sdc_detected"),
        "elastic_resumes": sum(1 for e in events
                               if e.get("kind") == "elastic_resume"),
    }
    if goodputs:
        # goodput events are cumulative WITHIN one process; a journal that
        # spans crash+resume holds several process segments (delimited by
        # run_start), and summing only the last would let a run that lost
        # hours to a crash report near-100% goodput. Take the last event
        # of EACH segment and sum across them.
        finals: List[Dict[str, Any]] = []
        current: Dict[str, Any] = {}
        for e in events:
            if e.get("kind") == "run_start" and current:
                finals.append(current)
                current = {}
            elif e.get("kind") == "goodput":
                current = e
        if current:
            finals.append(current)
        wall = sum(g.get("wall_s", 0.0) for g in finals)
        productive = sum(g.get("productive_s", 0.0) for g in finals)
        out["goodput_pct"] = round(100.0 * productive / max(wall, 1e-9), 2)
        out["wall_s"] = round(wall, 4)
        out["split_s"] = {c: round(sum(g.get(f"{c}_s", 0.0)
                                       for g in finals), 4)
                          for c in CATEGORIES}
        if len(finals) > 1:
            out["process_segments"] = len(finals)
    out["stall_top"] = [
        {"kind": e["kind"], "seconds": round(float(e["seconds"]), 4),
         "iteration": e.get("iteration")}
        for e in sorted(stalls, key=lambda e: -float(e["seconds"]))[:top_n]]
    if steps:
        ms = sorted(float(e["step_ms"]) for e in steps if "step_ms" in e)
        out["step_ms"] = {"p50": round(percentile(ms, 0.50), 3),
                          "p90": round(percentile(ms, 0.90), 3),
                          "p99": round(percentile(ms, 0.99), 3),
                          "max": round(ms[-1], 3)}
        tps = sorted(float(e["tokens_per_s"]) for e in steps
                     if "tokens_per_s" in e)
        if tps:
            out["tokens_per_s"] = {"p50": round(percentile(tps, 0.50), 1),
                                   "max": round(tps[-1], 1)}
        losses = [float(e["loss"]) for e in steps
                  if isinstance(e.get("loss"), (int, float))]
        if losses:
            out["last_loss"] = round(losses[-1], 6)
        compiles = sum(int(e.get("compiles", 0)) for e in steps)
        out["step_compiles"] = compiles
        # warm-start evidence: persistent-compilation-cache hits recorded
        # on step records (a resumed run pays retrieval, not XLA)
        cache_hits = sum(int(e.get("cache_hits", 0)) for e in steps)
        if cache_hits:
            out["compile_cache_hits"] = cache_hits
        # async-loop health: steady-state queue-pop wait should be ~0 —
        # a growing p50 here means the input pipeline can no longer hide
        # behind the device step (docs/performance.md "Async goodput loop")
        waits = sorted(float(e["data_wait_ms"]) for e in steps
                       if "data_wait_ms" in e)
        if waits:
            out["data_wait_ms"] = {"p50": round(percentile(waits, 0.50), 3),
                                   "p99": round(percentile(waits, 0.99), 3),
                                   "max": round(waits[-1], 3)}
    serving = _summarize_serving(events)
    if serving:
        out["serving"] = serving
    coord = _summarize_coordination(events)
    if coord:
        out["coordination"] = coord
    return out


def _summarize_coordination(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Multi-host coordination ledger (docs/fault_tolerance.md
    "Multi-host coordination"): which host each preemption notice landed
    on, peer aborts attributed by (dead host, cause), two-phase commit
    aborts, and cadence retunes — the per-host attribution a multi-host
    post-mortem starts from."""
    out: Dict[str, Any] = {}
    hosts = sorted({e["host"] for e in events
                    if e.get("kind") == "run_start"
                    and e.get("host") is not None})
    if hosts:
        out["hosts"] = hosts
    # every host journals its own copy of a CLUSTER event (one
    # preemption -> N `preemption` records, one torn commit -> up to N
    # `commit_abort`s), so cluster incidents dedup by their identity
    # (notice_host+iteration / iteration); per-host OBSERVATIONS
    # (peer_abort) stay counted as such — who saw it is the information.
    notices: Dict[str, int] = {}
    for key in {(e["notice_host"], e.get("iteration")) for e in events
                if e.get("kind") == "preemption"
                and e.get("notice_host") is not None}:
        label = f"host {key[0]}"
        notices[label] = notices.get(label, 0) + 1
    if notices:
        out["preemption_notices_by_host"] = notices
    peer: Dict[str, int] = {}
    for e in events:
        if e.get("kind") == "peer_abort":
            key = f"host {e.get('host')}: {e.get('cause')}"
            peer[key] = peer.get(key, 0) + 1
    if peer:
        out["peer_aborts"] = peer
    commit_aborts = sorted({e.get("iteration") for e in events
                            if e.get("kind") == "commit_abort"})
    if commit_aborts:
        out["commit_aborts"] = {
            "total": len(commit_aborts),
            "iterations": commit_aborts,
        }
    retunes = [e for e in events if e.get("kind") == "cadence_retune"]
    if retunes:
        out["cadence_retunes"] = {
            "total": len(retunes),
            "last_interval": retunes[-1].get("to_interval"),
        }
    return out


def _summarize_serving(events: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Serving section (docs/serving.md "Fleet"): per-request TTFT/TPOT
    percentiles off the engine's `serve_request` events, the router's
    retry/failover ledger off `serve_route`, and the fleet lifecycle
    counters (breaker opens, readmits, drains, weight reloads)."""
    reqs = [e for e in events if e.get("kind") == "serve_request"]
    routes = [e for e in events if e.get("kind") == "serve_route"]
    specs = [e for e in events if e.get("kind") == "serve_spec"]
    comms = [e for e in events if e.get("kind") == "comm_policy"]
    migrations = [e for e in events if e.get("kind") == "serve_migrate"]
    resampled = sum(1 for e in events
                    if e.get("kind") == "serve_retry_resampled")
    out: Dict[str, Any] = {}
    if migrations or resampled:
        # churn ledger (docs/fault_tolerance.md "Serving state
        # migration"): handoff outcomes down the degradation ladder
        # (migrated > recomputed > retried > rejected), importer-side
        # path split, and the KV wire bytes the manifest cost model
        # charged for successful transfers
        by_outcome: Dict[str, int] = {}
        for e in migrations:
            if e.get("stage") == "handoff_done":
                o = str(e.get("outcome", "?"))
                by_outcome[o] = by_outcome.get(o, 0) + 1
        import_paths: Dict[str, int] = {}
        for e in migrations:
            if e.get("stage") == "import":
                p = str(e.get("path", "?"))
                import_paths[p] = import_paths.get(p, 0) + 1
        wire = sum(int(e.get("wire_bytes", 0)) for e in migrations
                   if e.get("stage") == "handoff" and e.get("ok"))
        mig: Dict[str, Any] = {"by_outcome": by_outcome,
                               "imports_by_path": import_paths,
                               "wire_bytes": wire}
        if resampled:
            mig["retries_resampled"] = resampled
        out["migrations"] = mig
    if comms:
        # one comm_policy record per engine build (docs/serving.md
        # "Compressed collectives"): which TP collectives run
        # compressed and the static per-tick wire prices — their ratio
        # IS the compression ratio the engine_comm_*_bytes_total
        # counters realize live
        c = comms[-1]
        dense = int(c.get("dense_bytes_per_tick", 0))
        comp = int(c.get("compressed_bytes_per_tick", 0))
        out["comm"] = {
            "mode": c.get("mode"), "sites": c.get("sites"),
            "tp": c.get("tp"), "chunk": c.get("chunk"),
            "dense_bytes_per_tick": dense,
            "compressed_bytes_per_tick": comp,
            "compression_ratio": round(dense / max(comp, 1), 3),
        }
    if specs:
        # serve_spec records are cumulative per engine process (emitted
        # on each retire); the LAST one is the totals. accept_rate is
        # accepted/proposed drafts; tokens_per_forward is emitted
        # tokens over decode ticks — the effective speedup numerator
        # (1.0 = plain decode, k+1 = every draft accepted).
        s = specs[-1]
        out["speculative"] = {
            "drafter": s.get("drafter"), "k": s.get("k"),
            "proposed": int(s.get("proposed", 0)),
            "accepted": int(s.get("accepted", 0)),
            "accept_rate": round(
                s.get("accepted", 0) / max(s.get("proposed", 0), 1), 4),
            "tokens_per_forward": round(
                s.get("emitted", 0) / max(s.get("ticks", 0), 1), 3),
        }
    if reqs:
        by_status: Dict[str, int] = {}
        for e in reqs:
            s = str(e.get("status", "?"))
            by_status[s] = by_status.get(s, 0) + 1
        out["requests"] = {"total": len(reqs), "by_status": by_status}
        for field, label in (("ttft_s", "ttft_s"), ("tpot_s", "tpot_s"),
                             ("wall_s", "request_wall_s")):
            vals = sorted(float(e[field]) for e in reqs if field in e)
            if vals:
                out[label] = {"p50": round(percentile(vals, 0.50), 4),
                              "p95": round(percentile(vals, 0.95), 4),
                              "p99": round(percentile(vals, 0.99), 4)}
    if routes:
        retries = sum(max(0, int(e.get("attempts", 1)) - 1) for e in routes)
        failovers = sum(1 for e in routes
                        if int(e.get("attempts", 1)) > 1
                        and int(e.get("status", 0)) == 200)
        out["router"] = {
            "routed": len(routes),
            "retries": retries,
            "failovers": failovers,
            "exhausted": sum(1 for e in routes if e.get("exhausted")),
        }
    lifecycle = {
        "breaker_opens": sum(1 for e in events
                             if e.get("kind") == "replica_breaker_open"),
        "readmits": sum(1 for e in events
                        if e.get("kind") == "replica_readmitted"),
        "drains": sum(1 for e in events
                      if e.get("kind") == "serve_drain_begin"),
        # one /admin/reload emits BOTH kinds (engine swap + service
        # record) into the same journal; engine-less (one-shot) servers
        # emit only serve_weight_reload and bare update_params callers
        # only weight_reload — max() counts each reload once either way
        "weight_reloads": max(
            sum(1 for e in events if e.get("kind") == "weight_reload"),
            sum(1 for e in events
                if e.get("kind") == "serve_weight_reload")),
    }
    if any(lifecycle.values()):
        out["fleet"] = lifecycle
    return out


#: --format json layout: section -> the summary keys it owns. CI and
#: bench tooling key off the section names, not the text tables.
SECTIONS = {
    "run": ("events", "steps", "checkpoints", "process_segments"),
    "goodput": ("goodput_pct", "wall_s", "split_s"),
    "steps": ("step_ms", "tokens_per_s", "data_wait_ms", "last_loss",
              "step_compiles", "compile_cache_hits"),
    "stalls": ("stall_top",),
    "resilience": ("faults", "divergences", "preemptions",
                   "preemption_timeouts", "hangs", "sdc_detected",
                   "elastic_resumes"),
    "serving": ("serving",),
    "coordination": ("coordination",),
}


def to_sections(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The per-section view --format json emits: every summary key
    grouped under a stable section name, empty sections dropped."""
    out: Dict[str, Any] = {}
    for section, keys in SECTIONS.items():
        body: Dict[str, Any] = {}
        for key in keys:
            if key in ("serving", "coordination"):
                body.update(summary.get(key) or {})
            elif summary.get(key) not in (None, [], {}):
                body[key] = summary[key]
        if body:
            out[section] = body
    return out


def write_perfetto(paths: List[str], out_path: str) -> Dict[str, Any]:
    """Render one Perfetto-loadable timeline from N per-host journals
    (telemetry/perfetto.py)."""
    from megatron_tpu_torch.telemetry.perfetto import journals_to_trace_events

    trace = journals_to_trace_events(
        [(path, load_journal(path)) for path in paths])
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f, separators=(",", ":"))
    return trace


def render(summary: Dict[str, Any]) -> str:
    lines = [f"journal: {summary['events']} events, "
             f"{summary['steps']} steps, "
             f"{summary['checkpoints']} checkpoints committed"]
    if "goodput_pct" in summary:
        split = summary["split_s"]
        parts = " | ".join(f"{c}: {split[c]:.1f}s" for c in CATEGORIES
                           if split.get(c))
        lines.append(f"goodput: {summary['goodput_pct']:.2f}% of "
                     f"{summary['wall_s']:.1f}s wall ({parts})")
    if summary.get("stall_top"):
        lines.append("longest stalls:")
        for s in summary["stall_top"]:
            where = (f" @ iteration {s['iteration']}"
                     if s.get("iteration") is not None else "")
            lines.append(f"  {s['seconds']:9.3f}s  {s['kind']}{where}")
    if "step_ms" in summary:
        p = summary["step_ms"]
        lines.append(f"step time ms: p50 {p['p50']} | p90 {p['p90']} | "
                     f"p99 {p['p99']} | max {p['max']}")
    if "tokens_per_s" in summary:
        t = summary["tokens_per_s"]
        lines.append(f"tokens/s: p50 {t['p50']} | max {t['max']}")
    if "data_wait_ms" in summary:
        w = summary["data_wait_ms"]
        lines.append(f"data wait ms: p50 {w['p50']} | p99 {w['p99']} | "
                     f"max {w['max']}")
    if summary.get("compile_cache_hits"):
        lines.append(
            f"compile cache hits: {summary['compile_cache_hits']} "
            "(warm persistent cache)")
    if summary.get("last_loss") is not None:
        lines.append(f"last loss: {summary['last_loss']}")
    if "serving" in summary:
        sv = summary["serving"]
        if "requests" in sv:
            r = sv["requests"]
            lines.append(f"serving: {r['total']} requests "
                         f"{r['by_status']}")
        for key, label in (("ttft_s", "ttft s"), ("tpot_s", "tpot s"),
                           ("request_wall_s", "request wall s")):
            if key in sv:
                p = sv[key]
                lines.append(f"  {label}: p50 {p['p50']} | "
                             f"p95 {p['p95']} | p99 {p['p99']}")
        if "speculative" in sv:
            s = sv["speculative"]
            lines.append(
                f"  speculative ({s['drafter']}, k={s['k']}): "
                f"accept rate {s['accept_rate']} | "
                f"{s['tokens_per_forward']} tokens/forward")
        if "comm" in sv:
            c = sv["comm"]
            lines.append(
                f"  compressed collectives ({c['mode']}, tp={c['tp']}, "
                f"sites {c['sites']}): {c['compression_ratio']}x fewer "
                f"wire bytes ({c['dense_bytes_per_tick']} -> "
                f"{c['compressed_bytes_per_tick']} B/tick)")
        if "router" in sv:
            r = sv["router"]
            lines.append(f"  router: {r['routed']} routed | "
                         f"{r['retries']} retries | "
                         f"{r['failovers']} failovers | "
                         f"{r['exhausted']} exhausted")
        if "fleet" in sv:
            f = sv["fleet"]
            lines.append(f"  fleet: {f['breaker_opens']} breaker opens | "
                         f"{f['readmits']} readmits | "
                         f"{f['drains']} drains | "
                         f"{f['weight_reloads']} weight reloads")
        if "migrations" in sv:
            m = sv["migrations"]
            by = m.get("by_outcome", {})
            ladder = " | ".join(
                f"{by.get(o, 0)} {o}" for o in
                ("migrated", "recomputed", "retried", "rejected"))
            lines.append(f"  migrations: {ladder} | "
                         f"{m.get('wire_bytes', 0)} KV wire bytes")
            if m.get("imports_by_path"):
                lines.append("  migration imports: " + " | ".join(
                    f"{v} {k}" for k, v in
                    sorted(m["imports_by_path"].items())))
            if m.get("retries_resampled"):
                lines.append(f"  unseeded sampled retries (journaled "
                             f"serve_retry_resampled): "
                             f"{m['retries_resampled']}")
    if summary.get("faults"):
        lines.append(f"injected faults: {summary['faults']}")
    if summary.get("divergences"):
        lines.append(f"divergence trips: {summary['divergences']}")
    resilience_counts = [
        (k, label) for k, label in (
            ("preemptions", "preemptions"),
            ("preemption_timeouts", "preempt-save timeouts"),
            ("hangs", "hangs detected"),
            ("sdc_detected", "SDC detected"),
            ("elastic_resumes", "elastic resumes"))
        if summary.get(k)]
    if resilience_counts:
        lines.append("resilience: " + " | ".join(
            f"{summary[k]} {label}" for k, label in resilience_counts))
    if "coordination" in summary:
        co = summary["coordination"]
        if co.get("hosts"):
            lines.append(f"coordination: hosts {co['hosts']}")
        if co.get("preemption_notices_by_host"):
            lines.append("  preemption notices: " + " | ".join(
                f"{k}: {v}"
                for k, v in co["preemption_notices_by_host"].items()))
        if co.get("peer_aborts"):
            lines.append("  peer aborts: " + " | ".join(
                f"{k}: {v}" for k, v in co["peer_aborts"].items()))
        if co.get("commit_aborts"):
            ca = co["commit_aborts"]
            lines.append(f"  commit aborts: {ca['total']} "
                         f"@ iterations {ca['iterations']}")
        if co.get("cadence_retunes"):
            cr = co["cadence_retunes"]
            lines.append(f"  cadence retunes: {cr['total']} "
                         f"(current interval {cr['last_interval']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("journal", nargs="+",
                    help="journal file(s) or telemetry dir(s) — pass one "
                         "per host for a merged multi-host report")
    ap.add_argument("--json", action="store_true",
                    help="emit the flat summary as one JSON object "
                         "(legacy; prefer --format json)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="json = machine-readable per-section dicts "
                         "(run/goodput/steps/stalls/resilience/serving/"
                         "coordination) for CI and bench tooling")
    ap.add_argument("--perfetto", metavar="OUT.json", default=None,
                    help="also write the journals as ONE Chrome "
                         "trace-event timeline (load at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--top", type=int, default=5,
                    help="entries in the stall top-list")
    args = ap.parse_args(argv)
    summary = summarize(load_journals(args.journal), top_n=args.top)
    if args.perfetto:
        trace = write_perfetto(args.journal, args.perfetto)
        print(f"# perfetto: wrote {len(trace['traceEvents'])} trace "
              f"events for {len(args.journal)} journal(s) to "
              f"{args.perfetto}", file=sys.stderr)
    if args.json:
        print(json.dumps(summary, indent=1))
    elif args.format == "json":
        print(json.dumps(to_sections(summary), indent=1))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
