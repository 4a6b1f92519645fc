"""trace_report: read torch.profiler Chrome traces, print the comm/compute
story (counterpart of tools/trace_report.py).

    python -m megatron_tpu_torch.tools.trace_report runs/profile   # newest
    python -m megatron_tpu_torch.tools.trace_report trace-steps-3-4-pid7.json
    python -m megatron_tpu_torch.tools.trace_report DIR --top 20
    python -m megatron_tpu_torch.tools.trace_report DIR --contract \\
        train_tp2_sp --executions 2 --check
    python -m megatron_tpu_torch.tools.trace_report DIR --format json
    python -m megatron_tpu_torch.tools.trace_report DIR \\
        --emit-comm-policy policy.json --exposed-threshold 0.25

Works on any trace the port writes: the training loop's --profile window
(training/pretrain.py, one ``trace-steps-<start>-<end>-pid<n>.json``
per window; a directory is searched for ``*trace*.json[.gz]``) and the
profilers under tools/. Prints the card's busy and idle share of the
trace's window and the comm.* ranges' share, the per-op self-time table,
the compute / collective / infeed split with each collective's total vs.
EXPOSED time (not covered by a kernel), per-step wall from the
``train_step`` (or ``ProfilerStep#N``) markers, and with ``--contract
NAME`` the measured-vs-expected comm.* counts against the golden
manifest (megatron_tpu_torch/analysis/golden/NAME.json, or a path).

It never imports torch: the reader is stdlib only, and the comm policy
module is loaded from its file, so a trace copied off the card reads
anywhere.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

from megatron_tpu_torch.telemetry.tracing.analyze import (
    analyze_trace, compare_contract,
)
from megatron_tpu_torch.telemetry.tracing.events import (
    ChromeTrace, find_trace_files, load_chrome_trace,
)

_PKG = Path(__file__).resolve().parent.parent
GOLDEN_DIR = _PKG / "analysis" / "golden"
_POLICY = "megatron_tpu_torch.quant.policy"


def policy_module():
    """quant/policy.py (stdlib only) without importing the quant package,
    whose other modules import torch."""
    if _POLICY in sys.modules:
        return sys.modules[_POLICY]
    spec = importlib.util.spec_from_file_location(
        "_trace_report_policy", _PKG / "quant" / "policy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traces(path: str, all_files: bool = False) -> ChromeTrace:
    """The newest trace under `path` (or every one, merged: their events
    and the window from the first start to the last end)."""
    files = find_trace_files(path, latest_only=not all_files)
    if not files:
        raise FileNotFoundError(f"no *trace*.json[.gz] file under {path}")
    traces = [load_chrome_trace(f) for f in files]
    if len(traces) == 1:
        return traces[0]
    events = sorted((e for t in traces for e in t.events),
                    key=lambda e: (e.start_ps, e.end_ps))
    return ChromeTrace(path=path, events=events,
                       window_ps=(min(t.window_ps[0] for t in traces),
                                  max(t.window_ps[1] for t in traces)))


def manifest_path(contract: str) -> Path:
    path = Path(contract)
    return path if path.suffix == ".json" else GOLDEN_DIR / f"{contract}.json"


def _fmt_s(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f}ms"
    return f"{s * 1e6:.1f}us"


def render_text(report, comparison, top: int, files) -> str:
    lines = [f"trace: {len(files)} Chrome trace file(s): "
             + ", ".join(str(f) for f in files)]
    card = report.card
    if card is not None:
        lines.append(
            f"card: window {card.window_ms:.3f}ms | kernels busy "
            f"{card.busy_ms:.3f}ms ({card.kernels} kernels) | idle share "
            f"{card.idle_share:.4f} | comm.* {card.comm_ms:.3f}ms "
            f"(share {card.comm_share:.4f})")
    lines.append(
        f"busy split: compute {_fmt_s(report.compute_s)} | "
        f"collective {_fmt_s(report.collective_s)} "
        f"(exposed {_fmt_s(report.exposed_collective_s)}) | "
        f"infeed {_fmt_s(report.busy_s.get('infeed', 0.0))} | "
        f"host {_fmt_s(report.busy_s.get('host', 0.0))} | "
        f"op wall {_fmt_s(report.wall_s)}")
    if report.collectives:
        lines.append("collectives (total vs exposed = not covered by a "
                     "kernel):")
        for c in report.collectives:
            lines.append(
                f"  {c.op:<20} x{c.count:<6} total "
                f"{_fmt_s(c.total_ps / 1e12):>10}  exposed "
                f"{_fmt_s(c.exposed_ps / 1e12):>10} "
                f"({100 * c.exposed_frac:.1f}%)")
    if report.steps:
        lines.append("steps (step marker spans):")
        for name, st in sorted(report.steps.items(),
                               key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"  {name:<32} x{st['count']:<5} "
                         f"p50 {st['p50_ms']}ms  max {st['max_ms']}ms")
    lines.append(f"top {top} ops by self time:")
    for o in report.ops[:top]:
        lines.append(f"  {o.self_s * 1e3:10.3f}ms  x{o.count:<6} "
                     f"[{o.kind[:4]}] {o.name}")
    if comparison is not None:
        lines.append(
            f"contract {comparison.config} ({comparison.level} level, "
            f"{comparison.executions or '?'} executions): "
            + ("measured == expected"
               if comparison.matches else "MISMATCH"))
        for row in comparison.rows:
            lines.append(
                f"  {row['op']:<20} expected {row['expected_per_exec']}"
                f"/exec -> {row['expected_total']}  measured "
                f"{row['measured_total']}  "
                f"{'ok' if row['ok'] else 'MISMATCH'}")
        for p in comparison.problems:
            lines.append(f"  ! {p}")
        for op, bw in comparison.bandwidth.items():
            lines.append(
                f"  {op:<20} {bw['bytes_total']} bytes -> bus "
                f"{bw['bus_gbps']} GB/s (exposed-only "
                f"{bw['exposed_gbps']} GB/s)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a trace file or a directory of them")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the op table")
    ap.add_argument("--contract", default=None,
                    help="comm contract to hold the measured comm.* "
                         "counts against (a golden name such as "
                         "train_tp2_sp, or a manifest path)")
    ap.add_argument("--executions", type=int, default=None,
                    help="traced ranks x profiled steps for the contract "
                         "check (default: inferred from the counts)")
    ap.add_argument("--all-files", action="store_true",
                    help="read every trace under the directory, not just "
                         "the newest")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--check", action="store_true",
                    help="with --contract: exit 1 on measured != expected")
    ap.add_argument("--emit-comm-policy", metavar="OUT.json", default=None,
                    help="derive the compressed-collective site policy "
                         "from this trace's per-collective EXPOSED "
                         "fractions (quant/policy.py) and write it as "
                         "JSON; serve it with --serve_comm_policy")
    ap.add_argument("--exposed-threshold", type=float, default=0.25,
                    help="exposed fraction at/above which a collective "
                         "kind's sites compress (default 0.25)")
    args = ap.parse_args(argv)

    try:
        trace = load_traces(args.trace, args.all_files)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    files = find_trace_files(args.trace, latest_only=not args.all_files)
    report = analyze_trace(trace)

    comparison = None
    if args.contract:
        path = manifest_path(args.contract)
        if not path.exists():
            print(f"no golden manifest {path}", file=sys.stderr)
            return 1
        comparison = compare_contract(
            report, json.loads(path.read_text()), path.stem,
            executions=args.executions)

    if args.emit_comm_policy:
        policy_mod = policy_module()
        exposure = {c.op: round(c.exposed_frac, 4)
                    for c in report.collectives}
        policy = policy_mod.policy_from_exposure(
            exposure, threshold=args.exposed_threshold,
            source=f"trace:{args.trace}")
        site_exposure = {
            site: exposure.get(kind, 0.0)
            for site, kind in policy_mod.SITE_COLLECTIVES.items()}
        doc = dict(policy.to_dict(), exposure=exposure,
                   site_exposure=site_exposure)
        with open(args.emit_comm_policy, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"# comm policy -> {args.emit_comm_policy}: "
              + ", ".join(f"{s}={'on' if v else 'off'}"
                          for s, v in sorted(doc["sites"].items())),
              file=sys.stderr)

    if args.format == "json":
        out = {"files": files, "report": report.to_dict(top=args.top)}
        if comparison is not None:
            out["contract"] = comparison.to_dict()
        print(json.dumps(out, indent=1))
    else:
        print(render_text(report, comparison, args.top, files))
    if args.check and comparison is not None and not comparison.matches:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
