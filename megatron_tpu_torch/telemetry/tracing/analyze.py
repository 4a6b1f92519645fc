"""Trace analysis: comm/compute split, exposed time, contract check
(counterpart of megatron_tpu/telemetry/tracing/analyze.py; stdlib only).

The JAX package's three results over classified op events, computed the
same way, plus the card-side numbers of a torch.profiler trace:

  * **op table** — per-op count/total/self time, the busy split compute /
    collective / infeed / host, and per-step wall from the step markers
    (events.step_markers: the loop's ``train_step`` ranges or
    ``ProfilerStep#N``).
  * **exposed collective time** — per collective base, total time vs.
    the time NOT covered by compute. A collective event inside another
    collective event of its line (a process group's op inside a host
    comm.* range) adds no time of its own. A collective on a card's timeline
    (an NCCL kernel) is held against that card's compute, as the JAX
    package holds a device plane's; a host comm.* range against the
    kernels of every card in the trace (the host range is exposed where
    no kernel runs under it).
  * **measured vs. expected** — collective counts joined against a comm
    contract: the port's manifests (analysis/golden/*.json, a ``comm``
    section of comm.* counts per step) or the JAX package's (``hlo`` or
    ``jaxpr`` sections).
  * **the card's share** (Chrome traces: ``analyze_trace``) — the
    window (first start to last end over every complete event), the
    union of its kernels (busy) and the idle share 1 - busy/window, and
    the union of the host comm.* ranges over the same window with each
    range's summed milliseconds.

Events on one line nest, so every per-op sum uses SELF time, as in the
JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from megatron_tpu_torch.analysis.taxonomy import (
    COLLECTIVE_PRIMITIVES, is_collective_done_half,
)
from megatron_tpu_torch.telemetry.tracing.events import (
    DEVICE_COMPUTE_CATS, KIND_COLLECTIVE, KIND_COMPUTE, KIND_HOST,
    KIND_INFEED, ChromeTrace, OpEvent, comm_ranges, load_chrome_trace,
    modules, step_markers,
)

PS_PER_S = 1e12


# -- interval arithmetic ------------------------------------------------------


def merge_intervals(intervals: Iterable[Tuple[int, int]]
                    ) -> List[Tuple[int, int]]:
    """Union of [start, end) intervals as a sorted disjoint list."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap_ps(start: int, end: int,
               merged: List[Tuple[int, int]],
               starts: Optional[List[int]] = None) -> int:
    """Length of [start, end) covered by a merged interval list."""
    if end <= start or not merged:
        return 0
    if starts is None:
        starts = [s for s, _ in merged]
    i = max(bisect.bisect_right(starts, start) - 1, 0)
    covered = 0
    while i < len(merged):
        s, e = merged[i]
        if s >= end:
            break
        covered += max(0, min(e, end) - max(s, start))
        i += 1
    return covered


# -- report dataclasses -------------------------------------------------------


def self_segments(events_on_line: List[OpEvent]
                  ) -> List[Tuple[OpEvent, List[Tuple[int, int]], int]]:
    """(event, self-intervals, self_ps) per event of ONE line.

    Containment nesting via a sweep stack: an event starting inside the
    previous event's span is its child; a parent's self time is its span
    minus the union of its children's spans (clamped to the parent).
    Zero-duration marker events neither nest nor mask anything."""
    zero = [e for e in events_on_line if e.duration_ps <= 0]
    evs = sorted((e for e in events_on_line if e.duration_ps > 0),
                 key=lambda e: (e.start_ps, -e.end_ps))
    children: Dict[int, List[Tuple[int, int]]] = {}
    stack: List[OpEvent] = []
    for e in evs:
        while stack and stack[-1].end_ps <= e.start_ps:
            stack.pop()
        if stack:
            p = stack[-1]
            children.setdefault(id(p), []).append(
                (e.start_ps, min(e.end_ps, p.end_ps)))
        stack.append(e)
    out = []
    for e in evs:
        covered = merge_intervals(children.get(id(e), ()))
        segs: List[Tuple[int, int]] = []
        cursor = e.start_ps
        for s, c_end in covered:
            if s > cursor:
                segs.append((cursor, s))
            cursor = max(cursor, c_end)
        if cursor < e.end_ps:
            segs.append((cursor, e.end_ps))
        out.append((e, segs, sum(b - a for a, b in segs)))
    # zero-duration events still count (op counts, markers) — they just
    # own no time and mask nothing
    out.extend((e, [], 0) for e in zero)
    return out


def _nested_collectives(events_on_line: List[OpEvent]) -> set:
    """ids of the collective events of one line that lie inside another
    collective event of it: a host comm.* range holds its process
    group's own ops (gloo:all_reduce, c10d::allreduce_), which are the
    same call's time and must not add to the collective totals again."""
    colls = sorted((e for e in events_on_line
                    if e.kind == KIND_COLLECTIVE and e.duration_ps > 0),
                   key=lambda e: (e.start_ps, -e.end_ps))
    inner, end = set(), None
    for e in colls:
        if end is not None and e.end_ps <= end:
            inner.add(id(e))
        else:
            end = e.end_ps
    return inner


@dataclasses.dataclass
class OpAgg:
    name: str
    kind: str
    count: int
    total_ps: int       # summed event spans (children included)
    self_ps: int        # summed self time (what the op itself ran)

    @property
    def total_s(self) -> float:
        return self.total_ps / PS_PER_S

    @property
    def self_s(self) -> float:
        return self.self_ps / PS_PER_S


@dataclasses.dataclass
class CollectiveAgg:
    op: str               # base mnemonic ("all-reduce")
    count: int
    total_ps: int
    exposed_ps: int

    @property
    def exposed_frac(self) -> float:
        return self.exposed_ps / self.total_ps if self.total_ps else 0.0


@dataclasses.dataclass
class CardShare:
    """The card's busy and idle share of a trace's window, and the host
    comm.* ranges' share of it (milliseconds)."""

    window_ms: float
    busy_ms: float          # union of the kernels
    idle_share: float       # 1 - busy / window
    kernels: int            # kernel events
    comm_ms: float          # union of the host comm.* ranges
    comm_share: float       # comm / window
    comm_ms_by_op: Dict[str, float]  # range name -> summed milliseconds


def _union_ps(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in merge_intervals(intervals))


def card_share(events: List[OpEvent], window_ps: Tuple[int, int]
               ) -> CardShare:
    """CardShare of a trace's events over its window."""
    window = window_ps[1] - window_ps[0]
    kernels = [e for e in events if e.category in DEVICE_COMPUTE_CATS]
    busy = _union_ps((e.start_ps, e.end_ps) for e in kernels)
    ranges = comm_ranges(events)
    comm = _union_ps((e.start_ps, e.end_ps) for e in ranges)
    by_op: Dict[str, float] = {}
    for e in ranges:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.duration_ps / 1e9
    nan = float("nan")
    return CardShare(
        window_ms=window / 1e9, busy_ms=busy / 1e9,
        idle_share=1.0 - busy / window if window > 0 else nan,
        kernels=len(kernels), comm_ms=comm / 1e9,
        comm_share=comm / window if window > 0 else nan,
        comm_ms_by_op=by_op)


@dataclasses.dataclass
class TraceReport:
    module: Optional[str]                 # module the op table covers
    wall_s: float                         # span of the module's op events
    busy_s: Dict[str, float]              # kind -> summed event seconds
    ops: List[OpAgg]                      # per-op aggregation, by time desc
    collectives: List[CollectiveAgg]      # per-mnemonic comm split
    steps: Dict[str, Dict[str, float]]    # step marker -> wall stats (ms)
    all_modules: Dict[str, float]         # module -> total op seconds
    card: Optional["CardShare"] = None    # Chrome traces (analyze_trace)

    @property
    def compute_s(self) -> float:
        return self.busy_s.get(KIND_COMPUTE, 0.0)

    @property
    def collective_s(self) -> float:
        return self.busy_s.get(KIND_COLLECTIVE, 0.0)

    @property
    def exposed_collective_s(self) -> float:
        return sum(c.exposed_ps for c in self.collectives) / PS_PER_S

    def collective_counts(self) -> Dict[str, int]:
        return {c.op: c.count for c in self.collectives}

    def to_dict(self, top: int = 15) -> Dict[str, Any]:
        return {
            "module": self.module,
            "wall_s": round(self.wall_s, 6),
            "busy_s": {k: round(v, 6) for k, v in sorted(self.busy_s.items())},
            "exposed_collective_s": round(self.exposed_collective_s, 6),
            "top_ops": [
                {"name": o.name, "kind": o.kind, "count": o.count,
                 "self_s": round(o.self_s, 6),
                 "total_s": round(o.total_s, 6)}
                for o in self.ops[:top]],
            "collectives": [
                {"op": c.op, "count": c.count,
                 "total_s": round(c.total_ps / PS_PER_S, 6),
                 "exposed_s": round(c.exposed_ps / PS_PER_S, 6),
                 "exposed_frac": round(c.exposed_frac, 4)}
                for c in self.collectives],
            "steps": self.steps,
            "modules": {m: round(s, 6)
                        for m, s in sorted(self.all_modules.items())},
            **({"card": dataclasses.asdict(self.card)}
               if self.card is not None else {}),
        }


# -- the analysis pass --------------------------------------------------------


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def analyze_events(events: List[OpEvent],
                   module: Optional[str] = None) -> TraceReport:
    """Aggregate classified events into a TraceReport.

    module: restrict the op table / split / exposed computation to one
    module (the JAX package's events carry their hlo module); default is
    the module with the most op time. A Chrome trace's events carry none,
    so the whole trace is reported.
    """
    per_module = {m: ps / PS_PER_S for m, ps in modules(events).items()}
    if module is None and per_module:
        module = max(per_module, key=per_module.get)

    # one nesting pass per (plane, line): self time for every event, and
    # the compute SELF segments feeding the exposure union
    by_line: Dict[Tuple[str, str], List[OpEvent]] = {}
    for e in events:
        by_line.setdefault((e.plane, e.line), []).append(e)

    busy_ps: Dict[str, int] = {KIND_HOST: 0}
    per_op: Dict[Tuple[str, str], OpAgg] = {}
    compute_segs: Dict[str, List[Tuple[int, int]]] = {}  # plane -> segs
    coll_events: Dict[str, List[OpEvent]] = {}           # plane -> events
    xla_span: List[int] = []  # [min_start, max_end] of the module's ops
    for (plane, _line), line_events in by_line.items():
        inner = _nested_collectives(line_events)
        for e, segs, self_ps in self_segments(line_events):
            if e.kind == KIND_HOST:
                busy_ps[KIND_HOST] += self_ps
                continue
            # compute from ANY module hides comm — overlap is overlap
            # regardless of which program the concurrent work belongs to
            if e.kind == KIND_COMPUTE:
                compute_segs.setdefault(plane, []).extend(segs)
            if module is not None and e.module != module:
                continue
            busy_ps[e.kind] = busy_ps.get(e.kind, 0) + self_ps
            agg = per_op.get((e.name, e.kind))
            if agg is None:
                per_op[(e.name, e.kind)] = OpAgg(
                    e.name, e.kind, 1, e.duration_ps, self_ps)
            else:
                agg.count += 1
                agg.total_ps += e.duration_ps
                agg.self_ps += self_ps
            if e.kind == KIND_COLLECTIVE and e.collective \
                    and id(e) not in inner:
                coll_events.setdefault(plane, []).append(e)
            if not xla_span:
                xla_span = [e.start_ps, e.end_ps]
            else:
                xla_span[0] = min(xla_span[0], e.start_ps)
                xla_span[1] = max(xla_span[1], e.end_ps)
    busy = {k: v / PS_PER_S for k, v in busy_ps.items()}

    collectives: Dict[str, CollectiveAgg] = {}
    every_card = [s for p, segs in compute_segs.items()
                  if not p.startswith("/host") for s in segs]
    for plane, evs in coll_events.items():
        # a host comm.* range is hidden where any card computes under it
        compute_union = merge_intervals(
            every_card if plane.startswith("/host")
            else compute_segs.get(plane, ()))
        starts = [s for s, _ in compute_union]
        for e in evs:
            hidden = overlap_ps(e.start_ps, e.end_ps, compute_union, starts)
            agg = collectives.get(e.collective)
            if agg is None:
                agg = collectives[e.collective] = CollectiveAgg(
                    e.collective, 0, 0, 0)
            # async pairs: the -done half's time is communication (the
            # wait) but the PAIR counts once, like the static contracts
            if not is_collective_done_half(e.name):
                agg.count += 1
            agg.total_ps += e.duration_ps
            agg.exposed_ps += e.duration_ps - hidden

    steps: Dict[str, Dict[str, float]] = {}
    for name, marks in step_markers(events).items():
        ms = sorted(m.duration_ps / 1e9 for m in marks)
        steps[name] = {
            "count": len(ms),
            "p50_ms": round(_percentile(ms, 0.5), 3),
            "max_ms": round(ms[-1], 3),
            "total_ms": round(sum(ms), 3),
        }

    wall_s = (xla_span[1] - xla_span[0]) / PS_PER_S if xla_span else 0.0
    return TraceReport(
        module=module,
        wall_s=wall_s,
        busy_s=busy,
        ops=sorted(per_op.values(), key=lambda o: -o.self_ps),
        collectives=sorted(collectives.values(), key=lambda c: -c.total_ps),
        steps=steps,
        all_modules=per_module,
    )


def analyze_trace(trace: Union[str, ChromeTrace],
                  module: Optional[str] = None) -> TraceReport:
    """analyze_events over one Chrome trace (a path or a loaded one),
    with the card's share of its window (TraceReport.card)."""
    if isinstance(trace, str):
        trace = load_chrome_trace(trace)
    report = analyze_events(trace.events, module=module)
    report.card = card_share(trace.events, trace.window_ps)
    return report


# -- golden-contract comparison ----------------------------------------------

#: jaxpr collective primitive -> the HLO mnemonic its thunk traces as
#: (for manifests without an ``hlo`` section: can_compile=False configs)
_JAXPR_TO_HLO = {
    "psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
    "ppermute": "collective-permute",
    "pbroadcast": "collective-broadcast",
    "all_gather": "all-gather", "all_to_all": "all-to-all",
    "reduce_scatter": "reduce-scatter", "psum_scatter": "reduce-scatter",
    "pgather": "all-gather", "ragged_all_to_all": "ragged-all-to-all",
}


def expected_collectives(manifest: Dict[str, Any]
                         ) -> Tuple[Dict[str, int], Dict[str, int], str]:
    """(per-execution counts, per-execution bytes, level) pinned by a
    golden manifest. A port manifest's ``comm`` section (comm.* calls and
    wire bytes per step) comes first. Else the ``hlo`` section (post-GSPMD static op counts —
    what the runtime thunks execute once per device per step, loops
    aside) is authoritative when present; jaxpr-only manifests map their
    explicit primitives onto HLO mnemonics."""
    comm = manifest.get("comm", {}).get("collectives")
    if comm is not None:
        # the port's manifests: comm.* ranges per step, by base
        counts = {op: int(v["count"]) for op, v in comm.items()}
        bytes_ = {op: int(v.get("wire_bytes", 0)) for op, v in comm.items()}
        return counts, bytes_, "comm"
    hlo = manifest.get("hlo", {}).get("collectives")
    if hlo is not None:
        counts = {op: int(v["count"]) for op, v in hlo.items()}
        bytes_ = {op: int(v.get("total_bytes", 0)) for op, v in hlo.items()}
        return counts, bytes_, "hlo"
    counts: Dict[str, int] = {}
    bytes_: Dict[str, int] = {}
    for key, v in manifest.get("jaxpr", {}).get("collectives", {}).items():
        prim = key.split("[", 1)[0]
        if prim not in COLLECTIVE_PRIMITIVES:
            continue
        op = _JAXPR_TO_HLO.get(prim, prim)
        counts[op] = counts.get(op, 0) + int(v["count"])
        bytes_[op] = bytes_.get(op, 0) + int(v.get("total_bytes", 0))
    return counts, bytes_, "jaxpr"


@dataclasses.dataclass
class ContractComparison:
    config: str
    level: str                      # comm | hlo | jaxpr
    executions: Optional[int]       # devices x steps reconciling the counts
    rows: List[Dict[str, Any]]      # one per op: expected/measured/ok
    problems: List[str]
    bandwidth: Dict[str, Dict[str, float]]  # op -> bytes/bandwidth stats

    @property
    def matches(self) -> bool:
        return not self.problems

    def to_dict(self) -> Dict[str, Any]:
        return {"config": self.config, "level": self.level,
                "executions": self.executions, "matches": self.matches,
                "rows": self.rows, "problems": self.problems,
                "bandwidth": self.bandwidth}


def compare_contract(report: TraceReport, manifest: Dict[str, Any],
                     config: str,
                     executions: Optional[int] = None
                     ) -> ContractComparison:
    """measured-vs-expected collective counts for one golden contract.

    The manifest pins per-execution counts; the trace yields totals over
    (traced ranks x profiled steps) executions. With ``executions`` given the
    check is direct; otherwise it is inferred from the first op and must
    reconcile EVERY op (integer, identical) — a collective the contract
    doesn't know, a missing one, or inconsistent ratios (a collective
    inside a runtime loop) all land in ``problems``."""
    expected, exp_bytes, level = expected_collectives(manifest)
    measured = report.collective_counts()
    problems: List[str] = []
    inferred = executions
    if inferred is None:
        # anchor on the SMALLEST divisible ratio across ops: loop-carried
        # collectives run MORE often than the static count, never less,
        # so the minimum is the true execution count and the inflated
        # ops get flagged (anchoring on whichever op sorts first would
        # invert the attribution when a loop-carried op sorts early)
        ratios = [measured[op] // n for op, n in expected.items()
                  if n > 0 and measured.get(op, 0) > 0
                  and measured[op] % n == 0]
        if ratios:
            inferred = min(ratios)
    rows: List[Dict[str, Any]] = []
    for op in sorted(set(expected) | set(measured)):
        exp, got = expected.get(op, 0), measured.get(op, 0)
        want_total = exp * inferred if inferred else None
        ok = (got == want_total if want_total is not None
              else exp == 0 and got == 0)
        rows.append({"op": op, "expected_per_exec": exp,
                     "measured_total": got,
                     "expected_total": want_total, "ok": ok})
        if not ok:
            if exp == 0:
                problems.append(
                    f"{config}: UNEXPECTED collective {op}: measured "
                    f"{got}, contract pins none")
            elif got == 0:
                problems.append(
                    f"{config}: collective {op} NEVER RAN: contract "
                    f"expects {exp} per execution")
            else:
                problems.append(
                    f"{config}: {op}: measured {got} != expected "
                    f"{exp} x {inferred} executions (loop-carried "
                    f"collective, or the wrong module/trace?)")
    if inferred is None and any(expected.values()):
        problems.append(f"{config}: could not reconcile an execution "
                        "count from the measured totals")

    # effective bus bandwidth: the manifest's per-execution byte volume
    # over the measured time — `exposed` is the number Flash-Communication
    # compression would have to beat
    bandwidth: Dict[str, Dict[str, float]] = {}
    if inferred:
        per_coll = {c.op: c for c in report.collectives}
        for op, nbytes in sorted(exp_bytes.items()):
            c = per_coll.get(op)
            if c is None or not nbytes:
                continue
            total = nbytes * inferred
            bandwidth[op] = {
                "bytes_total": total,
                "bus_gbps": round(total / max(c.total_ps / PS_PER_S, 1e-12)
                                  / 1e9, 4),
                "exposed_gbps": round(
                    total / max(c.exposed_ps / PS_PER_S, 1e-12) / 1e9, 4),
            }
    return ContractComparison(config=config, level=level,
                              executions=inferred, rows=rows,
                              problems=problems, bandwidth=bandwidth)
