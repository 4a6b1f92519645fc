"""Typed, classified op events out of a torch.profiler Chrome trace
(counterpart of megatron_tpu/telemetry/tracing/events.py + xplane.py +
proto.py; stdlib only).

The JAX package decodes XSpace protobufs; torch.profiler writes the
Chrome trace-event JSON (``export_chrome_trace``, optionally gzipped),
so no decoder is needed. Every complete (``ph: "X"``) event becomes one
OpEvent of the JAX package's shape, timestamps converted from the
trace's microseconds to integer picoseconds:

  * ``cat: "kernel"`` — a kernel on the card: **compute**, or
    **collective** for an NCCL kernel (analysis/taxonomy.py);
  * ``cat: "gpu_memcpy"`` / ``"gpu_memset"`` — **infeed** (transfers);
  * a host ``comm.*`` range (parallel/mappings.py) — **collective**, the
    record that counts one call; a process group's own host op inside
    it (``gloo:all_reduce``, ``c10d::allreduce_``) is collective time
    that does not count again;
  * everything else on the host — **host**; among them the step markers:
    the training loop's ``train_step`` range (training/pretrain.py) and
    torch.profiler's ``ProfilerStep#N``.

torch.profiler writes each record_function range twice: on the host,
and as a ``gpu_user_annotation`` on the card's timeline. Only the host
copy is kept as an event (the copy would count every comm.* range
twice), but every complete event, copies included, spans the trace's
window (ChromeTrace.window_ps).

Planes: a host event's plane is ``/host:CPU:<pid>``, a card event's
``/device:GPU:<pid>`` (torch.profiler's pid of a card event is its
device index); the line is ``thread <tid>`` or ``stream <tid>``.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from megatron_tpu_torch.analysis.taxonomy import (
    collective_base, is_comm_range, is_transfer,
)

KIND_COMPUTE = "compute"
KIND_COLLECTIVE = "collective"
KIND_INFEED = "infeed"
KIND_HOST = "host"

#: the training loop's per-step range (the JAX package's step name) and
#: torch.profiler's own step markers
STEP_RANGES = ("train_step",)
PROFILER_STEP_RE = re.compile(r"^(ProfilerStep)#\d+$")

#: card-side event categories
DEVICE_COMPUTE_CATS = ("kernel",)
DEVICE_TRANSFER_CATS = ("gpu_memcpy", "gpu_memset")
#: the card-side copy of a host range
DEVICE_ANNOTATION_CAT = "gpu_user_annotation"

#: trace files in a directory: the loop's trace-steps-<a>-<b>-pid<n>.json,
#: torch.profiler's tensorboard handler's <host>.<n>.pt.trace.json
TRACE_PATTERNS = ("*trace*.json", "*trace*.json.gz")


@dataclasses.dataclass
class OpEvent:
    name: str
    kind: str            # compute | collective | infeed | host
    start_ps: int
    duration_ps: int
    plane: str
    line: str
    module: Optional[str] = None      # the JAX package's hlo_module
    collective: Optional[str] = None  # base mnemonic ("all-reduce")
    category: Optional[str] = None    # the Chrome trace's "cat"

    @property
    def end_ps(self) -> int:
        return self.start_ps + self.duration_ps


@dataclasses.dataclass
class ChromeTrace:
    """One trace's classified events and its window: [first start, last
    end] over every complete event of the file."""

    path: str
    events: List[OpEvent]
    window_ps: Tuple[int, int]


def _ps(us) -> int:
    # Chrome timestamps are microseconds with nanosecond decimals; going
    # through whole nanoseconds keeps integer picoseconds exact
    return int(round(float(us) * 1e3)) * 1000


def _read_json(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def _is_device(e: dict) -> bool:
    cat = str(e.get("cat", ""))
    return (cat in DEVICE_COMPUTE_CATS or cat in DEVICE_TRANSFER_CATS
            or cat.startswith("gpu_"))


def classify_chrome_events(raw: Iterable[dict]) -> Tuple[List[OpEvent],
                                                         Tuple[int, int]]:
    """(time-sorted OpEvents, window) of a trace's traceEvents."""
    out: List[OpEvent] = []
    lo = hi = None
    for e in raw:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        start = _ps(e["ts"])
        dur = _ps(e.get("dur", 0))
        lo = start if lo is None else min(lo, start)
        hi = start + dur if hi is None else max(hi, start + dur)
        cat = str(e.get("cat", ""))
        if cat == DEVICE_ANNOTATION_CAT:
            continue
        name = str(e.get("name", ""))
        pid, tid = e.get("pid", 0), e.get("tid", 0)
        base = None
        if _is_device(e):
            plane, line = f"/device:GPU:{pid}", f"stream {tid}"
            if cat in DEVICE_TRANSFER_CATS:
                kind = KIND_INFEED
            else:
                base = collective_base(name)
                kind = KIND_COLLECTIVE if base else KIND_COMPUTE
        else:
            plane, line = f"/host:CPU:{pid}", f"thread {tid}"
            base = collective_base(name)
            kind = (KIND_COLLECTIVE if base
                    else KIND_INFEED if is_transfer(name) else KIND_HOST)
        out.append(OpEvent(name=name, kind=kind, start_ps=start,
                           duration_ps=dur, plane=plane, line=line,
                           collective=base, category=cat or None))
    out.sort(key=lambda ev: (ev.start_ps, ev.end_ps))
    return out, ((lo, hi) if lo is not None else (0, 0))


def load_chrome_trace(path: str) -> ChromeTrace:
    """A torch.profiler Chrome trace (``.json`` or ``.json.gz``)."""
    events, window = classify_chrome_events(
        _read_json(path).get("traceEvents", []))
    return ChromeTrace(path=path, events=events, window_ps=window)


def find_trace_files(path: str, latest_only: bool = True) -> List[str]:
    """One trace file, or the traces under a directory (TRACE_PATTERNS;
    the loop's --profile_dir holds one per window): the newest one, or
    all of them in name order."""
    if os.path.isfile(path):
        return [path]
    files = sorted(
        f for pattern in TRACE_PATTERNS
        for f in glob.glob(os.path.join(path, "**", pattern),
                           recursive=True))
    if latest_only and files:
        return [max(files, key=os.path.getmtime)]
    return files


def modules(events: Iterable[OpEvent]) -> Dict[str, int]:
    """module name -> total op picoseconds. The port's events carry no
    module (a Chrome trace has no compiled program), so this is empty
    for them; the JAX package's synthetic events keep theirs."""
    out: Dict[str, int] = {}
    for e in events:
        if e.kind != KIND_HOST and e.module:
            out[e.module] = out.get(e.module, 0) + e.duration_ps
    return out


def step_markers(events: Iterable[OpEvent]) -> Dict[str, List[OpEvent]]:
    """Host step markers grouped by name: the loop's ``train_step``
    ranges and torch.profiler's ``ProfilerStep#N`` (as "ProfilerStep").
    A marker nested in the previous marker of its name is folded (one
    span per step)."""
    out: Dict[str, List[OpEvent]] = {}
    for e in events:
        if e.kind != KIND_HOST or e.duration_ps <= 0:
            continue
        m = PROFILER_STEP_RE.match(e.name)
        if m:
            out.setdefault(m.group(1), []).append(e)
        elif e.name in STEP_RANGES:
            out.setdefault(e.name, []).append(e)
    deduped: Dict[str, List[OpEvent]] = {}
    for name, marks in out.items():
        marks.sort(key=lambda e: (e.start_ps, -e.end_ps))
        kept: List[OpEvent] = []
        for e in marks:
            if kept and e.end_ps <= kept[-1].end_ps:
                continue
            kept.append(e)
        deduped[name] = kept
    return deduped


def comm_ranges(events: Iterable[OpEvent]) -> List[OpEvent]:
    """The host comm.* ranges (one per collective call)."""
    return [e for e in events
            if e.kind == KIND_COLLECTIVE and is_comm_range(e.name)
            and e.plane.startswith("/host")]
