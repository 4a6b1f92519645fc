"""Minimal Prometheus text-format scraping for the fleet control plane
(counterpart of megatron_tpu/inference/fleet/scrape.py, host code that
the port keeps as its own copy).

The router's prober reads the slot/queue gauges each replica already
exposes on /metrics (megatron_tpu_torch/telemetry/metrics.py: the
engine's engine_slots_active and engine_queue_depth), and the SLO
harness reads TTFT/TPOT percentiles off the engine histograms — across
process boundaries, so the in-process Histogram.percentile() helper is out
of reach and the text exposition is the contract. This parser covers
exactly what our registry renders (and standard Prometheus clients emit
compatibly): `name{label="v",...} value` sample lines, `#` comments.

No torch import: the router is pure host code.
"""

from __future__ import annotations

import math
import re
import urllib.request
from typing import Dict, List, Tuple

#: parsed exposition: metric name -> list of (labels, value)
Samples = Dict[str, List[Tuple[Dict[str, str], float]]]

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
#: strict mode: the whole brace interior must be well-formed pairs
#: (commas inside quoted values are fine — the value part is quoted)
_LABEL_PAIR = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_LABELS_FULL_RE = re.compile(
    rf"^(?:{_LABEL_PAIR})(?:,{_LABEL_PAIR})*,?$")
_TYPE_RE = re.compile(
    r"^#\s+TYPE\s+([a-zA-Z_:][a-zA-Z0-9_:]*)\s+(\w+)\s*$")
_HELP_RE = re.compile(r"^#\s+HELP\s+([a-zA-Z_:][a-zA-Z0-9_:]*)\s?(.*)$")
#: valid label-value escapes per the text format 0.0.4
_ESCAPE_RE = re.compile(r'\\(.)')
#: suffixes a histogram family's samples carry beyond its TYPE name
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


class ScrapeFormatError(ValueError):
    """Strict-mode parse failure: the exposition violates the format."""


def _unescape_label(value: str, strict: bool) -> str:
    def sub(m):
        c = m.group(1)
        if c == "n":
            return "\n"
        if c in ('"', "\\"):
            return c
        if strict:
            raise ScrapeFormatError(
                f"invalid label escape \\{c} (only \\\\, \\\", \\n)")
        # lenient: a third-party exposition's unknown escape passes
        # through VERBATIM (backslash kept) — dropping the backslash
        # would silently change the label value it keys series by
        return m.group(0)
    return _ESCAPE_RE.sub(sub, value)


def parse_prom_text(text: str, strict: bool = False) -> Samples:
    """Parse Prometheus text exposition into {name: [(labels, value)]}.

    strict=True enforces the format instead of skipping what doesn't
    parse: every non-comment line must be a valid sample with a parsable
    value, every sample's family must have been declared by a `# TYPE`
    line (histograms cover their `_bucket`/`_sum`/`_count` series), a
    family must not be re-declared, and label escapes must be the three
    legal ones. This is the round-trip gate on our own exposition
    (telemetry/metrics.py) — a renderer regression fails loudly here
    rather than silently dropping series off the router's scrape."""
    out: Samples = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                name, kind = m.groups()
                if strict and name in types:
                    raise ScrapeFormatError(
                        f"line {lineno}: family {name} re-declared")
                types[name] = kind
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            if strict:
                raise ScrapeFormatError(
                    f"line {lineno}: not a sample line: {line!r}")
            continue
        name, labelstr, raw = m.groups()
        if strict:
            family = name
            if family not in types:
                for suffix in _HISTOGRAM_SUFFIXES:
                    base = name[:-len(suffix)] if name.endswith(suffix) \
                        else None
                    if base and types.get(base) == "histogram":
                        family = base
                        break
                else:
                    raise ScrapeFormatError(
                        f"line {lineno}: sample {name} has no # TYPE "
                        "declaration")
            if labelstr and not _LABELS_FULL_RE.match(labelstr):
                # a malformed fragment between/after valid pairs would
                # otherwise be silently dropped
                raise ScrapeFormatError(
                    f"line {lineno}: malformed labels {{{labelstr}}}")
        labels = {k: _unescape_label(v, strict)
                  for k, v in _LABEL_RE.findall(labelstr or "")}
        try:
            value = float(raw)
        except ValueError:
            if strict:
                raise ScrapeFormatError(
                    f"line {lineno}: unparsable value {raw!r}")
            continue
        out.setdefault(name, []).append((labels, value))
    return out


def parse_prom_metadata(text: str) -> Dict[str, Dict[str, str]]:
    """{family: {"type": kind, "help": unescaped help}} off the comment
    lines — the metadata half of the round-trip with
    telemetry/metrics.py (_escape_help is the inverse)."""
    out: Dict[str, Dict[str, str]] = {}
    for line in text.splitlines():
        line = line.strip()
        m = _HELP_RE.match(line)
        if m:
            name, help_ = m.groups()
            # single-pass unescape, the inverse of metrics._escape_help
            out.setdefault(name, {})["help"] = re.sub(
                r"\\(.)",
                lambda e: "\n" if e.group(1) == "n" else e.group(1),
                help_)
            continue
        m = _TYPE_RE.match(line)
        if m:
            out.setdefault(m.group(1), {})["type"] = m.group(2)
    return out


def scrape(url: str, timeout: float = 2.0) -> Samples:
    """GET a /metrics endpoint and parse it (raises on transport errors —
    the caller decides what a failed scrape means for health)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return parse_prom_text(resp.read().decode("utf-8", "replace"))


def _match(labels: Dict[str, str], want: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in want.items())


def sample_value(samples: Samples, name: str,
                 default: float = float("nan"), **labels) -> float:
    """First sample of `name` matching `labels` (gauges/counters)."""
    for got, value in samples.get(name, ()):
        if _match(got, labels):
            return value
    return default


def sample_sum(samples: Samples, name: str,
               default: float = float("nan"), **labels) -> float:
    """Sum of every sample of `name` matching `labels` — how a
    multi-lane replica (CP x DP: one gauge series per engine lane)
    rolls up to one number. `default` when no sample matches."""
    total, seen = 0.0, False
    for got, value in samples.get(name, ()):
        if _match(got, labels):
            total += value
            seen = True
    return total if seen else default


def histogram_percentile(samples: Samples, name: str, q: float,
                         **labels) -> float:
    """q-quantile from `name`'s cumulative `_bucket` series — same
    upper-bound-of-bucket semantics as the in-process
    Histogram.percentile(), so a test can assert the two views agree.
    NaN when the histogram is empty or absent."""
    buckets: List[Tuple[float, float]] = []  # (le, cumulative count)
    for got, value in samples.get(f"{name}_bucket", ()):
        if "le" not in got or not _match(
                {k: v for k, v in got.items() if k != "le"}, labels):
            continue
        le = float("inf") if got["le"] in ("+Inf", "inf") else float(got["le"])
        buckets.append((le, value))
    if not buckets:
        return float("nan")
    buckets.sort(key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return float("nan")
    rank = q * total
    finite = [b for b in buckets if not math.isinf(b[0])]
    for le, cum in buckets:
        if cum >= rank:
            return finite[-1][0] if math.isinf(le) and finite else le
    return finite[-1][0] if finite else float("nan")


def diff_samples(before: Samples, after: Samples) -> Samples:
    """after - before, per (name, labels): turns cumulative counters and
    histogram bucket counts into a windowed view, so an SLO report covers
    exactly the replayed traffic — warmup compiles and earlier traffic
    fall out of the percentiles. Samples absent from `before` (a replica
    restarted mid-window, or a metric first observed inside it) keep
    their `after` value. Meaningless for gauges; callers only diff
    counters/histograms."""
    out: Samples = {}
    for name, rows in after.items():
        brows = before.get(name, [])
        out[name] = [
            (labels,
             value - next((v for bl, v in brows if bl == labels), 0.0))
            for labels, value in rows]
    return out


def merge_samples(parts: List[Samples]) -> Samples:
    """Concatenate scraped expositions (fleet-wide percentiles: bucket
    series from every replica are SUMMED per `le` by histogram_percentile
    callers via merge_histograms; plain samples just accumulate)."""
    out: Samples = {}
    for p in parts:
        for name, rows in p.items():
            out.setdefault(name, []).extend(rows)
    return out


def merged_histogram_percentile(parts: List[Samples], name: str, q: float,
                                **labels) -> float:
    """Fleet-wide quantile: sum the cumulative bucket counts per bound
    across replicas, then take the percentile of the merged histogram."""
    sums: Dict[float, float] = {}
    for samples in parts:
        for got, value in samples.get(f"{name}_bucket", ()):
            if "le" not in got or not _match(
                    {k: v for k, v in got.items() if k != "le"}, labels):
                continue
            le = (float("inf") if got["le"] in ("+Inf", "inf")
                  else float(got["le"]))
            sums[le] = sums.get(le, 0.0) + value
    if not sums:
        return float("nan")
    merged: Samples = {f"{name}_bucket": [
        ({"le": "+Inf" if math.isinf(le) else repr(le)}, cum)
        for le, cum in sums.items()]}
    return histogram_percentile(merged, name, q)


def replica_load(samples: Samples,
                 default: float = float("inf")) -> float:
    """Dispatch load score off the engine's gauges: busy slots +
    queued requests, SUMMED across label sets — a CP x DP replica
    exposes one series per engine lane (lane="0", "1", ...) and its
    load is the fleet-visible total. Missing gauges (scrape raced
    server startup) score as `default` so the router prefers replicas
    it can actually see."""
    active = sample_sum(samples, "engine_slots_active")
    queued = sample_sum(samples, "engine_queue_depth")
    if math.isnan(active) and math.isnan(queued):
        return default
    return ((0.0 if math.isnan(active) else active)
            + (0.0 if math.isnan(queued) else queued))
