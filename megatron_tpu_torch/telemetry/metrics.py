"""Metrics registry: counters/gauges/histograms + Prometheus exposition.

A copy of megatron_tpu/telemetry/metrics.py (host code with no jax in
it), kept here so the port imports nothing of the JAX package.

In the JAX package, the runtime-observability counterpart of training/logging_writer.py (which
streams scalars to tensorboard/wandb for AFTER-the-run analysis): these
collectors are cheap enough to update on every engine tick / train step
and are scraped LIVE over HTTP (`/metrics` on the serving server,
`--metrics_port` sidecar on the train loop) in the Prometheus text format
(https://prometheus.io/docs/instrumenting/exposition_formats/ 0.0.4 —
no client_prometheus dependency, the format is 40 lines of code).

Design points:

  * get-or-create registration: two subsystems asking for the same metric
    name share the collector (the serving engine and the HTTP layer both
    run against the process-default registry; re-registering must not
    raise, but a name re-registered with a different type/label schema is
    a bug and does).
  * labels are per-call kwargs, not child objects: `c.inc(1, status="200")`
    — one collector owns all its label combinations, which keeps the
    exposition grouped under one # TYPE header as the format requires.
  * histograms are cumulative-bucket, like Prometheus': le-bucket counts,
    _sum and _count, so rate() / histogram_quantile() work server-side.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

# default latency-ish buckets (seconds): spans 1ms..60s, the range of a
# decode tick at one end and a checkpoint stall at the other
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(s: str) -> str:
    """HELP text escaping per the text format: backslash and newline
    only (quotes stay literal in HELP, unlike label values). Symmetric
    with fleet/scrape.py parse_prom_metadata."""
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _format_labels(labels: Tuple[Tuple[str, str], ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)
    return "{" + body + "}"


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Collector:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str]):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name} expects labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple((k, str(labels[k])) for k in self.label_names)

    def samples(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def expose(self) -> str:
        # every family gets a HELP and a TYPE line (strict scrapers —
        # fleet/scrape.py parse_prom_text(strict=True) — reject samples
        # of undeclared families); empty help falls back to the name so
        # the HELP line is never blank, and the text is escaped so a
        # newline in a help string can't inject a bogus sample line
        lines = [f"# HELP {self.name} {_escape_help(self.help or self.name)}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(self.samples())
        return "\n".join(lines)


class Counter(_Collector):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self):
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            yield f"{self.name}{_format_labels(key)} {_format_value(v)}"


class Gauge(_Collector):
    """Set-to-current-value metric (slot occupancy, queue depth, ...)."""

    kind = "gauge"

    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def samples(self):
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            yield f"{self.name}{_format_labels(key)} {_format_value(v)}"


class Histogram(_Collector):
    """Cumulative-bucket histogram (le buckets + _sum + _count)."""

    kind = "histogram"

    def __init__(self, name, help, label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self._counts: Dict[Tuple, list] = {}
        self._sum: Dict[Tuple, float] = {}
        self._total: Dict[Tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + v
            self._total[key] = self._total.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._total.get(self._key(labels), 0)

    def percentile(self, q: float, **labels) -> float:
        """Approximate q-quantile from the bucket counts (upper bound of
        the bucket the quantile falls in; +Inf bucket reports the largest
        finite bound). For dashboards/tests, not precision statistics."""
        key = self._key(labels)
        with self._lock:
            counts = list(self._counts.get(key, ()))
            total = self._total.get(key, 0)
        if not total:
            return float("nan")
        rank = q * total
        # observe() increments every bucket whose bound >= v, so counts[i]
        # is already the cumulative count at bound i (Prometheus-style)
        for i, bound in enumerate(self.buckets):
            if counts[i] >= rank:
                return bound
        return self.buckets[-1]

    def samples(self):
        with self._lock:
            keys = set(self._counts)
            if not self.label_names:
                keys.add(())  # unlabeled histogram exposes an empty series
            keys = sorted(keys)
        for key in keys:
            with self._lock:
                counts = list(self._counts.get(key, [0] * len(self.buckets)))
                total = self._total.get(key, 0)
                s = self._sum.get(key, 0.0)
            for bound, c in zip(self.buckets, counts):
                yield (f"{self.name}_bucket"
                       f"{_format_labels(key, (('le', _format_value(bound)),))}"
                       f" {c}")
            yield (f"{self.name}_bucket{_format_labels(key, (('le', '+Inf'),))}"
                   f" {total}")
            yield f"{self.name}_sum{_format_labels(key)} {_format_value(s)}"
            yield f"{self.name}_count{_format_labels(key)} {total}"


class MetricsRegistry:
    """Named collectors + one-call Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: Dict[str, _Collector] = {}

    def _get_or_create(self, cls, name, help, label_names, **kw):
        with self._lock:
            existing = self._collectors.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.label_names != tuple(label_names)):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{type(existing).__name__} with labels "
                        f"{existing.label_names}")
                return existing
            c = cls(name, help, label_names, **kw)
            self._collectors[name] = c
            return c

    def counter(self, name: str, help: str = "", label_names=()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "", label_names=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "", label_names=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Collector]:
        with self._lock:
            return self._collectors.get(name)

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every collector."""
        with self._lock:
            collectors = [self._collectors[n]
                          for n in sorted(self._collectors)]
        out = [c.expose() for c in collectors]
        return "\n".join(out) + ("\n" if out else "")


class _BoundCollector:
    """A collector with a constant label set pre-applied (the lane tag
    of a CP x DP engine lane). Observation methods proxy through with
    the constant labels merged in; reads do the same."""

    def __init__(self, collector: _Collector,
                 constant: Dict[str, str]):
        self._c = collector
        self._constant = dict(constant)

    def _merge(self, labels: Dict) -> Dict:
        overlap = set(labels) & set(self._constant)
        if overlap:
            raise ValueError(
                f"metric {self._c.name}: label(s) {sorted(overlap)} are "
                "pinned by the registry view and cannot be passed "
                "per-call")
        out = dict(self._constant)
        out.update(labels)
        return out

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._c.inc(amount, **self._merge(labels))

    def set(self, value: float, **labels) -> None:
        self._c.set(value, **self._merge(labels))

    def observe(self, value: float, **labels) -> None:
        self._c.observe(value, **self._merge(labels))

    def value(self, **labels) -> float:
        return self._c.value(**self._merge(labels))

    def count(self, **labels) -> int:
        return self._c.count(**self._merge(labels))


class LabeledRegistryView:
    """A registry facade that stamps constant labels onto every
    collector it hands out — how the CP x DP engine lanes share one
    host registry while keeping per-lane series: every lane asks for
    the same metric names, the real collectors carry an extra "lane"
    label dimension, and the exposition (and the fleet router's load
    scrape, which SUMS across label sets) sees each lane separately."""

    def __init__(self, registry: "MetricsRegistry", **constant_labels):
        if not constant_labels:
            raise ValueError("LabeledRegistryView needs at least one "
                             "constant label")
        self._reg = registry
        self._constant = {k: str(v) for k, v in constant_labels.items()}
        self._extra = tuple(sorted(self._constant))

    def _names(self, label_names) -> tuple:
        return tuple(label_names) + self._extra

    def counter(self, name: str, help: str = "",
                label_names=()) -> _BoundCollector:
        return _BoundCollector(
            self._reg.counter(name, help, self._names(label_names)),
            self._constant)

    def gauge(self, name: str, help: str = "",
              label_names=()) -> _BoundCollector:
        return _BoundCollector(
            self._reg.gauge(name, help, self._names(label_names)),
            self._constant)

    def histogram(self, name: str, help: str = "", label_names=(),
                  buckets=DEFAULT_BUCKETS) -> _BoundCollector:
        return _BoundCollector(
            self._reg.histogram(name, help, self._names(label_names),
                                buckets=buckets),
            self._constant)

    def get(self, name: str) -> Optional[_Collector]:
        return self._reg.get(name)

    def render(self) -> str:
        return self._reg.render()


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry: the serving engine, HTTP server, and train
    loop all publish here unless handed an explicit registry (tests)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
