"""Dependency-free metrics registry (port of ``repro.obs.metrics``):
Counter / Gauge / Histogram with label sets, bounded cardinality, and
two export surfaces — a JSON ``snapshot()`` (the benchmark/CI artifact
format) and Prometheus text-exposition rendering
(``render_prometheus()``) for scrape-style consumption.

Design constraints (why this is hand-rolled instead of a client lib):

* the container pins its dependency set — no ``prometheus_client`` —
  and the serving engine's per-step hot path cannot afford one anyway;
* counters support ``inc_to(value)``: a *monotonic set* used to mirror
  an upstream cumulative counter (``EngineStats``) into the registry
  without instrumenting every increment site — the engine syncs once
  per step and the exported counter is exact by construction;
* label cardinality is bounded per metric (``max_series``, default
  64): a runaway label value (per-request uid, say) raises
  ``CardinalityError`` instead of silently growing an unbounded series
  map inside a long-lived serving process.

Bucket boundaries for the serving latency histograms live here as
explicit module constants so the engine, the serving CLI, and the
benchmark all agree on the exposition schema:

* ``TTFT_BUCKETS_S``   — time-to-first-token (admission + prefill);
* ``ITL_BUCKETS_S``    — inter-token latency (decode cadence);
* ``STEP_LATENCY_BUCKETS_S`` — engine step wall time.
"""

from __future__ import annotations

import json
import math
import re

# seconds; chosen to straddle both CPU-container smoke runs (ms-scale
# dispatch-dominated steps) and accelerator serving (sub-ms decode steps)
STEP_LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5)
# TTFT includes prefill, so the tail extends further
TTFT_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0)
# ITL is one decode step plus queueing; same floor, shorter tail
ITL_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class CardinalityError(ValueError):
    """A metric exceeded its bounded label-set budget."""


class RegistrationError(ValueError):
    """Conflicting re-registration (same name, different type/labels)."""


def _escape_label_value(v: str) -> str:
    return (v.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers render bare, +Inf as
    ``+Inf``."""
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


class _Metric:
    """Shared series bookkeeping: a metric with label names is a family
    whose children are keyed by the label-value tuple; a label-less
    metric is its own single child (empty tuple key)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: tuple = (), max_series: int = 64):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.max_series = max_series
        self._children: dict = {}
        if not self.label_names:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        """The child series for this label-value set (created on first
        use, up to ``max_series``)."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(kv[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_series:
                raise CardinalityError(
                    f"{self.name}: series cap {self.max_series} "
                    f"exceeded by labels {dict(zip(self.label_names, key))}")
            child = self._children[key] = self._new_child()
        return child

    def remove(self, **kv) -> None:
        """Drop one labeled series (e.g. a removed heartbeat worker)."""
        key = tuple(str(kv[ln]) for ln in self.label_names)
        self._children.pop(key, None)

    def _default(self):
        """The single child of a label-less metric."""
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; use "
                f".labels(...)")
        return self._children[()]

    def series(self):
        for key, child in self._children.items():
            yield dict(zip(self.label_names, key)), child


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def inc_to(self, v: float) -> None:
        """Monotonic set: mirror an upstream cumulative counter."""
        if v < self.value:
            raise ValueError(
                f"inc_to({v}) would decrease counter from {self.value}")
        self.value = v


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def inc_to(self, v: float) -> None:
        self._default().inc_to(v)

    @property
    def value(self) -> float:
        return self._default().value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = bounds             # finite, sorted; +Inf implicit
        self.counts = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1             # +Inf bucket

    def cumulative(self):
        """[(le, cumulative_count)] including +Inf; the exposition and
        snapshot invariant is that the +Inf count equals ``count``."""
        out, running = [], 0
        for b, c in zip(self.bounds, self.counts):
            running += c
            out.append((b, running))
        out.append((math.inf, running + self.counts[-1]))
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", label_names=(), max_series=64,
                 buckets=STEP_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets if b != math.inf)
        if not bounds or sorted(bounds) != list(bounds):
            raise ValueError(
                f"{name}: bucket bounds must be non-empty and sorted, "
                f"got {buckets}")
        self.bounds = bounds
        super().__init__(name, help, label_names, max_series)

    def _new_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum


class MetricsRegistry:
    """Named metric families; registration is idempotent for an
    identical spec and raises ``RegistrationError`` on conflicts."""

    def __init__(self):
        self._metrics: dict = {}

    def _get_or_register(self, cls, name, help, labels, max_series,
                         **extra):
        existing = self._metrics.get(name)
        if existing is not None:
            same = (type(existing) is cls
                    and existing.label_names == tuple(labels))
            if same and cls is Histogram:
                same = existing.bounds == tuple(
                    float(b) for b in extra["buckets"] if b != math.inf)
            if not same:
                raise RegistrationError(
                    f"{name} already registered as {existing.kind} "
                    f"with labels {existing.label_names}")
            return existing
        m = cls(name, help, tuple(labels), max_series, **extra)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labels=(),
                max_series=64) -> Counter:
        return self._get_or_register(Counter, name, help, labels,
                                     max_series)

    def gauge(self, name, help="", labels=(), max_series=64) -> Gauge:
        return self._get_or_register(Gauge, name, help, labels,
                                     max_series)

    def histogram(self, name, help="", labels=(), max_series=64,
                  buckets=STEP_LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_register(Histogram, name, help, labels,
                                     max_series, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def names(self) -> list:
        return sorted(self._metrics)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """JSON-ready registry state: the benchmark/CI artifact format
        (``check_telemetry_schema.py`` validates its invariants)."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for labels, child in m.series():
                if m.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "buckets": [["+Inf" if le == math.inf else le, c]
                                    for le, c in child.cumulative()],
                        "sum": child.sum,
                        "count": child.count,
                    })
                else:
                    series.append({"labels": labels,
                                   "value": child.value})
            out[name] = {"type": m.kind, "help": m.help,
                         "series": series}
        return out

    def to_json(self, indent=2) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: ``# HELP`` /
        ``# TYPE`` headers, escaped label values, and per-histogram
        ``_bucket``/``_sum``/``_count`` sample families."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for labels, child in m.series():
                base = ",".join(
                    f'{k}="{_escape_label_value(v)}"'
                    for k, v in labels.items())
                if m.kind == "histogram":
                    for le, c in child.cumulative():
                        lab = (base + "," if base else "") + \
                            f'le="{_fmt(float(le))}"'
                        lines.append(f"{name}_bucket{{{lab}}} {c}")
                    brace = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{brace} {_fmt(child.sum)}")
                    lines.append(
                        f"{name}_count{brace} {child.count}")
                else:
                    brace = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{brace} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"
