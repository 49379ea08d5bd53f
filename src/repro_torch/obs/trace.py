"""Structured span/event tracer (port of ``repro.obs.trace``) emitting
Chrome-trace / Perfetto compatible JSON (the ``traceEvents`` array
format: complete events ``ph="X"`` with microsecond ``ts``/``dur``,
instant events ``ph="i"``).

Spans use the monotonic clock (``time.perf_counter_ns``) so a wall-clock
adjustment mid-run can never produce negative durations.  CUDA launches
are asynchronous — a call returns before the device work finishes — so a
span that should *contain* device work must fence on its outputs before
closing:

    with tracer.span("decode_step", {"tokens": n}) as sp:
        nxt, flag = runner.decode(...)
        sp.fence(nxt, flag)          # torch.cuda.synchronize at span exit

Fencing happens only when the tracer is enabled; a disabled tracer hands
out a shared no-op span, so instrumented hot paths cost one attribute
check when tracing is off and the engine's token streams are
byte-identical either way (fencing orders host timestamps, never
values).

Event volume is bounded (``max_events``): once full, new events are
counted in ``dropped`` instead of growing an unbounded list inside a
long-lived serving process.  An optional ``sink`` callback receives each
event dict as it is recorded — the serving CLI's ``--log-events``
structured logging hook.

``check_events()`` validates the invariants tests and the CI telemetry
schema gate rely on: known phases, non-negative ts/dur, and proper span
nesting per (pid, tid) — two spans on one thread either nest or are
disjoint, which is exactly what Perfetto's JSON importer assumes when it
builds slice stacks.
"""

from __future__ import annotations

import json
import time


class _NullSpan:
    """Shared do-nothing span for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, *values):
        pass

    def set_args(self, **kv):
        pass


_NULL_SPAN = _NullSpan()


def _synchronize(values) -> None:
    """Wait for the CUDA devices holding any of ``values`` (lazy: torch is
    imported only when a span was given something to fence, so the
    tracer stays importable without it)."""
    import torch

    devices = {v.device for v in values
               if isinstance(v, torch.Tensor) and v.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class Span:
    __slots__ = ("tracer", "name", "args", "_t0", "_fence")

    def __init__(self, tracer, name, args):
        self.tracer = tracer
        self.name = name
        self.args = dict(args) if args else {}
        self._t0 = None
        self._fence = ()

    def fence(self, *values):
        """Values whose device work this span should contain: if any is a
        CUDA tensor, ``torch.cuda.synchronize`` runs before the span
        closes; CPU values need nothing."""
        self._fence = values

    def set_args(self, **kv):
        self.args.update(kv)

    def __enter__(self):
        self._t0 = self.tracer._now_us()
        return self

    def __exit__(self, *exc):
        if self._fence:
            _synchronize(self._fence)
        t1 = self.tracer._now_us()
        self.tracer._emit({
            "name": self.name, "ph": "X", "ts": self._t0,
            "dur": max(0.0, t1 - self._t0), "pid": self.tracer.pid,
            "tid": self.tracer.tid, "args": self.args,
        })
        return False


class Tracer:
    def __init__(self, enabled: bool = True, max_events: int = 200_000,
                 pid: int = 0, tid: int = 0, sink=None,
                 clock=time.perf_counter_ns):
        self.enabled = enabled
        self.max_events = max_events
        self.pid = pid
        self.tid = tid
        self.sink = sink
        self._clock = clock
        self._origin = clock()
        self.events: list = []
        self.dropped = 0

    def _now_us(self) -> float:
        return (self._clock() - self._origin) / 1e3

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
        else:
            self.events.append(ev)
        if self.sink is not None:
            self.sink(ev)

    def span(self, name: str, args: dict | None = None):
        """Context manager recording a complete event around its body."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, args)

    def instant(self, name: str, args: dict | None = None) -> None:
        """Thread-scoped instant event (scheme flips, evictions, fault
        detections)."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": self.pid, "tid": self.tid,
            "args": dict(args) if args else {},
        })

    # ------------------------------------------------------------ export
    def to_dict(self) -> dict:
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())


def check_events(events: list) -> list:
    """Validate Perfetto-JSON invariants; returns a list of problem
    strings (empty == valid).  Checked: required fields per phase,
    non-negative ``ts``/``dur``, and per-(pid, tid) span nesting."""
    problems = []
    spans = []
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
                continue
            spans.append((ev.get("pid", 0), ev.get("tid", 0),
                          float(ts), float(ts) + float(dur),
                          ev.get("name"), i))
    # nesting: per (pid, tid), sweep spans by (start, -end); each span
    # must close before or exactly at its enclosing span's end
    by_thread: dict = {}
    for pid, tid, t0, t1, name, i in spans:
        by_thread.setdefault((pid, tid), []).append((t0, t1, name, i))
    for key, sp in by_thread.items():
        sp.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, name, i in sp:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1]:
                problems.append(
                    f"event {i} ({name!r}): span [{t0}, {t1}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]}, {stack[-1][1]}] on tid {key}")
                continue
            stack.append((t0, t1, name))
    return problems
