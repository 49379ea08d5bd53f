"""Failure detection + straggler mitigation primitives.

Copy of ``repro.runtime.heartbeat`` (plain Python).  Multi-host
deployments detect failures via heartbeat timeouts at the coordinator;
this module implements the same control logic against a
pluggable clock/transport so it is deterministic under test (this container
has one host).  The trainer consumes:

* ``HeartbeatMonitor`` — per-worker liveness with a deadline; workers that
  miss the deadline are declared dead, triggering elastic re-mesh
  (runtime/elastic.py).
* ``StragglerPolicy`` — per-step duration tracking; a worker persistently
  slower than median * threshold is flagged for replacement with a hot
  spare *before* it fails hard (tail-latency mitigation at scale).

Pass a metrics registry (an object with ``gauge(name, help, labels=)``,
as the reference's ``MetricsRegistry``) to ``HeartbeatMonitor`` to export
``worker_alive{worker=}`` and ``worker_heartbeat_staleness_seconds``
gauges.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, workers, timeout_s: float = 60.0, clock=time.monotonic,
                 registry=None):
        self.timeout = timeout_s
        self.clock = clock
        self.workers = {
            w: WorkerState(last_beat=self.clock()) for w in workers}
        self._g_alive = self._g_stale = None
        if registry is not None:
            self._g_alive = registry.gauge(
                "worker_alive", "1 while the worker meets its heartbeat "
                "deadline, 0 once declared dead", labels=("worker",))
            self._g_stale = registry.gauge(
                "worker_heartbeat_staleness_seconds",
                "seconds since the worker's last heartbeat, as of the "
                "last beat()/check()", labels=("worker",))
        self._publish()

    def _publish(self) -> None:
        if self._g_alive is None:
            return
        now = self.clock()
        for w, st in self.workers.items():
            self._g_alive.labels(worker=str(w)).set(1 if st.alive else 0)
            self._g_stale.labels(worker=str(w)).set(now - st.last_beat)

    def beat(self, worker) -> None:
        st = self.workers.get(worker)
        if st is not None:
            st.last_beat = self.clock()
            st.alive = True
        self._publish()

    def check(self) -> list:
        """Returns newly-dead workers (deadline exceeded)."""
        now = self.clock()
        dead = []
        for w, st in self.workers.items():
            if st.alive and now - st.last_beat > self.timeout:
                st.alive = False
                dead.append(w)
        self._publish()
        return dead

    @property
    def alive(self) -> list:
        return [w for w, st in self.workers.items() if st.alive]

    def remove(self, worker) -> None:
        self.workers.pop(worker, None)
        if self._g_alive is not None:
            self._g_alive.remove(worker=str(worker))
            self._g_stale.remove(worker=str(worker))

    def add(self, worker) -> None:
        self.workers[worker] = WorkerState(last_beat=self.clock())
        self._publish()


class StragglerPolicy:
    """Flags workers whose step time is persistently above
    median * threshold over a sliding window."""

    def __init__(self, threshold: float = 1.5, window: int = 8,
                 min_samples: int = 4):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.times: dict = defaultdict(lambda: deque(maxlen=window))

    def record(self, worker, step_time_s: float) -> None:
        self.times[worker].append(step_time_s)

    def stragglers(self) -> list:
        medians = {}
        for w, ts in self.times.items():
            if len(ts) >= self.min_samples:
                s = sorted(ts)
                medians[w] = s[len(s) // 2]
        if len(medians) < 2:
            return []
        global_median = sorted(medians.values())[len(medians) // 2]
        return [
            w for w, m in medians.items()
            if m > self.threshold * max(global_median, 1e-9)
        ]
