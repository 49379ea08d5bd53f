"""The port's observability modules against the reference's: the same
metric, fault-rate and telemetry sequences give EQUAL exports (JSON
snapshot, ``to_json`` and Prometheus text, string for string: both are
the same stdlib code), and the engine's Perfetto trace passes the
reference's ``check_events``."""

import types

import numpy as np
import pytest
import torch

from repro.obs import (
    ENGINE_COUNTERS as J_COUNTERS,
    EngineTelemetry as JTelemetry,
    FaultRateMonitor as JMonitor,
    MetricsRegistry as JRegistry,
)
from repro.obs.trace import Tracer as JTracer, check_events as jcheck
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultModel
from repro_torch.models.model import Model
from repro_torch.obs import (
    ENGINE_COUNTERS,
    CardinalityError,
    EngineTelemetry,
    FaultRateMonitor,
    MetricsRegistry,
    RegistrationError,
    Tracer,
    check_events,
)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import EngineStats

torch.set_num_threads(1)


def _drive_registry(r):
    c = r.counter("req_total", "requests\nserved")
    c.inc()
    c.inc(2.5)
    c.inc_to(7)
    lc = r.counter("by_kind_total", "by kind", labels=("kind",))
    lc.labels(kind='a"b\\c').inc(3)
    lc.labels(kind="plain").inc()
    g = r.gauge("slots", "active slots")
    g.set(3)
    g.inc(2)
    g.dec(0.5)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.1, 0.3, 0.7, 2.0, 1.0):
        h.observe(v)
    hl = r.histogram("lab_seconds", "", labels=("phase",),
                     buckets=(1.0, 2.0))
    hl.labels(phase="decode").observe(1.5)
    assert r.counter("req_total", "requests\nserved") is c
    return r


def test_registry_exports_equal_reference():
    got, ref = _drive_registry(MetricsRegistry()), \
        _drive_registry(JRegistry())
    assert got.snapshot() == ref.snapshot()
    assert got.to_json() == ref.to_json()
    assert got.render_prometheus() == ref.render_prometheus()
    assert got.names() == ref.names()


def test_registry_errors_match_reference():
    for reg, card, regerr in ((MetricsRegistry(), CardinalityError,
                               RegistrationError),
                              (JRegistry(), None, None)):
        c = reg.counter("x_total", labels=("k",), max_series=2)
        c.labels(k=1).inc()
        c.labels(k=2).inc()
        with pytest.raises(ValueError):
            c.labels(k=3)
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            c.labels(k=1).inc_to(-1)
        if card is not None:
            with pytest.raises(card):
                c.labels(k=4)
            with pytest.raises(regerr):
                reg.histogram("x_total")


def test_fault_rate_monitor_snapshots_equal_reference():
    rng = np.random.default_rng(3)
    a, b = FaultRateMonitor(window=8, alpha=0.2), JMonitor(window=8,
                                                           alpha=0.2)
    for i in range(40):
        obs = dict(steps=int(rng.integers(0, 3)),
                   tokens=int(rng.integers(0, 9)),
                   detections=int(rng.integers(0, 2)),
                   retries=int(rng.integers(0, 2)),
                   hard_faults=int(rng.random() < 0.1))
        a.observe(**obs)
        b.observe(**obs)
        if i == 25:
            a.reset()
            b.reset()
        assert a.snapshot() == b.snapshot()


def test_engine_telemetry_sync_equals_reference():
    """The same cumulative stats sequence mirrored by both facades gives
    equal snapshots; the counter mapping is the reference's."""
    assert ENGINE_COUNTERS == J_COUNTERS
    got, ref = EngineTelemetry(), JTelemetry()
    stats = EngineStats()
    rng = np.random.default_rng(0)
    for i in range(30):
        for attr in ("steps", "tokens", "faults_detected", "retries",
                     "faults_injected", "sdc_faults"):
            setattr(stats, attr, getattr(stats, attr)
                    + int(rng.integers(0, 3)))
        view = types.SimpleNamespace(**{a: getattr(stats, a)
                                        for a in ENGINE_COUNTERS.values()})
        kw = dict(active_slots=i % 4, blocks_used=i, blocks_free=64 - i)
        got.sync(stats, **kw)
        ref.sync(view, **kw)
        got.observe_step_latency(0.001 * i)
        ref.observe_step_latency(0.001 * i)
    assert got.counters_match(stats)
    assert got.snapshot() == ref.snapshot()
    assert got.registry.render_prometheus() == \
        ref.registry.render_prometheus()


def _drive_tracer(tr):
    with tr.span("outer", {"a": 1}) as sp:
        with tr.span("inner") as inner:
            inner.fence(torch.zeros(2))   # CPU tensors: nothing to wait on
            tr.instant("flip", {"x": 2})
        sp.set_args(b=3)
    for _ in range(4):
        tr.instant("extra")
    return tr


def test_tracer_events_and_checker_match_reference():
    got = _drive_tracer(Tracer(clock=iter(range(0, 10**7, 1000)).__next__,
                               max_events=5))
    ref = _drive_tracer(JTracer(clock=iter(range(0, 10**7, 1000)).__next__,
                                max_events=5))
    assert got.to_json() == ref.to_json() and got.dropped == 2
    bad = [{"name": "a", "ph": "X", "ts": 0, "dur": 10},
           {"name": "b", "ph": "X", "ts": 5, "dur": 10},
           {"name": "c", "ph": "Q", "ts": 0}]
    assert check_events(bad) == jcheck(bad) and len(jcheck(bad)) == 2


def test_engine_trace_passes_reference_checker():
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32)
    tel = EngineTelemetry(trace=True)
    eng = ServeEngine(model, params, slots=2, max_len=32,
                      dtype=torch.float32, device="cpu", telemetry=tel,
                      fault_model=FaultModel(transient_rate=0.5, seed=1,
                                             layers=2, magnitude=1e4))
    eng.run([Request(uid=i, prompt=np.arange(1, 5 + i), max_new_tokens=4)
             for i in range(3)])
    events = tel.tracer.events
    assert jcheck(events) == [] and check_events(events) == []
    names = {e["name"] for e in events}
    assert {"admit", "prefill", "decode_step", "abft_check", "plan_row",
            "fault_injected"} <= names
    assert tel.counters_match(eng.stats)


def test_attach_telemetry_mirrors_from_then_on():
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    eng = ServeEngine(model, model.init_params(0, dtype=torch.float32),
                      slots=2, max_len=32, dtype=torch.float32,
                      device="cpu")
    assert eng.telemetry is None
    tel = EngineTelemetry(trace=True)
    eng.attach_telemetry(tel)
    rows = [e for e in tel.tracer.events if e["name"] == "plan_row"]
    assert len(rows) == len(eng.plan.entries)
    eng.run([Request(uid=0, prompt=np.arange(1, 6), max_new_tokens=3)])
    assert tel.counters_match(eng.stats) and eng.stats.steps == 2
