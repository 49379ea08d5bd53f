"""Serving observability: metrics registry (Prometheus/JSON export),
structured span tracing (Chrome-trace/Perfetto JSON), and the
fault-rate monitor feeding adaptive protection (port of ``repro.obs``;
stdlib only, apart from the trace fence, which imports torch when used)."""

from repro_torch.obs.faultrate import FaultRateMonitor
from repro_torch.obs.metrics import (
    ITL_BUCKETS_S,
    STEP_LATENCY_BUCKETS_S,
    TTFT_BUCKETS_S,
    CardinalityError,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RegistrationError,
)
from repro_torch.obs.telemetry import ENGINE_COUNTERS, EngineTelemetry
from repro_torch.obs.trace import Tracer, check_events

__all__ = [
    "CardinalityError",
    "Counter",
    "ENGINE_COUNTERS",
    "EngineTelemetry",
    "FaultRateMonitor",
    "Gauge",
    "Histogram",
    "ITL_BUCKETS_S",
    "MetricsRegistry",
    "RegistrationError",
    "STEP_LATENCY_BUCKETS_S",
    "TTFT_BUCKETS_S",
    "Tracer",
    "check_events",
]
