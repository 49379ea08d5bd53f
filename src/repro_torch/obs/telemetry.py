"""Engine telemetry facade (port of ``repro.obs.telemetry``): one object
bundling the metrics registry, the span tracer, and the fault-rate
monitor, with a single ``sync()`` point that mirrors the engine's
cumulative ``EngineStats`` into exported counters.

Mirroring via ``Counter.inc_to`` (monotonic set) instead of per-site
increments is the invariant that makes the acceptance check cheap to
hold: the exported counter equals the ``EngineStats`` field *by
construction* after every sync, so no instrumentation site can drift
out of agreement with the engine's own accounting (and existing tests
asserting on ``EngineStats`` stay authoritative).  The same sync
computes per-step deltas and feeds them to the ``FaultRateMonitor`` —
the rolling detection/retry/hard-fault rates ROADMAP item 5b's
adaptive protection policy consumes via ``ServeEngine.telemetry``.

The facade is duck-typed against ``EngineStats`` (attribute names
only), so ``repro_torch.obs`` has no import edge into
``repro_torch.serve`` and stays reusable by the trainer, the heartbeat
monitor, and benchmarks.
"""

from __future__ import annotations

from repro_torch.obs.faultrate import FaultRateMonitor
from repro_torch.obs.metrics import (
    ITL_BUCKETS_S,
    STEP_LATENCY_BUCKETS_S,
    TTFT_BUCKETS_S,
    MetricsRegistry,
)
from repro_torch.obs.trace import Tracer

# exported counter name -> EngineStats attribute.  The telemetry
# acceptance gate (tests + check_telemetry_schema.py) asserts exact
# equality across this whole mapping after a run.
ENGINE_COUNTERS = {
    "serve_steps_total": "steps",
    "serve_tokens_total": "tokens",
    "abft_faults_detected_total": "faults_detected",
    "abft_retries_total": "retries",
    "abft_hard_faults_total": "hard_faults",
    "serve_evictions_total": "evictions",
    "serve_rejections_total": "rejections",
    "serve_prompt_tokens_total": "prompt_tokens_total",
    "serve_prefix_tokens_shared_total": "prefix_tokens_shared",
    "serve_cow_copies_total": "cow_copies",
    "serve_prefill_chunks_total": "prefill_chunks",
    "serve_chunk_retries_total": "chunk_retries",
    "serve_chunk_budget_retunes_total": "chunk_budget_retunes",
    "serve_scheme_flips_total": "scheme_flips",
    # speculative decoding (serve/spec_decode.py)
    "serve_spec_draft_proposed_total": "draft_proposed",
    "serve_spec_draft_accepted_total": "draft_accepted",
    "serve_spec_verify_retries_total": "verify_retries",
    # fault-campaign classification (shadow-stream harness) + adaptive
    # protection level changes — SDCs are first-class exported counters
    "abft_faults_injected_total": "faults_injected",
    "abft_faults_corrected_total": "faults_corrected",
    "abft_faults_uncorrected_total": "faults_uncorrected",
    "abft_sdc_total": "sdc_faults",
    "abft_masked_faults_total": "masked_faults",
    "serve_protection_escalations_total": "protection_escalations",
    "serve_protection_deescalations_total": "protection_deescalations",
}

# deltas of these stats feed the fault-rate monitor each sync
_FAULT_DELTAS = ("steps", "tokens", "faults_detected", "retries",
                 "hard_faults")


class EngineTelemetry:
    """``ServeEngine(telemetry=EngineTelemetry(...))`` — or build one
    standalone and attach with ``engine.attach_telemetry``."""

    def __init__(self, *, trace: bool = False,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 fault_window: int = 256, fault_alpha: float = 0.05,
                 trace_max_events: int = 200_000, trace_sink=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(
            enabled=trace, max_events=trace_max_events, sink=trace_sink)
        self.faults = FaultRateMonitor(window=fault_window,
                                       alpha=fault_alpha)
        r = self.registry
        self._counters = {
            name: r.counter(name, f"engine cumulative {attr}")
            for name, attr in ENGINE_COUNTERS.items()
        }
        self._g_active = r.gauge("serve_active_slots",
                                 "slots with a resident decode stream")
        self._g_cursors = r.gauge("serve_prefill_cursors",
                                  "prompts parked mid-chunked-prefill")
        self._g_blocks_used = r.gauge("serve_blocks_used",
                                      "paged KV blocks allocated")
        self._g_blocks_free = r.gauge("serve_blocks_free",
                                      "paged KV blocks on the free list")
        self._g_chunk_budget = r.gauge(
            "serve_chunk_budget_tokens",
            "current chunked-prefill step token budget")
        self._g_draft_len = r.gauge(
            "serve_spec_draft_len",
            "current speculative-decoding draft length K")
        self._g_accept_rate = r.gauge(
            "serve_spec_accept_rate",
            "cumulative draft acceptance rate "
            "(draft_accepted / draft_proposed)")
        self._g_det_win = r.gauge(
            "abft_detection_rate_window",
            "windowed ABFT detections per step (FaultRateMonitor)")
        self._g_det_tok = r.gauge(
            "abft_detection_rate_per_token_window",
            "windowed ABFT detections per generated token")
        self._g_retry_win = r.gauge(
            "abft_retry_rate_window", "windowed ABFT retries per step")
        self._g_hard_win = r.gauge(
            "abft_hard_fault_rate_window",
            "windowed hard faults per step")
        self._g_det_ewma = r.gauge(
            "abft_detection_rate_ewma",
            "EWMA ABFT detections per step")
        self.step_latency = r.histogram(
            "serve_step_latency_seconds", "engine step wall time",
            buckets=STEP_LATENCY_BUCKETS_S)
        self.ttft = r.histogram(
            "serve_ttft_seconds",
            "time to first token (observed by the driver)",
            buckets=TTFT_BUCKETS_S)
        self.itl = r.histogram(
            "serve_itl_seconds",
            "inter-token latency (observed by the driver)",
            buckets=ITL_BUCKETS_S)
        self._prev = {attr: 0 for attr in _FAULT_DELTAS}

    # ------------------------------------------------------------ syncing
    def sync(self, stats, *, active_slots: int | None = None,
             prefill_cursors: int | None = None,
             blocks_used: int | None = None,
             blocks_free: int | None = None,
             chunk_budget: int | None = None,
             draft_len: int | None = None) -> None:
        """Mirror cumulative ``EngineStats`` into the registry and feed
        the delta since the last sync to the fault-rate monitor.  Called
        by the engine after every ``step()``/``admit()``."""
        for name, attr in ENGINE_COUNTERS.items():
            self._counters[name].inc_to(getattr(stats, attr))
        deltas = {}
        for attr in _FAULT_DELTAS:
            cur = getattr(stats, attr)
            deltas[attr] = cur - self._prev[attr]
            self._prev[attr] = cur
        if any(deltas.values()):
            self.faults.observe(
                steps=deltas["steps"], tokens=deltas["tokens"],
                detections=deltas["faults_detected"],
                retries=deltas["retries"],
                hard_faults=deltas["hard_faults"])
            self._g_det_win.set(self.faults.window_detection_rate)
            self._g_det_tok.set(
                self.faults.window_detection_rate_per_token)
            self._g_retry_win.set(self.faults.window_retry_rate)
            self._g_hard_win.set(self.faults.window_hard_fault_rate)
            self._g_det_ewma.set(self.faults.ewma_detections)
        if active_slots is not None:
            self._g_active.set(active_slots)
        if prefill_cursors is not None:
            self._g_cursors.set(prefill_cursors)
        if blocks_used is not None:
            self._g_blocks_used.set(blocks_used)
        if blocks_free is not None:
            self._g_blocks_free.set(blocks_free)
        if chunk_budget is not None:
            self._g_chunk_budget.set(chunk_budget)
        if draft_len is not None:
            self._g_draft_len.set(draft_len)
            if stats.draft_proposed:
                self._g_accept_rate.set(
                    stats.draft_accepted / stats.draft_proposed)

    def counters_match(self, stats) -> bool:
        """True iff every mirrored counter equals its EngineStats field
        (the telemetry acceptance invariant)."""
        return all(
            self._counters[name].value == getattr(stats, attr)
            for name, attr in ENGINE_COUNTERS.items())

    # ------------------------------------------------- caller observations
    def observe_step_latency(self, seconds: float) -> None:
        self.step_latency.observe(seconds)

    def observe_ttft(self, seconds: float) -> None:
        self.ttft.observe(seconds)

    def observe_itl(self, seconds: float) -> None:
        self.itl.observe(seconds)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """One JSON-ready artifact: metrics + fault-rate surface + trace
        accounting (the per-cell benchmark telemetry payload)."""
        return {
            "schema_version": 1,
            "metrics": self.registry.snapshot(),
            "faultrate": self.faults.snapshot(),
            "trace": {
                "enabled": self.tracer.enabled,
                "events": len(self.tracer.events),
                "dropped": self.tracer.dropped,
            },
        }
