"""Rolling-window fault-rate monitor (port of ``repro.obs.faultrate``):
the engine-observed error environment as a policy input.

The paper picks an ABFT scheme from *static* arithmetic intensity; the
adaptive follow-on (ROADMAP item 5b, "Adaptive Soft Error Protection",
arxiv 2407.19664) needs the engine's *observed* detection/retry/hard-
fault rates as its second input — protection strength should scale with
the measured error environment (spacecraft mode vs datacenter mode)
instead of being fixed at plan-compile time.  ``FaultRateMonitor`` is
that input surface: the serving engine feeds it one observation per
executed step (and per admission prefill), and ``snapshot()`` exposes

* **windowed rates** over the last ``window`` observations — detections,
  retries, and hard faults per step and per generated token (the
  responsive signal an adaptive policy reacts to);
* **EWMA rates** (per observation, smoothing factor ``alpha``) — the
  slow-moving baseline that survives a quiet window;
* **lifetime totals** — the audit trail.

Observations arrive as *deltas* (the telemetry sync computes them from
the cumulative ``EngineStats``), so the monitor needs no knowledge of
engine internals and is trivially reusable by the trainer or a
cluster-level aggregator.
"""

from __future__ import annotations

from collections import deque


class FaultRateMonitor:
    def __init__(self, window: int = 256, alpha: float = 0.05):
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.window = window
        self.alpha = alpha
        self._obs: deque = deque(maxlen=window)
        # lifetime totals
        self.steps = 0
        self.tokens = 0
        self.detections = 0
        self.retries = 0
        self.hard_faults = 0
        # EWMA per observation (≈ per engine step)
        self.ewma_detections = 0.0
        self.ewma_retries = 0.0
        self.ewma_hard_faults = 0.0
        self.observations = 0

    def observe(self, *, steps: int = 1, tokens: int = 0,
                detections: int = 0, retries: int = 0,
                hard_faults: int = 0) -> None:
        """One engine observation (deltas since the previous one)."""
        self._obs.append((steps, tokens, detections, retries,
                          hard_faults))
        self.steps += steps
        self.tokens += tokens
        self.detections += detections
        self.retries += retries
        self.hard_faults += hard_faults
        a = self.alpha
        self.ewma_detections += a * (detections - self.ewma_detections)
        self.ewma_retries += a * (retries - self.ewma_retries)
        self.ewma_hard_faults += a * (hard_faults - self.ewma_hard_faults)
        self.observations += 1

    def reset(self) -> None:
        """Re-baseline the responsive signals: clear the rolling window
        and the EWMA state, KEEPING the lifetime totals (the audit
        trail).  The adaptive policy calls this after an escalation so
        the post-escalation regime is judged on fresh observations
        instead of the pre-escalation window."""
        self._obs.clear()
        self.ewma_detections = 0.0
        self.ewma_retries = 0.0
        self.ewma_hard_faults = 0.0
        self.observations = 0

    # ------------------------------------------------------ windowed rates
    def _window_sums(self):
        s = t = d = r = h = 0
        for steps, tokens, det, ret, hard in self._obs:
            s += steps
            t += tokens
            d += det
            r += ret
            h += hard
        return s, t, d, r, h

    @property
    def window_detection_rate(self) -> float:
        """Detections per step over the rolling window."""
        s, _, d, _, _ = self._window_sums()
        return d / max(s, 1)

    @property
    def window_detection_rate_per_token(self) -> float:
        _, t, d, _, _ = self._window_sums()
        return d / max(t, 1)

    @property
    def window_retry_rate(self) -> float:
        s, _, _, r, _ = self._window_sums()
        return r / max(s, 1)

    @property
    def window_hard_fault_rate(self) -> float:
        s, _, _, _, h = self._window_sums()
        return h / max(s, 1)

    def snapshot(self) -> dict:
        """The adaptive-policy input surface (JSON-ready)."""
        s, t, d, r, h = self._window_sums()
        return {
            "window": self.window,
            "window_filled": len(self._obs),
            "window_steps": s,
            "window_tokens": t,
            "window_detections": d,
            "window_retries": r,
            "window_hard_faults": h,
            "window_detection_rate": self.window_detection_rate,
            "window_detection_rate_per_token":
                self.window_detection_rate_per_token,
            "window_retry_rate": self.window_retry_rate,
            "window_hard_fault_rate": self.window_hard_fault_rate,
            "ewma_alpha": self.alpha,
            "ewma_detections_per_step": self.ewma_detections,
            "ewma_retries_per_step": self.ewma_retries,
            "ewma_hard_faults_per_step": self.ewma_hard_faults,
            "total_steps": self.steps,
            "total_tokens": self.tokens,
            "total_detections": self.detections,
            "total_retries": self.retries,
            "total_hard_faults": self.hard_faults,
        }
