"""ProtectionPolicy API — the single protection surface (paper §5.3).

Port of ``repro.core.policy``:

``SchemeRegistry``
    Every scheme registers a cost model, an executor, and a
    kernel-availability predicate; ``protected_matmul`` dispatches
    through it (executors attach from core/protected.py).

``ProtectionPolicy``
    ``FixedPolicy`` (one scheme everywhere), ``IntensityGuidedPolicy``
    (the paper's analytic roofline), ``ProfileGuidedPolicy`` (a measured
    table from core/profiler.py with analytic fallback) and
    ``ErrorAdaptivePolicy`` (escalation under an observed fault rate).
    Each serializes with ``to_json`` and comes back with
    ``policy_from_json``.

``ProtectionPlan``
    The policy compiled against (model, hardware, phase): per-layer
    selections with the explicit first-layer flag, the per-step fast
    path ``for_step`` the engine consults every step, and a JSON
    deployment artifact (``to_json``/``from_json``, validated against
    the live registry by ``validate_plan_payload``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Callable, Mapping

from repro_torch.core.hardware import DEFAULT, HardwareSpec
from repro_torch.core.intensity import GemmDims, compute_bound_ai, step_gemm_dims
from repro_torch.core.schemes import (
    BlockShape,
    Scheme,
    SchemeCost,
    cost_block_1s,
    cost_block_2s,
    cost_global,
    cost_none,
    cost_replica,
    overhead_pct,
    protected_time,
)


def scheme_name_of(scheme) -> str:
    """Canonical registry key of a Scheme enum or a raw scheme name."""
    return scheme.value if isinstance(scheme, Scheme) else str(scheme)


def as_scheme(name: str):
    """Name -> Scheme enum when it is a built-in, else the name itself
    (registered plug-in schemes have no enum member — by design)."""
    try:
        return Scheme(name)
    except ValueError:
        return name


# ------------------------------------------------------------------ registry

CostFn = Callable[[GemmDims, BlockShape, bool], SchemeCost]


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One registered ABFT scheme.

    ``cost``: analytic redundant-work model ``(dims, blocks, first_layer)
    -> SchemeCost`` — feeds the roofline overhead model and therefore the
    intensity-guided selection.
    ``executor``: ``(x, w, cfg, *, wsums, out_dtype, fault) -> (y,
    CheckResult)`` — the scheme's protected-GEMM implementation
    (``protected_matmul`` dispatches here).  Built-in executors attach
    from core/protected.py at import.
    ``available``: kernel-availability predicate over the ABFT config
    (e.g. a scheme needing a fused kernel can refuse backends
    without it); ``None`` means always available.  The predicate is
    called with the active ``ABFTConfig`` — threaded through
    ``resolve()``/``select(cfg=...)`` — or ``None`` when no config is in
    play (plan building, legacy ``select_scheme``); predicates must
    treat ``None`` as "backend unknown" and answer for the general case.
    ``auto_eligible``: candidate for automatic intensity-guided selection.
    REPLICA and BLOCK_2S stay out (one-sided dominates both, paper §6.5)
    but remain registered for explicit/ablation use.
    ``enum``: the legacy Scheme member, when one exists."""

    name: str
    cost: CostFn
    executor: Callable | None = None
    available: Callable[[Any], bool] | None = None
    auto_eligible: bool = False
    enum: Scheme | None = None

    @property
    def scheme(self):
        """Selection-facing handle: the enum for built-ins, else the name."""
        return self.enum if self.enum is not None else self.name


def _invalidate_selection_cache() -> None:
    """Registry mutations invalidate memoized selections: cached
    Selections were computed against the old candidate set / cost
    models.  (Guarded lookup: the built-ins register at module init,
    before the cache exists.)"""
    cache = globals().get("_analytic_selection")
    if cache is not None:
        cache.cache_clear()


class SchemeRegistry:
    """Name -> SchemeSpec with duplicate/unknown-name error reporting."""

    def __init__(self):
        self._specs: dict = {}

    def register(self, spec: SchemeSpec, *, override: bool = False) -> None:
        if spec.name in self._specs and not override:
            raise ValueError(
                f"scheme {spec.name!r} is already registered; pass "
                f"override=True to replace it")
        self._specs[spec.name] = spec
        _invalidate_selection_cache()

    def unregister(self, scheme) -> None:
        """Remove a registered scheme (plug-in teardown)."""
        self.get(scheme)                       # unknown-name error path
        del self._specs[scheme_name_of(scheme)]
        _invalidate_selection_cache()

    def get(self, scheme) -> SchemeSpec:
        name = scheme_name_of(scheme)
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown scheme {name!r}; registered: "
                f"{sorted(self._specs)}") from None

    def __contains__(self, scheme) -> bool:
        return scheme_name_of(scheme) in self._specs

    def names(self) -> tuple:
        return tuple(sorted(self._specs))

    def set_executor(self, scheme, fn: Callable) -> None:
        """Attach (or replace) a scheme's executor after registration —
        how core/protected.py wires the built-in execution paths in
        without a circular import."""
        name = scheme_name_of(scheme)
        self._specs[name] = dataclasses.replace(self.get(name), executor=fn)

    def executor(self, scheme) -> Callable:
        spec = self.get(scheme)
        if spec.executor is None:
            # built-in executors register when core/protected.py imports
            import repro_torch.core.protected  # noqa: F401

            spec = self.get(scheme)
        if spec.executor is None:
            raise KeyError(f"scheme {spec.name!r} has no executor")
        return spec.executor

    def auto_candidates(self, cfg=None) -> tuple:
        """Scheme names eligible for automatic selection, filtered by the
        availability predicate (``cfg`` is the active ABFT config, or
        None for 'backend unknown' — see SchemeSpec.available)."""
        return tuple(sorted(
            s.name for s in self._specs.values()
            if s.auto_eligible and (s.available is None or s.available(cfg))
        ))


_DEFAULT_REGISTRY = SchemeRegistry()
for _spec in (
    SchemeSpec("none", cost_none, enum=Scheme.NONE),
    SchemeSpec("global", cost_global, auto_eligible=True,
               enum=Scheme.GLOBAL),
    SchemeSpec("block_1s", cost_block_1s, auto_eligible=True,
               enum=Scheme.BLOCK_1S),
    SchemeSpec("block_2s", cost_block_2s, enum=Scheme.BLOCK_2S),
    SchemeSpec("replica", cost_replica, enum=Scheme.REPLICA),
):
    _DEFAULT_REGISTRY.register(_spec)


def default_registry() -> SchemeRegistry:
    """The process-wide scheme registry (plug-in schemes register here)."""
    return _DEFAULT_REGISTRY


# ------------------------------------------------------------------ selection

@dataclasses.dataclass(frozen=True)
class Selection:
    """One selection decision (scheme + the evidence behind it)."""

    scheme: Any                      # Scheme enum (built-ins) or name str
    arithmetic_intensity: float
    cmr: float
    modeled_overhead_pct: dict
    reason: str

    @property
    def scheme_name(self) -> str:
        return scheme_name_of(self.scheme)


@functools.lru_cache(maxsize=4096)
def _analytic_selection(
    dims: GemmDims,
    hw: HardwareSpec,
    blocks: BlockShape,
    candidates: tuple,
    first_layer: bool,
) -> Selection:
    """Roofline selection, cached per (dims, hardware, candidates) so the
    decision is made once per layer shape."""
    reg = default_registry()
    overheads = {
        name: overhead_pct(name, dims, hw, blocks, first_layer)
        for name in candidates
    }
    best = min(candidates, key=lambda n: (overheads[n], n))
    ai = dims.arithmetic_intensity
    bound = compute_bound_ai(ai, hw)     # the ONE boundary predicate
    reason = (
        f"AI={ai:.1f} {'>' if bound else '<='} CMR={hw.cmr:.0f}; "
        f"min modeled overhead -> {best}"
    )
    return Selection(
        scheme=reg.get(best).scheme,
        arithmetic_intensity=ai,
        cmr=hw.cmr,
        modeled_overhead_pct=dict(overheads),
        reason=reason,
    )


# ------------------------------------------------------------------ policies

class ProtectionPolicy:
    """Protocol: a per-layer ABFT selection strategy.

    Implementations are frozen dataclasses (hashable — they ride inside
    ``ABFTConfig`` and lru-cached plans) exposing::

        select(dims, hw=DEFAULT, *, first_layer=False, cfg=None)
        to_json() -> dict        # round-trips via policy_from_json

    ``cfg`` is the active ABFT config when one is in play (threaded by
    ``ABFTConfig.resolve`` so registry availability predicates can see
    the backend), or None.
    """

    kind = "abstract"

    def select(self, dims: GemmDims, hw: HardwareSpec = DEFAULT, *,
               first_layer: bool = False, cfg=None) -> Selection:
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedPolicy(ProtectionPolicy):
    """Always the same scheme (ablations, protection-off)."""

    scheme: Any = Scheme.BLOCK_1S

    kind = "fixed"

    def select(self, dims, hw=DEFAULT, *, first_layer=False,
               cfg=None) -> Selection:
        spec = default_registry().get(self.scheme)   # unknown-name guard
        return Selection(
            scheme=spec.scheme,
            arithmetic_intensity=dims.arithmetic_intensity,
            cmr=hw.cmr,
            modeled_overhead_pct={},
            reason=f"fixed scheme {spec.name}",
        )

    def to_json(self) -> dict:
        return {"kind": self.kind, "scheme": scheme_name_of(self.scheme)}


@dataclasses.dataclass(frozen=True)
class IntensityGuidedPolicy(ProtectionPolicy):
    """The paper's §5.3 decision: per layer, the candidate scheme with the
    lowest roofline-modeled execution-time overhead.  Layers below the
    device CMR land on fused block ABFT, layers above on global ABFT.
    ``candidates=()`` means 'every auto-eligible registered scheme'."""

    blocks: BlockShape = BlockShape()
    candidates: tuple = ()

    kind = "intensity"

    def _candidates(self, cfg=None) -> tuple:
        if self.candidates:
            return tuple(scheme_name_of(c) for c in self.candidates)
        return default_registry().auto_candidates(cfg)

    def select(self, dims, hw=DEFAULT, *, first_layer=False,
               cfg=None) -> Selection:
        return _analytic_selection(
            dims, hw, self.blocks, self._candidates(cfg),
            bool(first_layer))

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "blocks": dataclasses.asdict(self.blocks),
            "candidates": [scheme_name_of(c) for c in self.candidates],
        }


@dataclasses.dataclass(frozen=True)
class ProfileGuidedPolicy(ProtectionPolicy):
    """Empirical profile table (core/profiler.py) with analytic fallback
    for unprofiled shapes — the paper's CUTLASS-profiler integration.
    ``table`` accepts a mapping or iterable of (GemmDims, scheme) pairs
    and is canonicalized to a sorted tuple so the policy stays hashable
    and order-insensitive."""

    table: Any = ()
    fallback: IntensityGuidedPolicy = IntensityGuidedPolicy()

    kind = "profile"

    def __post_init__(self):
        items = (self.table.items() if isinstance(self.table, Mapping)
                 else tuple(self.table))
        canon = tuple(sorted(
            ((dims, scheme_name_of(s)) for dims, s in items),
            key=lambda e: dataclasses.astuple(e[0]),
        ))
        object.__setattr__(self, "table", canon)
        object.__setattr__(self, "_lookup", dict(canon))

    def select(self, dims, hw=DEFAULT, *, first_layer=False,
               cfg=None) -> Selection:
        hit = self._lookup.get(dims)
        if hit is not None:
            return Selection(
                scheme=default_registry().get(hit).scheme,
                arithmetic_intensity=dims.arithmetic_intensity,
                cmr=hw.cmr,
                modeled_overhead_pct={},
                reason="empirical profile table",
            )
        return self.fallback.select(dims, hw, first_layer=first_layer,
                                    cfg=cfg)

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "table": [
                {"dims": dataclasses.asdict(d), "scheme": s}
                for d, s in self.table
            ],
            "fallback": self.fallback.to_json(),
        }


class ErrorAdaptivePolicy(ProtectionPolicy):
    """Error-rate-adaptive protection ("Adaptive Soft Error Protection",
    arxiv 2407.19664; ROADMAP 5b): wrap a ``base`` policy and escalate to
    an ``escalated`` policy (strongest coverage — ``global`` by default)
    when the engine's OBSERVED error environment crosses thresholds,
    de-escalating with hysteresis when quiet.

    Unlike every other policy this one is deliberately MUTABLE (it holds
    the current protection level), so it must not ride inside a
    shared ``LayerCtx`` — the engine splits it into two immutable
    per-level configs and swaps runners/plans on ``update()`` level
    changes (see ``ServeEngine``).

    ``update(snapshot)`` consumes ``FaultRateMonitor.snapshot()`` at plan
    re-selection time:

    * escalate when the windowed OR EWMA detection rate reaches
      ``detection_threshold``, or the windowed hard-fault rate reaches
      ``hard_fault_threshold``;
    * de-escalate only after ``deescalate_after`` consecutive quiet
      updates with every rate at or below ``clear_factor`` x its
      threshold — rates in the dead band between the two keep the
      current level (no flapping).

    ``shrink_chunk`` (0 < f <= 1) optionally scales the engine's chunked
    prefill token budget while escalated: smaller chunks shrink the
    retry blast radius when errors are frequent.  ``shrink_draft``
    (0 < f <= 1) does the same for the speculative-decoding draft
    length: a shorter draft window shrinks the verify-retry blast
    radius AND the number of speculated tokens a hard fault discards.
    """

    kind = "adaptive"

    def __init__(self, base: ProtectionPolicy | None = None, *,
                 escalated: ProtectionPolicy | None = None,
                 detection_threshold: float = 0.05,
                 hard_fault_threshold: float = 0.01,
                 clear_factor: float = 0.5,
                 deescalate_after: int = 16,
                 shrink_chunk: float = 1.0,
                 shrink_draft: float = 1.0):
        if not 0.0 < clear_factor <= 1.0:
            raise ValueError("clear_factor must be in (0, 1]")
        if deescalate_after < 1:
            raise ValueError("deescalate_after must be >= 1")
        if not 0.0 < shrink_chunk <= 1.0:
            raise ValueError("shrink_chunk must be in (0, 1]")
        if not 0.0 < shrink_draft <= 1.0:
            raise ValueError("shrink_draft must be in (0, 1]")
        self.base = base if base is not None else IntensityGuidedPolicy()
        self.escalated = escalated if escalated is not None \
            else FixedPolicy(Scheme.GLOBAL)
        self.detection_threshold = float(detection_threshold)
        self.hard_fault_threshold = float(hard_fault_threshold)
        self.clear_factor = float(clear_factor)
        self.deescalate_after = int(deescalate_after)
        self.shrink_chunk = float(shrink_chunk)
        self.shrink_draft = float(shrink_draft)
        self.level = 0                 # 0 = base, 1 = escalated
        self.escalations = 0
        self.deescalations = 0
        self._quiet = 0

    @property
    def active(self) -> ProtectionPolicy:
        return self.escalated if self.level else self.base

    def update(self, snapshot: Mapping) -> bool:
        """One adaptation decision from a FaultRateMonitor snapshot.
        Returns True iff the protection level CHANGED."""
        det = max(float(snapshot.get("window_detection_rate", 0.0)),
                  float(snapshot.get("ewma_detections_per_step", 0.0)))
        hard = max(float(snapshot.get("window_hard_fault_rate", 0.0)),
                   float(snapshot.get("ewma_hard_faults_per_step", 0.0)))
        hot = det >= self.detection_threshold \
            or hard >= self.hard_fault_threshold
        cool = det <= self.clear_factor * self.detection_threshold \
            and hard <= self.clear_factor * self.hard_fault_threshold
        if self.level == 0:
            if hot:
                self.level = 1
                self.escalations += 1
                self._quiet = 0
                return True
            return False
        if not cool:                   # hot OR dead band: stay escalated
            self._quiet = 0
            return False
        self._quiet += 1
        if self._quiet >= self.deescalate_after:
            self.level = 0
            self.deescalations += 1
            self._quiet = 0
            return True
        return False

    def select(self, dims, hw=DEFAULT, *, first_layer=False,
               cfg=None) -> Selection:
        return self.active.select(dims, hw, first_layer=first_layer,
                                  cfg=cfg)

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "base": self.base.to_json(),
            "escalated": self.escalated.to_json(),
            "detection_threshold": self.detection_threshold,
            "hard_fault_threshold": self.hard_fault_threshold,
            "clear_factor": self.clear_factor,
            "deescalate_after": self.deescalate_after,
            "shrink_chunk": self.shrink_chunk,
            "shrink_draft": self.shrink_draft,
            "level": self.level,
        }


def policy_from_selector(config, profile_table=None) -> ProtectionPolicy:
    """Legacy ``SelectorConfig`` mode string -> ProtectionPolicy (the
    compatibility shim behind ``select_scheme`` and ``ABFTConfig``)."""
    if config.mode == "fixed":
        return FixedPolicy(config.fixed_scheme)
    base = IntensityGuidedPolicy(
        blocks=config.blocks, candidates=tuple(config.candidates))
    if config.mode == "profile":
        return ProfileGuidedPolicy(
            table=profile_table or (), fallback=base)
    return base


class PlanValidationError(ValueError):
    """A serialized ProtectionPlan failed static validation against the
    live SchemeRegistry (unknown scheme, duplicate layer, stale dims)."""


def _policy_scheme_names(d: dict) -> list:
    """(path, scheme-name) pairs referenced by a serialized policy."""
    kind = d.get("kind")
    if kind == "fixed":
        return [("policy.scheme", d.get("scheme"))]
    if kind == "intensity":
        return [(f"policy.candidates[{i}]", c)
                for i, c in enumerate(d.get("candidates") or ())]
    if kind == "profile":
        out = [(f"policy.table[{i}].scheme", e.get("scheme"))
               for i, e in enumerate(d.get("table") or ())]
        out += [("policy.fallback." + p.removeprefix("policy."), n)
                for p, n in _policy_scheme_names(d.get("fallback") or {})]
        return out
    if kind == "adaptive":
        out = []
        for sub in ("base", "escalated"):
            out += [(f"policy.{sub}." + p.removeprefix("policy."), n)
                    for p, n in _policy_scheme_names(d.get(sub) or {})]
        return out
    return []


def validate_plan_payload(d: dict) -> None:
    """Static validation of a serialized plan against the live registry.

    Raises ``PlanValidationError`` listing EVERY problem (diff-style, one
    line per offense) rather than stopping at the first — a stale
    deployment artifact should be fully diagnosable from one failure."""
    reg = default_registry()
    known = reg.names()
    problems = []
    seen: dict = {}
    for i, e in enumerate(d.get("layers") or ()):
        where = f"layers[{i}] {e.get('name')!r}"
        name = e.get("name")
        if name in seen:
            problems.append(
                f"{where}: duplicate layer name (first at "
                f"layers[{seen[name]}])")
        else:
            seen[name] = i
        if e.get("scheme") not in known:
            problems.append(
                f"{where}: unknown scheme {e.get('scheme')!r}; "
                f"registered: {list(known)}")
        dims = e.get("dims") or {}
        mkn = {k: dims.get(k, 1) for k in ("m", "k", "n", "batch")}
        if any(not isinstance(v, int) or v < 1 for v in mkn.values()):
            problems.append(
                f"{where}: stale dims "
                + " ".join(f"{k}={v}" for k, v in mkn.items())
                + " (m/k/n/batch must all be ints >= 1)")
        count = e.get("count", 1)
        if not isinstance(count, int) or count < 1:
            problems.append(f"{where}: count={count!r} must be an "
                            f"int >= 1")
    for path, sname in _policy_scheme_names(d.get("policy") or {}):
        if sname not in known:
            problems.append(
                f"{path}: unknown scheme {sname!r}; "
                f"registered: {list(known)}")
    if problems:
        raise PlanValidationError(
            f"ProtectionPlan JSON failed validation against the live "
            f"SchemeRegistry ({len(problems)} problem"
            f"{'s' if len(problems) != 1 else ''}):\n  - "
            + "\n  - ".join(problems))


def policy_from_json(d: dict) -> ProtectionPolicy:
    kind = d["kind"]
    if kind == "fixed":
        return FixedPolicy(as_scheme(d["scheme"]))
    if kind == "intensity":
        return IntensityGuidedPolicy(
            blocks=BlockShape(**d["blocks"]),
            candidates=tuple(d.get("candidates") or ()),
        )
    if kind == "profile":
        return ProfileGuidedPolicy(
            table=tuple(
                (GemmDims(**e["dims"]), e["scheme"]) for e in d["table"]),
            fallback=policy_from_json(d["fallback"]),
        )
    if kind == "adaptive":
        # reconstructed at level 0: runtime escalation state is engine
        # state, not deployment-artifact state
        return ErrorAdaptivePolicy(
            base=policy_from_json(d["base"]),
            escalated=policy_from_json(d["escalated"]),
            detection_threshold=d["detection_threshold"],
            hard_fault_threshold=d["hard_fault_threshold"],
            clear_factor=d["clear_factor"],
            deescalate_after=d["deescalate_after"],
            shrink_chunk=d.get("shrink_chunk", 1.0),
            shrink_draft=d.get("shrink_draft", 1.0),
        )
    raise ValueError(f"unknown policy kind {kind!r}")


# ------------------------------------------------------------------ the plan

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Plan-facing layer descriptor.  ``first`` is the EXPLICIT
    first-protected-layer flag (global ABFT pays an unfused read of A
    there, schemes.cost_global) — carried by the descriptor instead of
    inferred from enumeration order."""

    name: str
    dims: GemmDims
    count: int = 1
    first: bool = False


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    layer: LayerSpec
    selection: Selection


@dataclasses.dataclass(frozen=True)
class StepShape:
    """Geometry of one serving step's representative GEMM: the widest
    per-token projection (d_model x d_ff when an FFN exists)."""

    d_model: int
    d_ff: int
    dtype_bytes: int = 2


def as_layer_specs(layers) -> tuple:
    """Normalize plan input: an iterable of LayerSpec passes through; a
    legacy ``{name: GemmDims}`` mapping becomes descriptors with the
    first entry explicitly flagged ``first=True`` (what the old
    enumeration heuristic silently assumed)."""
    if isinstance(layers, Mapping):
        return tuple(
            LayerSpec(name=k, dims=v, first=(i == 0))
            for i, (k, v) in enumerate(layers.items())
        )
    return tuple(layers)


@dataclasses.dataclass(frozen=True)
class ProtectionPlan:
    """A ProtectionPolicy compiled against one (model, hardware, phase).

    Built once, consulted many times: per-layer selections are fixed at
    build; ``for_step`` memoizes on top of the policy.
    ``to_json``/``from_json`` round-trip the whole artifact —
    hardware spec, policy, layer descriptors, selections — so a plan can
    ship with a deployment and reproduce identical per-step schemes."""

    model: str
    phase: str
    hardware: HardwareSpec
    policy: ProtectionPolicy
    entries: tuple = ()
    step_shape: StepShape | None = None
    # tensor-parallel width the entries were compiled for: a plan built
    # with model_parallel=k describes ONE shard's post-sharding GEMMs
    model_parallel: int = 1

    def __post_init__(self):
        object.__setattr__(self, "_step_cache", {})
        object.__setattr__(self, "_tune_cache", {})

    # ---------------------------------------------------------- builders
    @classmethod
    def build(cls, layers, hw: HardwareSpec = DEFAULT,
              policy: ProtectionPolicy | None = None, *,
              model: str = "adhoc", phase: str = "prefill",
              step_shape: StepShape | None = None) -> "ProtectionPlan":
        policy = policy or IntensityGuidedPolicy()
        specs = as_layer_specs(layers)
        entries = tuple(
            PlanEntry(ls, policy.select(ls.dims, hw, first_layer=ls.first))
            for ls in specs
        )
        return cls(model=model, phase=phase, hardware=hw, policy=policy,
                   entries=entries, step_shape=step_shape)

    @classmethod
    def for_model(cls, cfg, hw: HardwareSpec = DEFAULT,
                  policy: ProtectionPolicy | None = None, *,
                  phase: str = "prefill", n_tokens: int = 128,
                  dtype_bytes: int = 2,
                  model_parallel: int = 1) -> "ProtectionPlan":
        """Compile a plan for a ModelConfig: per-GEMM-site descriptors
        with the true first layer flagged from the model's layer plan.

        ``model_parallel=k`` compiles the plan from one device's
        POST-sharding GEMM shapes on a k-wide model axis
        (``counting.shard_gemms``) — the per-shard plan a sharded serving
        executor would install (sharded serving itself is not ported).
        The step fast path shrinks with it: the representative per-token
        projection is column-parallel, so its n dim is d_ff/k per
        device."""
        from repro_torch.models.counting import layer_specs

        mp = max(1, int(model_parallel))
        d_ff = cfg.d_ff or cfg.d_model
        if mp > 1 and d_ff % mp == 0:
            d_ff //= mp
        plan = cls.build(
            layer_specs(cfg, n_tokens, dtype_bytes=dtype_bytes,
                        model_parallel=mp),
            hw=hw, policy=policy, model=cfg.name, phase=phase,
            step_shape=StepShape(
                d_model=cfg.d_model, d_ff=d_ff, dtype_bytes=dtype_bytes),
        )
        if mp != 1:
            plan = dataclasses.replace(plan, model_parallel=mp)
        return plan

    # ---------------------------------------------------------- lookups
    def scheme_for(self, layer_name: str) -> str:
        for e in self.entries:
            if e.layer.name == layer_name:
                return e.selection.scheme_name
        raise KeyError(
            f"no layer {layer_name!r} in plan; layers: "
            f"{[e.layer.name for e in self.entries]}")

    def report_rows(self) -> list:
        """Human-readable per-layer table (the pre-deployment report)."""
        rows = []
        for e in self.entries:
            d, sel = e.layer.dims, e.selection
            rows.append({
                "layer": e.layer.name,
                "m": d.m, "k": d.k, "n": d.n, "batch": d.batch,
                "count": e.layer.count,
                "first": e.layer.first,
                "ai": round(sel.arithmetic_intensity, 2),
                "bound": ("compute"
                          if compute_bound_ai(
                              sel.arithmetic_intensity, self.hardware)
                          else "bandwidth"),
                "scheme": sel.scheme_name,
                "overheads_pct": {
                    k: round(v, 3)
                    for k, v in sel.modeled_overhead_pct.items()},
            })
        return rows

    # ------------------------------------------------------- serving fast path
    def step_dims(self, tokens: int) -> GemmDims:
        if self.step_shape is None:
            raise ValueError("plan has no step_shape; build it via "
                             "for_model() or pass step_shape= to build()")
        s = self.step_shape
        return step_gemm_dims(tokens, s.d_model, s.d_ff,
                              dtype_bytes=s.dtype_bytes)

    def step_intensity(self, tokens: int) -> float:
        return self.step_dims(tokens).arithmetic_intensity

    def modeled_step_time(self, tokens: int) -> float:
        """Roofline-modeled execution time of one step's representative
        GEMM under the scheme the policy selects for that composition
        (the throughput model behind the chunk-budget margin)."""
        sel = self.for_step(tokens)
        return protected_time(
            sel.scheme, self.step_dims(tokens), self.hardware)

    def for_step(self, decode_tokens: int,
                 prefill_tokens: int = 0) -> Selection:
        """Selection for one serving step's ACTUAL token composition
        (resident decode tokens + co-scheduled prefill-chunk tokens) —
        the cached fast path the engine consults every executed step.
        Intensity depends only on the total, so the cache is keyed by
        ``decode + prefill``."""
        tokens = int(decode_tokens) + int(prefill_tokens)
        sel = self._step_cache.get(tokens)
        if sel is None:
            sel = self.policy.select(self.step_dims(tokens), self.hardware)
            self._step_cache[tokens] = sel
        return sel

    def tune_chunk_budget(self, decode_tokens: int = 0, *, lo: int = 8,
                          hi: int = 4096, quantum: int = 8,
                          tput_margin: float | None = 0.1) -> int:
        """Roofline chunk-budget autotuning (ROADMAP item): the smallest
        per-step token budget that (a) clears the device CMR — strictly,
        via ``compute_bound_ai`` — AND (b) keeps modeled per-token step
        time within ``tput_margin`` of the best attainable budget under
        ``hi``.  (a) alone lands exactly on the roofline knee, where the
        redundant-work and fixed-op terms are not yet amortized; (b)
        walks just far enough past the knee that a fixed-budget sweep
        cannot beat the tuned budget's throughput by more than the
        margin.  ``tput_margin=None`` disables (b) and returns the bare
        crossing.

        The floor tracks occupancy: the budget always exceeds
        ``decode_tokens`` by at least one quantum, so resident decodes
        (packed first) can never starve prefill progress.  When the step
        geometry cannot reach the CMR below ``hi`` (small models, huge
        CMR), the cap is returned — the maximum-intensity budget
        attainable.  Budgets are quantized to ``quantum`` (the engine's
        chunk-length bucketing, serve/engine._pad_len)."""
        q = max(1, int(quantum))
        key = (int(decode_tokens), int(lo), int(hi), q, tput_margin)
        got = self._tune_cache.get(key)
        if got is not None:
            return got
        floor = max(int(lo), int(decode_tokens) + q)
        floor = -(-floor // q) * q
        cap = max(floor, (int(hi) // q) * q)

        def clears(b: int) -> bool:
            return compute_bound_ai(self.step_intensity(b), self.hardware)

        if clears(floor):
            best = floor
        elif not clears(cap):
            best = cap
        else:
            # AI is monotone in tokens: binary-search the crossing
            lo_b, hi_b = floor, cap          # !clears(lo_b), clears(hi_b)
            while hi_b - lo_b > q:
                mid = ((lo_b + hi_b) // 2) // q * q
                if mid <= lo_b:
                    mid = lo_b + q
                if clears(mid):
                    hi_b = mid
                else:
                    lo_b = mid
            best = hi_b
        if tput_margin is not None and best < cap:
            # per-token step time decreases as the budget amortizes the
            # scheme's fixed terms: advance until within the margin of
            # the cap's per-token time
            target = (1.0 + tput_margin) * self.modeled_step_time(cap) / cap
            while best < cap and \
                    self.modeled_step_time(best) / best > target:
                best += q
        self._tune_cache[key] = best
        return best

    def tune_draft_len(self, batch: int = 1, *, lo: int = 1, hi: int = 8,
                       accept_rate: float = 0.7,
                       tput_margin: float = 0.0) -> int:
        """Roofline draft-length autotuning for speculative decoding: the
        LARGEST K in ``[lo, hi]`` whose modeled time per EMITTED token of a
        verify step (``batch * (K+1)`` tokens through the decode GEMMs, on
        ``modeled_step_time``) beats plain decode's per-token time by at
        least ``tput_margin``.  With independent per-draft acceptance
        probability a = ``accept_rate``, a slot emits ``a(1-a^K)/(1-a) + 1``
        tokens a step (the accepted prefix plus the bonus token).  Returns
        0 when no K wins.  Memoized with the chunk budget's cache."""
        b = max(1, int(batch))
        a = min(max(float(accept_rate), 0.0), 1.0)
        key = ("draft", b, int(lo), int(hi), a, float(tput_margin))
        got = self._tune_cache.get(key)
        if got is not None:
            return got
        base = self.modeled_step_time(b) / b     # plain decode, s/token

        def per_token(k: int) -> float:
            emitted = (k + 1.0) if a >= 1.0 \
                else a * (1.0 - a ** k) / (1.0 - a) + 1.0
            return self.modeled_step_time(b * (k + 1)) / (b * emitted)

        best = 0
        for k in range(max(1, int(lo)), max(1, int(hi)) + 1):
            if per_token(k) < base * (1.0 - float(tput_margin)):
                best = k
        self._tune_cache[key] = best
        return best

    # ---------------------------------------------------------- serialization
    def to_json(self, indent: int | None = 2) -> str:
        payload = {
            "version": 1,
            "model": self.model,
            "phase": self.phase,
            "model_parallel": self.model_parallel,
            "hardware": dataclasses.asdict(self.hardware),
            "policy": self.policy.to_json(),
            "step_shape": (dataclasses.asdict(self.step_shape)
                           if self.step_shape is not None else None),
            "layers": [
                {
                    "name": e.layer.name,
                    "dims": dataclasses.asdict(e.layer.dims),
                    "count": e.layer.count,
                    "first": e.layer.first,
                    "scheme": e.selection.scheme_name,
                    "arithmetic_intensity": e.selection.arithmetic_intensity,
                    "cmr": e.selection.cmr,
                    "modeled_overhead_pct": e.selection.modeled_overhead_pct,
                    "reason": e.selection.reason,
                }
                for e in self.entries
            ],
        }
        return json.dumps(payload, indent=indent)

    @classmethod
    def from_json(cls, payload) -> "ProtectionPlan":
        d = json.loads(payload) if isinstance(payload, str) else payload
        validate_plan_payload(d)
        entries = tuple(
            PlanEntry(
                LayerSpec(name=e["name"], dims=GemmDims(**e["dims"]),
                          count=e["count"], first=e["first"]),
                Selection(
                    scheme=as_scheme(e["scheme"]),
                    arithmetic_intensity=e["arithmetic_intensity"],
                    cmr=e["cmr"],
                    modeled_overhead_pct=e["modeled_overhead_pct"],
                    reason=e["reason"]),
            )
            for e in d["layers"]
        )
        return cls(
            model=d["model"],
            phase=d["phase"],
            hardware=HardwareSpec(**d["hardware"]),
            policy=policy_from_json(d["policy"]),
            entries=entries,
            step_shape=(StepShape(**d["step_shape"])
                        if d.get("step_shape") else None),
            model_parallel=int(d.get("model_parallel", 1)),
        )
