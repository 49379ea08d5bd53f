"""ProtectionPolicy API — the single protection surface (paper §5.3).

Port of ``repro.core.policy``, the subset the serving engine uses:

``SchemeRegistry``
    Every scheme registers a cost model, an executor, and a
    kernel-availability predicate; ``protected_matmul`` dispatches
    through it (executors attach from core/protected.py).

``FixedPolicy`` / ``IntensityGuidedPolicy``
    One scheme everywhere, or the paper's analytic roofline decision:
    per layer, the candidate with the lowest modeled execution-time
    overhead (lru-cached per GEMM shape).

``ProtectionPlan``
    The policy compiled against (model, hardware, phase): per-layer
    selections with the explicit first-layer flag, ``report_rows`` and
    the per-step fast path ``for_step`` the engine consults every step.

Not ported in this slice: ``ProfileGuidedPolicy``, ``ErrorAdaptivePolicy``,
plan/policy JSON, ``tune_chunk_budget`` and ``tune_draft_len``.
"""

from __future__ import annotations

import dataclasses
import functools
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
)


def scheme_name_of(scheme) -> str:
    """Canonical registry key of a Scheme enum or a raw scheme name."""
    return scheme.value if isinstance(scheme, Scheme) else str(scheme)


# ------------------------------------------------------------------ registry

CostFn = Callable[[GemmDims, BlockShape, bool], SchemeCost]


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """One registered ABFT scheme: analytic ``cost`` model, ``executor``
    ``(x, w, cfg, *, wsums, out_dtype, fault) -> (y, CheckResult)``,
    optional ``available(cfg)`` predicate, and whether intensity-guided
    selection may pick it (``auto_eligible``)."""

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
    """Registry mutations invalidate memoized selections."""
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

    def get(self, scheme) -> SchemeSpec:
        name = scheme_name_of(scheme)
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown scheme {name!r}; registered: "
                f"{sorted(self._specs)}") from None

    def set_executor(self, scheme, fn: Callable) -> None:
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
    """The process-wide scheme registry."""
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
    """Roofline selection, cached per (dims, hardware, candidates)."""
    reg = default_registry()
    overheads = {
        name: overhead_pct(name, dims, hw, blocks, first_layer)
        for name in candidates
    }
    best = min(candidates, key=lambda n: (overheads[n], n))
    ai = dims.arithmetic_intensity
    bound = compute_bound_ai(ai, hw)
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
    """Protocol: a per-layer ABFT selection strategy (frozen, hashable)."""

    kind = "abstract"

    def select(self, dims: GemmDims, hw: HardwareSpec = DEFAULT, *,
               first_layer: bool = False, cfg=None) -> Selection:
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


@dataclasses.dataclass(frozen=True)
class IntensityGuidedPolicy(ProtectionPolicy):
    """The paper's §5.3 decision: per layer, the candidate scheme with the
    lowest roofline-modeled execution-time overhead.  ``candidates=()``
    means 'every auto-eligible registered scheme'."""

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


# ------------------------------------------------------------------ the plan

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Plan-facing layer descriptor with the EXPLICIT first-layer flag."""

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
    """An iterable of LayerSpec passes through; a ``{name: GemmDims}``
    mapping becomes descriptors with the first entry flagged."""
    if isinstance(layers, Mapping):
        return tuple(
            LayerSpec(name=k, dims=v, first=(i == 0))
            for i, (k, v) in enumerate(layers.items())
        )
    return tuple(layers)


@dataclasses.dataclass(frozen=True)
class ProtectionPlan:
    """A ProtectionPolicy compiled against one (model, hardware, phase)."""

    model: str
    phase: str
    hardware: HardwareSpec
    policy: ProtectionPolicy
    entries: tuple = ()
    step_shape: StepShape | None = None
    model_parallel: int = 1

    def __post_init__(self):
        object.__setattr__(self, "_step_cache", {})

    @classmethod
    def build(cls, layers, hw: HardwareSpec = DEFAULT,
              policy: ProtectionPolicy | None = None, *,
              model: str = "adhoc", phase: str = "prefill",
              step_shape: StepShape | None = None) -> "ProtectionPlan":
        policy = policy or IntensityGuidedPolicy()
        entries = tuple(
            PlanEntry(ls, policy.select(ls.dims, hw, first_layer=ls.first))
            for ls in as_layer_specs(layers)
        )
        return cls(model=model, phase=phase, hardware=hw, policy=policy,
                   entries=entries, step_shape=step_shape)

    @classmethod
    def for_model(cls, cfg, hw: HardwareSpec = DEFAULT,
                  policy: ProtectionPolicy | None = None, *,
                  phase: str = "prefill", n_tokens: int = 128,
                  dtype_bytes: int = 2,
                  model_parallel: int = 1) -> "ProtectionPlan":
        """Compile a plan for a ModelConfig (single device: tensor
        parallelism is not ported, so ``model_parallel`` must be 1)."""
        from repro_torch.models.counting import layer_specs

        if int(model_parallel) != 1:
            raise NotImplementedError(
                "sharded protection plans are not ported yet")
        return cls.build(
            layer_specs(cfg, n_tokens, dtype_bytes=dtype_bytes),
            hw=hw, policy=policy, model=cfg.name, phase=phase,
            step_shape=StepShape(d_model=cfg.d_model,
                                 d_ff=cfg.d_ff or cfg.d_model,
                                 dtype_bytes=dtype_bytes))

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

    def step_dims(self, tokens: int) -> GemmDims:
        if self.step_shape is None:
            raise ValueError("plan has no step_shape; build it via "
                             "for_model() or pass step_shape= to build()")
        s = self.step_shape
        return step_gemm_dims(tokens, s.d_model, s.d_ff,
                              dtype_bytes=s.dtype_bytes)

    def for_step(self, decode_tokens: int,
                 prefill_tokens: int = 0) -> Selection:
        """Selection for one serving step's ACTUAL token composition,
        cached by ``decode + prefill`` (intensity depends on the total)."""
        tokens = int(decode_tokens) + int(prefill_tokens)
        sel = self._step_cache.get(tokens)
        if sel is None:
            sel = self.policy.select(self.step_dims(tokens), self.hardware)
            self._step_cache[tokens] = sel
        return sel
