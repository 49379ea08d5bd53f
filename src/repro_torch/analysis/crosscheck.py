"""Plan <-> trace cross-validation (port of ``repro.analysis.crosscheck``):
the compiled ``ProtectionPlan`` and the executed computation must agree
site for site.

The plan (core/policy.py) is the deployment artifact that *claims* which
GEMM sites exist and how each is protected; the walked ops are what the
model *actually* executes.  ``crosscheck_plan`` proves the two describe
the same set of GEMMs:

* every plan ``LayerSpec`` name matches at least one executed
  ``abft[...]`` site marker (else the plan lists a layer the model never
  runs — stale artifact);
* every executed site matches exactly one plan entry (else a GEMM was
  added to the model without a plan descriptor — silent coverage drift);
* the (k, n) GEMM class executed under a site equals the plan entry's
  descriptor dims (else the plan was compiled for different shapes).

Scheme equality is deliberately NOT required: the audit may run with one
backend config while a deployment plan is compiled for another, and the
selection itself is the policy's job — the bijection is about the
*surface*, not the decision.

The M dim is likewise ignored: the plan's representative token count and
the audit's example batch are independent choices; k and n are the
weight-determined class identity.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.markers import parse_name_stack


@dataclasses.dataclass(frozen=True)
class CrossCheckResult:
    """Outcome of one plan <-> trace comparison."""

    model: str
    matched: tuple                  # site names present and agreeing
    plan_only: tuple                # plan layers never traced
    trace_only: tuple               # traced sites missing from the plan
    dim_mismatches: tuple           # (site, plan_kn, traced_kns)

    @property
    def bijective(self) -> bool:
        return not (self.plan_only or self.trace_only
                    or self.dim_mismatches)

    def report(self) -> str:
        """Diff-style report: one line per disagreement."""
        if self.bijective:
            return (f"plan <-> trace bijective for {self.model!r} "
                    f"({len(self.matched)} sites)")
        lines = [f"plan <-> trace MISMATCH for {self.model!r}:"]
        for name in self.plan_only:
            lines.append(
                f"  - plan-only layer {name!r}: listed in the plan but "
                f"never traced (stale plan, or the site was removed)")
        for name in self.trace_only:
            lines.append(
                f"  + trace-only site {name!r}: executed by the model "
                f"but absent from the plan (counting.layer_gemms drift)")
        for name, plan_kn, traced in self.dim_mismatches:
            lines.append(
                f"  ! dims differ at {name!r}: plan (k,n)={plan_kn}, "
                f"traced {sorted(traced)}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "bijective": self.bijective,
            "n_sites": len(self.matched),
            "matched": sorted(self.matched),
            "plan_only": sorted(self.plan_only),
            "trace_only": sorted(self.trace_only),
            "dim_mismatches": [
                {"site": s, "plan_kn": list(p),
                 "traced_kns": sorted(list(t) for t in ts)}
                for s, p, ts in self.dim_mismatches
            ],
        }


def traced_sites(ops) -> dict:
    """site tag -> set of executed (k, n) GEMM classes, from the PRIMARY
    protected products only.  Check contractions run against a rank-1
    checksum vector (n == 1); the protected GEMM itself — a plain product
    or a K1 record — always has n > 1, so the n > 1 filter isolates the
    op the site tag names."""
    sites: dict = {}
    for op in ops:
        if op.primitive == "convolution" or op.n <= 1:
            continue
        m = parse_name_stack(op.name_stack)
        if m.protected:
            sites.setdefault(m.site, set()).add((op.k, op.n))
    return sites


def crosscheck_plan(plan, ops, model: str = "") -> CrossCheckResult:
    """Compare a compiled ProtectionPlan against a walked-op inventory
    (``op_walk.flop_ops`` output, typically the union of prefill and
    decode — some sites, e.g. ``cross.k``/``vision.proj``, only execute
    during prefill)."""
    traced = traced_sites(ops)
    plan_kn = {e.layer.name: (e.layer.dims.k, e.layer.dims.n)
               for e in plan.entries}

    plan_only = tuple(sorted(set(plan_kn) - set(traced)))
    trace_only = tuple(sorted(set(traced) - set(plan_kn)))
    matched, mismatches = [], []
    for name in sorted(set(plan_kn) & set(traced)):
        if traced[name] == {plan_kn[name]}:
            matched.append(name)
        else:
            mismatches.append(
                (name, plan_kn[name], frozenset(traced[name])))
    return CrossCheckResult(
        model=model or plan.model,
        matched=tuple(matched),
        plan_only=plan_only,
        trace_only=trace_only,
        dim_mismatches=tuple(mismatches),
    )
