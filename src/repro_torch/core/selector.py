"""Legacy selection facade (DEPRECATED — use core/policy.py); a port of
``repro.core.selector``.

The intensity-guided per-layer selection (paper §5.3) now lives in the
ProtectionPolicy API: ``IntensityGuidedPolicy`` (analytic roofline),
``ProfileGuidedPolicy`` (empirical table + analytic fallback),
``FixedPolicy``, and the compiled ``ProtectionPlan``.  This module keeps
the original entry points as thin delegations so existing callers and
scripts keep working:

* ``select_scheme(dims, hw, SelectorConfig(...))`` — builds the
  equivalent policy (``policy_from_selector``) and delegates; decisions
  are bit-identical to the policy API because they ARE the policy API.
* ``selection_report`` — builds a ``ProtectionPlan`` whose layer
  descriptors carry the explicit ``first`` flag (a Mapping input marks
  its first entry, matching the old enumeration behavior; pass
  ``LayerSpec``s to place the flag on the true first layer).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.hardware import DEFAULT, HardwareSpec
from repro_torch.core.intensity import GemmDims
from repro_torch.core.policy import (
    LayerSpec,
    ProtectionPlan,
    Selection,
    default_registry,
    policy_from_selector,
)
from repro_torch.core.schemes import BlockShape, Scheme, protected_time

__all__ = [
    "LayerSpec",
    "Selection",
    "SelectorConfig",
    "select_scheme",
    "selection_report",
    "modeled_layer_time",
]


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    """DEPRECATED mode-string selector config; ``policy_from_selector``
    maps it onto the ProtectionPolicy it denotes."""

    mode: str = "analytic"                 # "analytic" | "profile" | "fixed"
    fixed_scheme: Scheme = Scheme.BLOCK_1S  # used when mode == "fixed"
    blocks: BlockShape = BlockShape()
    # () => every auto-eligible AND available registered scheme (the
    # built-ins: global + block_1s — REPLICA/BLOCK_2S stay out, one-sided
    # dominates both per paper §6.5); pin a tuple to override
    candidates: tuple = ()


def select_scheme(
    dims: GemmDims,
    hw: HardwareSpec = DEFAULT,
    config: SelectorConfig = SelectorConfig(),
    profile_table: Mapping[GemmDims, Scheme] | None = None,
    first_layer: bool = False,
) -> Selection:
    """Pick the ABFT scheme for one linear layer (legacy entry point)."""
    if config.mode == "profile" and profile_table and dims in profile_table:
        # legacy semantics preserved: a LIVE O(1) table hit per call —
        # canonicalizing the whole table into a ProfileGuidedPolicy per
        # select would re-sort it for every layer site.  Long-lived
        # tables should build the policy once (profiler.
        # build_profile_policy) instead of passing a dict here.
        return Selection(
            scheme=default_registry().get(profile_table[dims]).scheme,
            arithmetic_intensity=dims.arithmetic_intensity,
            cmr=hw.cmr,
            modeled_overhead_pct={},
            reason="empirical profile table",
        )
    policy = policy_from_selector(config)
    return policy.select(dims, hw, first_layer=first_layer)


def selection_report(
    layer_dims,
    hw: HardwareSpec = DEFAULT,
    config: SelectorConfig = SelectorConfig(),
) -> list[dict]:
    """Human-readable per-layer selection table (used by the examples and
    the pre-deployment report).  ``layer_dims``: a ``{name: GemmDims}``
    mapping (first entry explicitly flagged as the first protected
    layer) or an iterable of ``LayerSpec`` with the flag placed by the
    caller."""
    plan = ProtectionPlan.build(
        layer_dims, hw=hw, policy=policy_from_selector(config),
        model="report", phase="report")
    return plan.report_rows()


def modeled_layer_time(
    dims: GemmDims,
    scheme: Scheme,
    hw: HardwareSpec = DEFAULT,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> float:
    return protected_time(scheme, dims, hw, blocks, first_layer)
