"""Protection-coverage analysis, the auditor (port of ``repro.analysis``).

Proves — by running the engine's real entry points under an op walker and
recording every FLOP-carrying op — that each GEMM of the served step flows
through a registered ABFT scheme, and that the compiled
``ProtectionPlan`` and the executed computation agree site for site.

Modules:
  markers      — the marker protocol: ``abft[..][..]``, ``flops[..]`` and
                 ``kernel[..]`` scopes on a host-side stack, no-ops while
                 no walker records.
  op_walk      — the ``TorchDispatchMode`` FLOP inventory (the
                 counterpart of the reference's ``jaxpr_walk``), with the
                 kernels' own records.
  crosscheck   — plan <-> trace bijection (LayerSpec <-> protected site).
  audit        — classification, coverage report, entry-point runs.

CLI: ``python -m repro_torch.launch.audit --config <name> [--phase ...]``.

Attribute access is lazy: core/protected.py and the kernel wrappers import
the marker protocol, so this package must not eagerly import the model
zoo (audit.py) back into core.
"""

_EXPORTS = {
    "AuditReport": "repro_torch.analysis.audit",
    "ClassifiedOp": "repro_torch.analysis.audit",
    "PhaseCoverage": "repro_torch.analysis.audit",
    "audit_config": "repro_torch.analysis.audit",
    "audit_model": "repro_torch.analysis.audit",
    "classify": "repro_torch.analysis.audit",
    "flash_allowlist_check": "repro_torch.analysis.audit",
    "resolve_arch": "repro_torch.analysis.audit",
    "CrossCheckResult": "repro_torch.analysis.crosscheck",
    "crosscheck_plan": "repro_torch.analysis.crosscheck",
    "TracedOp": "repro_torch.analysis.op_walk",
    "flop_ops": "repro_torch.analysis.op_walk",
    "coverage_scope": "repro_torch.analysis.markers",
    "parse_name_stack": "repro_torch.analysis.markers",
    "protection_scope": "repro_torch.analysis.markers",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.analysis' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
