"""Protection-coverage audit CLI: prove every FLOP of the served entry
points flows through a registered ABFT scheme (analysis/audit.py).  Port
of ``repro.launch.audit``.

  PYTHONPATH=src python -m repro_torch.launch.audit --config llama3.2-1b \\
      --phase mixed --fail-under 1.0 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.audit --all \\
      --json results/AUDIT_coverage.json

Runs on the card unless ``--device cpu``; ``--hardware`` names the
roofline the policy selects against and the plan is compiled for (the
H100 by default; ``tpu-v5e`` selects as the reference does).

Exit status: nonzero when any audited config's protected fraction falls
below ``--fail-under``, or when any plan <-> trace crosscheck is not
bijective (stale / drifted ProtectionPlan) — both are CI-gate failures.
Config names accept dash/dot/underscore aliases (``llama3_2_1b``).
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.analysis.audit import PHASES, audit_config, resolve_arch
from repro_torch.configs import ALL_ARCHS
from repro_torch.core.hardware import DEFAULT, get_hardware

SCHEMA = "repro/audit_coverage/v1"


def run_audits(names, phase: str, **kw) -> dict:
    """name -> AuditReport, printing each summary as it lands."""
    reports = {}
    for name in names:
        rep = audit_config(name, phase=phase, **kw)
        reports[name] = rep
        print(rep.summary())
        print()
    return reports


def to_payload(reports: dict, phase: str) -> dict:
    return {
        "schema": SCHEMA,
        "phase": phase,
        "configs": {name: rep.to_json()
                    for name, rep in sorted(reports.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="op-level ABFT protection-coverage audit")
    ap.add_argument("--config", default=None,
                    help="architecture to audit (alias-friendly: "
                         "llama3_2_1b == llama3.2-1b)")
    ap.add_argument("--all", action="store_true",
                    help="audit every registered architecture")
    ap.add_argument("--phase", choices=PHASES, default="mixed")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full machine-readable report here")
    ap.add_argument("--fail-under", type=float, default=None,
                    metavar="FRAC",
                    help="exit nonzero if any protected fraction is "
                         "below FRAC (e.g. 1.0)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--hardware", default=DEFAULT.name,
                    help="roofline the plan is compiled for "
                         f"(default {DEFAULT.name})")
    args = ap.parse_args(argv)

    if args.all:
        names = list(ALL_ARCHS)
    elif args.config:
        names = [resolve_arch(args.config)]
    else:
        ap.error("one of --config <name> or --all is required")

    reports = run_audits(names, args.phase, device=args.device,
                         hardware=get_hardware(args.hardware))

    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(to_payload(reports, args.phase),
                                   indent=2, sort_keys=True) + "\n")
        print(f"wrote {path}")

    failed = False
    for name, rep in reports.items():
        if not rep.crosscheck.bijective:
            print(f"FAIL {name}: plan <-> trace not bijective")
            failed = True
        if (args.fail_under is not None
                and rep.protected_fraction < args.fail_under):
            print(f"FAIL {name}: protected fraction "
                  f"{rep.protected_fraction:.4f} < {args.fail_under}")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
