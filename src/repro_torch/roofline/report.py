"""Render the dry-run and roofline tables from the dry-run JSONs (port of
``repro.roofline.report``; the same strings for the same records).

  PYTHONPATH=src python -m repro_torch.roofline.report [results/dryrun]
"""

from __future__ import annotations

import json
import pathlib
import sys


def _fmt_s(x: float) -> str:
    if x >= 0.1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.2f}ms"


def load(dirpath: str = "results/dryrun") -> list:
    recs = []
    for p in sorted(pathlib.Path(dirpath).glob("*.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def dryrun_table(recs: list) -> str:
    lines = [
        "| arch | shape | mesh | chips | status | HBM/dev | compile |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | "
                f"SKIP ({r['reason'].split(':')[0]}) | - | - |")
        elif r.get("status") == "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} "
                f"| ok | {r['hbm_per_device_gib']:.1f} GiB | "
                f"{r['compile_s']:.0f}s |")
        else:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | ERROR | "
                f"- | - |")
    return "\n".join(lines)


def roofline_table(recs: list, mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MODEL/HLO flops | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        note = _bottleneck_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} | "
            f"{note} |")
    return "\n".join(lines)


def _bottleneck_note(r: dict) -> str:
    b = r["bottleneck"]
    if b == "compute":
        return ("reduce HLO/MODEL flop gap (remat policy, causal-block "
                "skipping)")
    if b == "memory":
        return ("cut activation traffic: larger attention chunks, fused "
                "kernels, bf16 residuals")
    return "reshard to cut all-gathers (kv layout, fsdp bucket size)"


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    recs = load(d)
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single-pod 16x16, per-chip terms)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "pod"))


if __name__ == "__main__":
    main()
