"""Re-derive the roofline terms of every saved dry-run cell from its
``.ops.jsonl.gz`` (port of ``repro.roofline.reanalyze``, which re-parses
the saved HLO): a change to the terms or the hardware applies without
walking the cells again.

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [results/dryrun ...]
"""

from __future__ import annotations

import gzip
import json
import pathlib
import sys

from repro_torch.core.hardware import get_hardware
from repro_torch.roofline.analysis import record_from_ops
from repro_torch.roofline.op_cost import CostOp

SUFFIX = ".ops.jsonl.gz"


def load_ops(path: pathlib.Path) -> list:
    """The ``CostOp``s of one saved cell."""
    with gzip.open(path, "rt") as f:
        return [CostOp.from_json(json.loads(line)) for line in f]


def reanalyze_dir(d: pathlib.Path) -> int:
    n = 0
    for ops_path in sorted(d.glob("*" + SUFFIX)):
        json_path = ops_path.with_name(
            ops_path.name[:-len(SUFFIX)] + ".json")
        if not json_path.exists():
            continue
        rec = json.loads(json_path.read_text())
        if rec.get("status") != "ok":
            continue
        rec.update(record_from_ops(load_ops(ops_path), rec["memory"],
                                   get_hardware(rec["hardware"])))
        chips = rec.get("chips", 256)
        rec["hlo_flops_global"] = rec["flops_per_device"] * chips
        if rec.get("model_flops"):
            rec["useful_flops_ratio"] = (
                rec["model_flops"] / rec["hlo_flops_global"])
        json_path.write_text(json.dumps(rec, indent=2, default=str))
        n += 1
    return n


def main():
    dirs = [pathlib.Path(p) for p in (sys.argv[1:] or ["results/dryrun",
                                                       "results/perf"])]
    total = 0
    for d in dirs:
        if d.exists():
            n = reanalyze_dir(d)
            print(f"{d}: reanalyzed {n} cells")
            total += n
    return 0 if total else 1


if __name__ == "__main__":
    raise SystemExit(main())
