"""Per-op HBM-traffic profile of a dry-run cell (port of
``repro.roofline.profile``): ranks the byte contributors of its saved
walk, the ops of every layer folded together (``layer[3]`` ->
``layer[*]``) with their multiplicity, as the reference ranks HLO ops
with their loop trip counts applied.

  PYTHONPATH=src python -m repro_torch.roofline.profile \\
      results/dryrun/llama3.2-1b__train_4k__single.ops.jsonl.gz [topN]
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict

_LAYER = re.compile(r"layer\[\d+\]")


def top_contributors(ops, n: int = 20) -> list:
    """The ``n`` largest byte contributors of ``ops`` (``CostOp``s):
    rows (bytes, count, kind, site, geometry), one a kind, geometry and
    path with the layer index folded, largest first; a collective's
    payload counts as its bytes, marked ``[coll]``."""
    acc = defaultdict(lambda: [0.0, 0])
    for op in ops:
        coll = op.payload > 0
        key = (("[coll]" if coll else "") + op.kind,
               _LAYER.sub("layer[*]", op.path), tuple(op.geometry))
        row = acc[key]
        row[0] += op.payload if coll else op.bytes
        row[1] += 1
    rows = [(b, k, kind, site, geom)
            for (kind, site, geom), (b, k) in acc.items()]
    rows.sort(key=lambda r: (-r[0], r[2], r[3], str(r[4])))
    return rows[:n]


def format_rows(rows: list, n: int) -> list:
    total = sum(r[0] for r in rows)
    out = [f"top-{n} contributors (sum {total:.3e} B):"]
    for b, k, kind, site, geom in rows:
        out.append(f"{b:10.3e}  x{k:7.0f}  {kind:20s} {site[:40]:40s} "
                   f"{str(geom)[:40]}")
    return out


def main():
    from repro_torch.roofline.reanalyze import load_ops

    path = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    print("\n".join(format_rows(top_contributors(load_ops(path), n), n)))


if __name__ == "__main__":
    main()
