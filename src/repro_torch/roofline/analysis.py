"""Roofline analysis of one rank's step (port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), per device:

  compute    = FLOPs / peak_FLOP/s
  memory     = bytes / HBM_bw
  collective = collective_bytes / link_bw

The reference reads the per-device FLOPs, bytes and collective payloads
from the post-SPMD HLO of a compiled cell and its memory from
``compiled.memory_analysis()``.  The port runs one rank's program under
``op_cost.CostWalker`` instead (on the meta device in the dry run), so
its numbers are per device by construction: ``collective_bytes`` sums
the walk's collective records where the reference scanned the HLO text,
and ``analyze_step`` takes the place of ``analyze_compiled``.  There is
no ``xla_cost_flops``/``xla_cost_bytes`` counterpart (no compiler cost
model to hold the walk against), so those keys are left out.  The
hardware is the H100 SXM's data sheet by default (``core/hardware.py``).
"""

from __future__ import annotations

from repro_torch.core.hardware import NVIDIA_H100_SXM, HardwareSpec
from repro_torch.roofline.op_cost import (
    COLLECTIVE_OPS,
    CostWalker,
    _tensors,
    analyze_ops,
)

__all__ = ["COLLECTIVE_OPS", "analyze_step", "collective_bytes",
           "record_from_ops", "roofline_terms"]


def collective_bytes(ops) -> dict:
    """Per-collective-kind per-device payload bytes of a walk's
    ``CostOp``s, with their counts under ``_counts`` (the reference's
    ``collective_bytes`` of the HLO text, same keys)."""
    rec = analyze_ops(ops)
    return dict(rec["collectives"], _counts=rec["collective_op_counts"])


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    hw: HardwareSpec = NVIDIA_H100_SXM,
) -> dict:
    t_compute = flops_per_device / hw.peak_flops
    t_memory = bytes_per_device / hw.hbm_bw
    t_collective = collective_bytes_per_device / hw.ici_bw
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dom = max(terms, key=terms.get)
    bound = {"compute_s": "compute", "memory_s": "memory",
             "collective_s": "collective"}[dom]
    t_bound = max(terms.values())
    total = sum(terms.values())
    return dict(
        terms,
        bottleneck=bound,
        t_bound_s=t_bound,
        # roofline fraction: how much of the step the dominant term is of a
        # perfectly-overlapped ideal (1.0 = at the dominant roof)
        roofline_fraction=(t_bound / total) if total > 0 else 0.0,
    )


def record_from_ops(ops, memory: dict, hw: HardwareSpec) -> dict:
    """The record keys of ``analyze_step`` from a walk's ``CostOp``s and
    its ``memory`` record (``reanalyze`` rebuilds a saved cell so)."""
    parsed = analyze_ops(ops)
    flops, bytes_ = parsed["flops"], parsed["bytes"]
    coll_total = parsed["collective_bytes"]
    rec = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "collective_bytes_per_device": coll_total,
        "collectives": dict(parsed["collectives"],
                            _counts=parsed["collective_op_counts"]),
        "memory": dict(memory),
        "hbm_per_device_gib": (
            (memory.get("argument_size_in_bytes", 0)
             + memory.get("output_size_in_bytes", 0)
             + memory.get("temp_size_in_bytes", 0)
             - memory.get("alias_size_in_bytes", 0)) / 2**30
        ),
    }
    rec.update(roofline_terms(flops, bytes_, coll_total, hw))
    return rec


def _storages(tree) -> dict:
    """{id(storage): bytes} of every tensor in ``tree``, each once."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def analyze_step(fn, args=(), hw: HardwareSpec = NVIDIA_H100_SXM, *,
                 entry: str = "step") -> tuple:
    """Run ``fn(*args)`` once under a ``CostWalker`` and return (record,
    ops): the record holds the reference's ``analyze_compiled`` keys but
    the ``xla_cost_*`` pair (the module docstring), ``ops`` the walk's
    ``CostOp``s.  Memory, per device:

    * ``argument_size_in_bytes``: the storages of every tensor in
      ``args`` (the rank's params, optimizer state, cache and batch
      shards), each once, exact;
    * ``output_size_in_bytes``: the storages of every tensor ``fn``
      returns, exact; ``alias_size_in_bytes`` those among them that are
      an argument's (a cache written in place);
    * ``temp_size_in_bytes``: the walk's peak of live non-argument bytes
      less the new outputs (live at the end, counted as outputs).

    ``hbm_per_device_gib`` is arguments + outputs + temp - aliases, as
    the reference's."""
    arg = _storages(args)
    with CostWalker(entry) as walker:
        out = fn(*args)
    outs = _storages(out)
    alias = sum(nb for sid, nb in outs.items() if sid in arg)
    out_bytes = sum(outs.values())
    memory = {
        "argument_size_in_bytes": sum(arg.values()),
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": max(walker.peak - (out_bytes - alias), 0),
        "alias_size_in_bytes": alias,
    }
    return record_from_ops(walker.costs, memory, hw), walker.costs
