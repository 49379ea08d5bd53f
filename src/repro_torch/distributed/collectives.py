"""The collectives of tensor-parallel serving.  The reference has no such
module: GSPMD inserts its collectives from the committed layouts.  The
port places data explicitly, so each layer calls one of these where the
reference's compiled program would reduce or gather:

- ``all_reduce_sum``: the f32 partials of a row-parallel GEMM (``wo``,
  ``down``, ``out_proj``, a sliced expert FFN's ``w_down``), an
  expert-parallel MoE combine, the masked embedding lookups and a Mamba2
  gated norm's sums of squares;
- ``gather_last``: a dim sharded over the model axis made whole (the
  vocab-sharded logits; k/v projections whose kv head is split);
- ``or_flag``: the ABFT flag of a model call, so every rank takes the
  same detect->retry decision;
- ``check_same``: every rank holds the same small host record (tests and
  ``chip_smoke.py``; never on the step).

Each takes the layer context's ``TPGroup`` and is the identity when it is
None or one wide.  ``COUNTS["calls"]`` counts the collectives since
``reset_counts`` (the identity calls excepted).

The backends: gloo takes CUDA tensors for all of these on the card's
torch (2.11: ``all_gather`` and ``all_reduce`` of CUDA tensors checked on
the H100 over two ranks), copying through the host; NCCL where each rank
has a GPU of its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import torch

F32 = torch.float32

COUNTS = {"calls": 0}


def reset_counts() -> None:
    COUNTS["calls"] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """This rank's place on the model axis: its index ``rank`` of
    ``size``, the process ``group`` (None: the default group), the
    backend, and ``sharded``, the param leaves the sharding rules split
    over the axis, each by its path below its layer's dict
    (``"mixer/wq"``, ``"ffn/shared/up"``) or, outside the layers, by its
    top-level name (``"embed"``, ``"lm_head"``).  A replicated leaf is
    computed whole."""

    rank: int
    size: int
    group: object = None
    backend: str = "gloo"
    sharded: frozenset = frozenset()

    def splits(self, path: str) -> bool:
        return self.size > 1 and path in self.sharded


def _active(tp) -> bool:
    return tp is not None and tp.size > 1


def all_reduce_sum(x, tp):
    """The sum of ``x`` over the model axis (f32 in, f32 out, every rank
    the same sum)."""
    if not _active(tp):
        return x
    import torch.distributed as dist

    if x.dtype != F32:
        raise TypeError(f"all_reduce_sum takes f32 partials, got {x.dtype}")
    x = x.contiguous()
    COUNTS["calls"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=tp.group)
    return x


def gather_last(x, tp):
    """The last dim of ``x``, split evenly in rank order over the model
    axis, made whole on every rank."""
    if not _active(tp):
        return x
    import torch.distributed as dist

    x = x.contiguous()
    COUNTS["calls"] += 1
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=-1)


def or_flag(flag, tp):
    """A 0-d bool: whether any rank's ``flag`` is set."""
    if not _active(tp):
        return flag
    import torch.distributed as dist

    t = flag.reshape(1).to(torch.int32)
    COUNTS["calls"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=tp.group)
    return t[0].bool()


def check_same(record, tp, what: str = "record") -> None:
    """Raise ``RuntimeError`` unless every rank of the model axis holds
    the same JSON-serializable ``record``."""
    if not _active(tp):
        return
    import torch.distributed as dist

    digest = hashlib.sha256(json.dumps(record, sort_keys=True,
                                       default=str).encode()).hexdigest()
    digests = [None] * tp.size
    dist.all_gather_object(digests, digest, group=tp.group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"ranks disagree on {what}: digests {digests}")
