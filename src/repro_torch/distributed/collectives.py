"""The collectives of sharded serving.  The reference has no such
module: GSPMD inserts its collectives from the committed layouts.  The
port places data explicitly, so each layer calls one of these where the
reference's compiled program would reduce or gather.  Over the model
axis:

- ``all_reduce_sum``: the f32 partials of a row-parallel GEMM (``wo``,
  ``down``, ``out_proj``, a sliced expert FFN's ``w_down``), an
  expert-parallel MoE combine, the masked embedding lookups and a Mamba2
  gated norm's sums of squares;
- ``gather_last``: a dim sharded over the model axis made whole (the
  vocab-sharded logits; k/v projections whose kv head is split).

Over the data axis:

- ``gather_first``: rows split over the data ranks made whole in rank
  order (a split decode's or verify's logits; a slot-sharded cache's
  rows that a whole-batch call reads);
- ``fsdp_gather``: a weight sharded over ``data`` (FSDP) made whole along
  the dim its spec puts on the axis, just before its GEMM (or a
  sequence-sharded cache's positions, along dim 1);
- ``lse_combine``: partial attention outputs over a sequence-sharded
  cache merged by their log-sum-exps, in f32.

Over the whole world (``world_group``):

- ``or_flag``: the ABFT flag of a model call, so every rank takes the
  same detect->retry decision;
- ``check_same``: every rank holds the same small host record (tests and
  ``chip_smoke.py``; never on the step).

Each takes a ``TPGroup`` (the layer context's ``tp`` for the model axis,
``dp`` for the data axis) and is the identity when it is None or one
wide.  ``COUNTS["calls"]`` counts the collectives since ``reset_counts``
(the identity calls excepted), ``COUNTS[kind]`` each kind apart:
``model_sum``, ``model_gather``, ``data_gather``, ``fsdp_gather``,
``lse_combine`` and ``flag``.

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

KINDS = ("model_sum", "model_gather", "data_gather", "fsdp_gather",
         "lse_combine", "flag")
COUNTS = {"calls": 0, **{k: 0 for k in KINDS}}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _count(kind: str) -> None:
    COUNTS["calls"] += 1
    COUNTS[kind] += 1


@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """This rank's place on one mesh axis (``axis``: ``"model"``,
    ``"data"``, or ``"world"`` for every rank at once): its index
    ``rank`` of ``size``, the process ``group`` (None: the default
    group), the backend, and ``sharded``, the param leaves the sharding
    rules split over the axis, each by its path below its layer's dict
    (``"mixer/wq"``, ``"ffn/shared/up"``) or, outside the layers, by its
    top-level name (``"embed"``, ``"lm_head"``).  A replicated leaf is
    computed whole.  ``dims`` (the data axis): the dim each such leaf is
    split on (FSDP), which ``fsdp_gather`` makes whole.

    One type serves both axes, since a collective reads only the group,
    the rank and the size: the same ``all_reduce_sum`` or gather is the
    identity at width 1 on either axis, and a layer tells the axes apart
    by the context field that holds the group (``LayerCtx.tp``,
    ``LayerCtx.dp``)."""

    rank: int
    size: int
    group: object = None
    backend: str = "gloo"
    sharded: frozenset = frozenset()
    axis: str = "model"
    dims: dict = dataclasses.field(default_factory=dict)

    def splits(self, path: str) -> bool:
        return self.size > 1 and path in self.sharded


def world_group() -> TPGroup | None:
    """Every rank of this process's world as one group (None outside
    ``torch.distributed`` or in a world of one): the flag's OR and the
    records' check span the whole mesh."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return None
    return TPGroup(rank=dist.get_rank(), size=dist.get_world_size(),
                   backend=dist.get_backend(), axis="world")


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
    _count("model_sum")
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=tp.group)
    return x


def gather_last(x, tp):
    """The last dim of ``x``, split evenly in rank order over the model
    axis, made whole on every rank."""
    if not _active(tp):
        return x
    return _gather(x, tp, -1, "model_gather")


def _gather(x, g, dim: int, kind: str):
    import torch.distributed as dist

    x = x.contiguous()
    _count(kind)
    parts = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(parts, x, group=g.group)
    return torch.cat(parts, dim=dim)


def gather_first(x, dp):
    """The leading dim of ``x``, split evenly in rank order over the data
    axis (data rank r holds rows [r n, (r + 1) n)), made whole on every
    rank."""
    if not _active(dp):
        return x
    return _gather(x, dp, 0, "data_gather")


def fsdp_gather(x, dp, dim: int, kind: str = "fsdp_gather"):
    """Dim ``dim`` of ``x``, split evenly in rank order over the data
    axis, made whole on every rank: an FSDP leaf before its GEMM, or
    (``kind="data_gather"``) the positions of a sequence-sharded cache
    (dim 1)."""
    if not _active(dp):
        return x
    return _gather(x, dp, dim, kind)


def lse_combine(out, lse, dp):
    """Merge the data ranks' partial attention outputs: ``out`` (...,
    Dv), each rank's softmax-normalized output over its own keys, and
    ``lse`` (...), the log-sum-exp of its scaled scores (-inf where it
    holds no key of the row), into the output over every rank's keys, in
    f32: o = sum_r exp(lse_r - m) o_r / sum_r exp(lse_r - m) with m the
    rows' largest lse.  A rank without keys weighs exactly 0; a row no
    rank holds a key of is 0, never NaN.  Every rank merges the gathered
    partials in rank order, so all get the same bits."""
    o = out.to(F32)
    if not _active(dp):
        return o
    import torch.distributed as dist

    _count("lse_combine")
    packed = torch.cat([o, lse.to(F32)[..., None]], dim=-1).contiguous()
    parts = [torch.empty_like(packed) for _ in range(dp.size)]
    dist.all_gather(parts, packed, group=dp.group)
    allp = torch.stack(parts)
    return merge_partials(allp[..., :-1], allp[..., -1])


def merge_partials(outs, lses):
    """``lse_combine``'s merge of stacked partials ``outs`` (R, ..., Dv)
    and ``lses`` (R, ...), f32, in index order."""
    m = lses.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)
    den = w.sum(0)
    num = (w[..., None] * outs).sum(0)
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None],
                       torch.zeros_like(num))


def or_flag(flag, tp):
    """A 0-d bool: whether any rank of ``tp`` (the world group, on the
    serving path) has ``flag`` set."""
    if not _active(tp):
        return flag
    import torch.distributed as dist

    t = flag.reshape(1).to(torch.int32)
    _count("flag")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=tp.group)
    return t[0].bool()


def check_same(record, tp, what: str = "record") -> None:
    """Raise ``RuntimeError`` unless every rank of ``tp`` (an axis, or
    the world group) holds the same JSON-serializable ``record``."""
    if not _active(tp):
        return
    import torch.distributed as dist

    digest = hashlib.sha256(json.dumps(record, sort_keys=True,
                                       default=str).encode()).hexdigest()
    digests = [None] * tp.size
    dist.all_gather_object(digests, digest, group=tp.group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"ranks disagree on {what}: digests {digests}")
