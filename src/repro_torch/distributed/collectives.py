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
wide.

Training differentiates through them (``torch.autograd.Function``s,
taken only where the input requires a gradient).  The two axes hold the
loss differently: every model rank computes the same loss, while the
step's loss is the sum of the data ranks' losses over their own rows.
So over ``model``, ``all_reduce_sum``'s backward is the identity and a
gather's takes this rank's slice; over ``data``, ``all_reduce_sum``'s
backward sums the gradient over the axis and ``fsdp_gather``'s sums it
and then takes the slice.  ``copy_to_model`` is the identity forward
whose backward sums over ``model``: a column-parallel GEMM's replicated
input gets each rank's partial gradient, and the sum makes it whole.
One rule covers every replicated value: ``all_reduce_sum``'s identity
backward is right only where what reads the sum is the same on every
model rank, so a replicated value that only the rank's own heads or
channels read (Mamba2's B and C, MLA's latent, the gated norm's sum of
squares, a column-parallel GEMM's input) passes ``copy_to_model`` first,
and every leaf upstream of it gets the whole gradient, equal on every
model rank.
The train step's own collectives: ``sum_grads`` (the data-axis gradient
all-reduce, f32, in buckets of ``BUCKET_BYTES``), ``gather_zero`` (the
ZeRO-1 all-gather of updated param slices over ``data``, bucketed the
same way), ``data_stats`` (the loss's sums over ``data``) and
``world_reduce`` (the optimizer's global norm and int8 amax over every
rank).

``COUNTS["calls"]`` counts the collectives since ``reset_counts`` (the
identity calls excepted), ``COUNTS[kind]`` each kind apart: ``model_sum``,
``model_gather``, ``data_gather``, ``fsdp_gather``, ``lse_combine`` and
``flag`` forward; ``data_sum`` (a data-axis ``all_reduce_sum`` and
``data_stats``), ``model_grad`` (``copy_to_model``'s backward),
``fsdp_grad`` and ``data_grad`` (the data axis's backward sums),
``grad_sum``, ``zero_gather`` and ``world`` (``world_reduce``) in
training; ``checkpoint`` (``gather_to_root``, a sharded save's).

The backends: gloo takes CUDA tensors for all of these on the card's
torch (2.11: ``all_gather`` and ``all_reduce`` of CUDA tensors checked on
the H100 over two ranks), copying through the host; NCCL where each rank
has a GPU of its own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math

import torch

F32 = torch.float32

KINDS = ("model_sum", "model_gather", "data_gather", "fsdp_gather",
         "lse_combine", "flag", "data_sum", "model_grad", "fsdp_grad",
         "data_grad", "grad_sum", "zero_gather", "world", "checkpoint")
# a bucket of the train step's gradient all-reduce and ZeRO-1 gather:
# large enough that gloo's per-call host cost (1.2-4.3 ms on the H100's
# host) is small beside the bytes, small enough to bound the copy
BUCKET_BYTES = 64 << 20
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


def grid_group(mesh) -> TPGroup | None:
    """Every rank of ``mesh``'s grid as one group (``world_group`` where
    the grid is the whole world; None for a grid of one): the training
    step's flag OR, global norm and checkpoint gathers span it."""
    n = int(mesh.grid.size)
    if n == 1:
        return None
    if mesh.grid_group is None:
        return world_group()
    import torch.distributed as dist

    return TPGroup(rank=int(mesh.rank), size=n, group=mesh.grid_group,
                   backend=dist.get_backend(mesh.grid_group), axis="world")


def _active(tp) -> bool:
    return tp is not None and tp.size > 1


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum(x, g, kind: str):
    """``x`` summed over ``g`` in place of a contiguous copy's storage
    (``x`` itself where it is contiguous)."""
    import torch.distributed as dist

    x = x.contiguous()
    _count(kind)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g.group)
    return x


class _SumOver(torch.autograd.Function):
    """``all_reduce_sum`` under autograd (the module docstring: the
    identity backward over ``model``, the sum over ``data``)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _sum(x.clone(), g, "model_sum" if g.axis == "model"
                    else "data_sum")

    @staticmethod
    def backward(ctx, dy):
        if ctx.g.axis == "model":
            return dy, None
        return _sum(dy.clone(), ctx.g, "data_grad"), None


def all_reduce_sum(x, tp):
    """The sum of ``x`` over the axis of ``tp`` (f32 in, f32 out, every
    rank the same sum): the model axis's partials, or (``tp.axis ==
    "data"``) a training loss term's sums over the data ranks."""
    if not _active(tp):
        return x
    if x.dtype != F32:
        raise TypeError(f"all_reduce_sum takes f32 partials, got {x.dtype}")
    if _needs_grad(x):
        return _SumOver.apply(x, tp)
    return _sum(x, tp, "model_sum" if tp.axis == "model" else "data_sum")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy.to(F32, copy=True), ctx.tp,
                    "model_grad").to(dy.dtype), None


def copy_to_model(x, tp):
    """``x`` as it is (a replicated activation entering a column-parallel
    GEMM or an expert-parallel dispatch); under autograd its gradient is
    summed over the model axis in f32, so every rank holds the whole
    gradient of a replicated tensor."""
    if not _active(tp) or not _needs_grad(x):
        return x
    return _CopyToModel.apply(x, tp)


def _gather(x, g, dim: int, kind: str):
    import torch.distributed as dist

    x = x.contiguous()
    _count(kind)
    parts = [torch.empty_like(x) for _ in range(g.size)]
    dist.all_gather(parts, x, group=g.group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    """A gather under autograd: the backward takes this rank's slice of
    the gradient, over ``data`` after summing it over the axis."""

    @staticmethod
    def forward(ctx, x, g, dim, kind):
        ctx.g, ctx.dim, ctx.n = g, dim, x.shape[dim]
        return _gather(x, g, dim, kind)

    @staticmethod
    def backward(ctx, dy):
        g = ctx.g
        if g.axis != "model":
            dy = _sum(dy.to(F32, copy=True), g, "fsdp_grad").to(dy.dtype)
        return dy.narrow(ctx.dim, g.rank * ctx.n, ctx.n), None, None, None


def _gather_any(x, g, dim: int, kind: str):
    if _needs_grad(x):
        return _Gather.apply(x, g, dim % x.dim(), kind)
    return _gather(x, g, dim, kind)


def gather_last(x, tp):
    """The last dim of ``x``, split evenly in rank order over the model
    axis, made whole on every rank."""
    if not _active(tp):
        return x
    return _gather_any(x, tp, -1, "model_gather")


def gather_first(x, dp):
    """The leading dim of ``x``, split evenly in rank order over the data
    axis (data rank r holds rows [r n, (r + 1) n)), made whole on every
    rank."""
    if not _active(dp):
        return x
    return _gather_any(x, dp, 0, "data_gather")


def fsdp_gather(x, dp, dim: int, kind: str = "fsdp_gather"):
    """Dim ``dim`` of ``x``, split evenly in rank order over the data
    axis, made whole on every rank: an FSDP leaf before its GEMM, or
    (``kind="data_gather"``) the positions of a sequence-sharded cache
    (dim 1)."""
    if not _active(dp):
        return x
    return _gather_any(x, dp, dim, kind)


# ---------------------------------------------------------- the train step

def _buckets(tensors) -> list:
    """Runs of consecutive indices of ``tensors``, each of at most
    ``BUCKET_BYTES`` of f32 (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = t.numel() * 4
        if cur and size + n > BUCKET_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return out + ([cur] if cur else [])


@torch.no_grad()
def sum_grads(grads: list, dp) -> list:
    """Each tensor of ``grads`` summed over the data axis in f32 (cast
    back to its dtype), bucketed: one all-reduce a bucket."""
    if not _active(dp):
        return grads
    import torch.distributed as dist

    out = list(grads)
    for idx in _buckets(grads):
        flat = torch.cat([grads[i].reshape(-1).to(F32) for i in idx])
        _count("grad_sum")
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=dp.group)
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view(grads[i].shape).to(
                grads[i].dtype)
            off += n
    return out


@torch.no_grad()
def gather_zero(parts: list, dims: list, dp) -> list:
    """ZeRO-1's all-gather: ``parts[i]`` this data rank's slice of a
    leaf along dim ``dims[i]`` (rank r's the r-th of ``dp.size`` equal
    slices), every leaf made whole on every data rank, bucketed: one
    all-gather a bucket of one dtype.  Each entry of ``parts`` is
    released (set to None) once its bucket is packed, so a caller that
    keeps no other reference frees the slices as the whole leaves
    arrive."""
    if not _active(dp):
        return parts
    import torch.distributed as dist

    out = [None] * len(parts)
    groups: dict = {}
    for i, p in enumerate(parts):
        groups.setdefault(p.dtype, []).append(i)
    for ids in groups.values():
        for run in _buckets([parts[i] for i in ids]):
            idx = [ids[j] for j in run]
            flat = torch.cat([parts[i].reshape(-1) for i in idx])
            shapes = [parts[i].shape for i in idx]
            for i in idx:
                parts[i] = None
            bufs = [torch.empty_like(flat) for _ in range(dp.size)]
            _count("zero_gather")
            dist.all_gather(bufs, flat, group=dp.group)
            del flat
            off = 0
            for i, shape in zip(idx, shapes):
                n = math.prod(shape)
                out[i] = torch.cat([b[off:off + n].view(shape)
                                    for b in bufs], dim=dims[i])
                off += n
            del bufs
    return out


@torch.no_grad()
def data_stats(x, dp):
    """A small f32 tensor of loss sums summed over the data axis (no
    gradient)."""
    if not _active(dp):
        return x
    return _sum(x.detach().to(F32).clone(), dp, "data_sum")


@torch.no_grad()
def gather_to_root(t, world) -> list | None:
    """Every rank's ``t`` (one shape on every rank) on the group's first
    rank, in rank order, and None on the others: through the host under
    gloo, on the device under NCCL."""
    import torch.distributed as dist

    if world.backend != "nccl":
        t = t.cpu()
    root = 0
    mine = dist.get_rank() == root
    parts = [torch.empty_like(t) for _ in range(world.size)] if mine \
        else None
    _count("checkpoint")
    dist.gather(t, parts, dst=root, group=world.group)
    return parts


@torch.no_grad()
def world_reduce(x, world, op: str = "sum"):
    """A small f32 tensor reduced (``"sum"`` or ``"max"``) over every
    rank of ``world``."""
    if not _active(world):
        return x
    import torch.distributed as dist

    x = x.detach().to(F32).clone()
    _count("world")
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=world.group)
    return x


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
