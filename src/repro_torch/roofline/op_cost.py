"""Per-op cost walk of one rank's program: the port's counterpart of the
reference's ``roofline/hlo_parser.py``.

The reference compiles each cell and reads its costs from the post-SPMD
HLO text: FLOPs from the dot ops, bytes at fusion granularity, the
collectives' result payloads.  Eager PyTorch has no HLO.  Its
counterpart is one rank's program run under ``CostWalker``, a
``TorchDispatchMode`` that sees every aten op (on the meta device in a
dry run: shapes only, no storage; on the card in ``chip_smoke.py``'s
``roofline`` phase), and records one ``CostOp`` per aten op, kernel
record or collective:

* FLOPs: ``op_walk.OpWalker``'s geometry, one count (2 m k n for the
  FLOP-carrying ops, a kernel's declared FLOPs, a logical region's
  logical products);
* bytes, by the eager memory model: each op reads its operands and
  writes its result once (no fusion: every op is its own kernel).  Views
  and aliases are free (``func.is_view``, ``detach``, ``alias``,
  allocations without a write); an in-place op charges its written
  operand once; an indexed read (``index``, ``gather``, ``embedding``)
  moves what it returns, read and written, and an indexed write
  (``index_put_``, ``scatter_``, ``index_copy_``) what it writes, read and
  written, as the reference charges ``gather``/``dynamic-slice`` and an
  in-place ``dynamic-update-slice``.  A kernel's bytes are the ones its
  wrapper declares (``ops.k1_bytes``, ``flash_ops.attn_bytes``,
  ``flash_ops.decode_bytes``); the aten ops inside its scope, a plain
  version's, never count.  Inside a logical region the aten ops' bytes
  count and their FLOPs do not;
* collectives: each one's per-rank result payload, under the reference's
  HLO name (``all-reduce``, ``all-gather``), from
  ``distributed/collectives.py`` (a virtual group's or a real one's);
  no HBM bytes, as the reference's parser counts none for them.

The walker also keeps the peak of live non-argument bytes: every storage
an op allocates inside the walk is live until its last tensor dies (a
weakref finalizer on the storage), and the peak is read after each op
outside a kernel scope and at each kernel scope's exit (a plain
version's transients are not the card's).  That peak is the ``temp``
estimate of ``analysis.analyze_step``.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from repro_torch.analysis.op_walk import _PACKETS, OpWalker, _geometry

aten = torch.ops.aten

# the reference's collective kinds (``hlo_parser.COLLECTIVES``)
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# ops that move no bytes: aliases, and allocations that write nothing
FREE = frozenset({
    "detach", "alias", "lift_fresh", "_unsafe_view", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "_local_scalar_dense",
})
# reads that move what they return
GATHERS = frozenset({"index", "index_select", "gather", "embedding"})
# in-place writes of some cells: (the written operand, the values' arg)
SCATTERS = {"index_put_": 2, "scatter_": 3, "scatter_add_": 3,
             "index_copy_": 3, "index_add_": 3}


@dataclasses.dataclass(frozen=True)
class CostOp:
    """One op of the walk: ``kind`` (an aten op, a kernel ``K1``/``K2``/
    ``K3``, a logical region, or a collective's HLO name), its FLOPs and
    HBM bytes, ``geometry`` ((m, k, n) for a FLOP-carrying op or a
    kernel, the result's shape for another aten op, the port's kind for a
    collective), ``payload`` (a collective's per-rank result bytes) and
    ``path`` (``decode/layer[3]/mm``)."""

    kind: str
    flops: float
    bytes: float
    geometry: tuple
    path: str
    payload: float = 0.0

    def to_json(self) -> dict:
        return {"kind": self.kind, "flops": self.flops, "bytes": self.bytes,
                "geometry": list(self.geometry), "path": self.path,
                "payload": self.payload}

    @staticmethod
    def from_json(d: dict) -> "CostOp":
        return CostOp(kind=d["kind"], flops=float(d["flops"]),
                      bytes=float(d["bytes"]), geometry=tuple(d["geometry"]),
                      path=d["path"], payload=float(d["payload"]))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of a tree of tuples, lists, dicts and dataclasses (a
    step's arguments or results, an op's), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _tensors(getattr(tree, f.name), out)
    return out


def _op_tensors(args, kwargs) -> list:
    """The tensors of an aten op's arguments: tensors, or lists of them."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


_WRITES: dict = {}


def _writes(func) -> bool:
    """Whether ``func`` writes an argument in place (cached by op)."""
    w = _WRITES.get(func)
    if w is None:
        w = _WRITES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return w


def op_bytes(func, name: str, ins: list, outs: list, args,
             kwargs) -> float:
    """The HBM bytes of one aten op under the eager memory model (the
    module docstring): ``ins``/``outs`` its tensor arguments and
    results."""
    if name in FREE or func.is_view:
        return 0.0
    if name in GATHERS:
        return 2.0 * sum(_nbytes(t) for t in outs)
    if name in SCATTERS:
        vals = args[SCATTERS[name]] if len(args) > SCATTERS[name] \
            else kwargs.get("values", kwargs.get("source", kwargs.get("src")))
        if isinstance(vals, torch.Tensor):
            return 2.0 * _nbytes(vals)
    seen, total = set(), 0
    for t in ins:
        key = (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    if _writes(func):
        # the result aliases the written operand: charged once, above
        return float(total)
    return float(total + sum(_nbytes(t) for t in outs))


class CostWalker(OpWalker):
    """Record every op run inside the ``with`` as a ``CostOp`` in
    ``costs`` (``ops`` keeps ``OpWalker``'s FLOP inventory), and the peak
    of live non-argument bytes in ``peak``; ``entry`` labels the paths'
    root."""

    def __init__(self, entry: str = "trace"):
        super().__init__(entry)
        self.costs: list = []
        self.live = 0
        self.peak = 0
        self._storages: dict = {}     # id(storage) -> bytes, while live

    # ------------------------------------------------------------- records
    def record(self, primitive, flops, m, k, n, nbytes=None) -> None:
        if self.opaque:
            return
        super().record(primitive, flops, m, k, n)
        self.costs.append(CostOp(
            kind=primitive, flops=float(flops),
            bytes=float(nbytes) if nbytes is not None else 0.0,
            geometry=(int(m), int(k), int(n)), path=self._path(primitive)))

    def collective(self, op: str, kind: str, nbytes: float) -> None:
        if self.sealed:
            return
        self.costs.append(CostOp(kind=op, flops=0.0, bytes=0.0,
                                 geometry=(kind,), path=self._path(op),
                                 payload=float(nbytes)))

    def leave_opaque(self, kind: str) -> None:
        super().leave_opaque(kind)
        if not self.sealed:
            self.peak = max(self.peak, self.live)

    # ------------------------------------------------------------ liveness
    def _free(self, sid: int) -> None:
        self.live -= self._storages.pop(sid, 0)

    def _track(self, ins, outs) -> None:
        """Count the storages ``outs`` allocated (not an input's)."""
        mine = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            sid = id(st)
            if sid in mine or sid in self._storages:
                continue
            nb = st.nbytes()
            self._storages[sid] = nb
            self.live += nb
            weakref.finalize(st, self._free, sid)
        if not self.sealed:
            self.peak = max(self.peak, self.live)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            return out         # recorded by the collectives themselves
        name = func.overloadpacket.__name__
        flop = _PACKETS.get(func.overloadpacket)
        outs = _op_tensors((out,), {})
        ins = _op_tensors(args, kwargs)
        if not self.sealed:
            flops, geom = 0.0, tuple(outs[0].shape) if outs else ()
            if flop is not None and not self.opaque:
                m, k, n = _geometry(flop, args, out)
                flops, geom = 2.0 * m * k * n, (m, k, n)
                OpWalker.record(self, flop, flops, m, k, n)
            nb = op_bytes(func, name, ins, outs, args, kwargs)
            if flops or nb:
                self.costs.append(CostOp(kind=name, flops=flops, bytes=nb,
                                         geometry=geom,
                                         path=self._path(name)))
        self._track(ins, outs)
        return out


def analyze_ops(ops) -> dict:
    """The reference's ``analyze_hlo`` keys from a walk's ``CostOp``s:
    ``flops`` and ``bytes`` (sums), ``collectives`` (payload bytes by
    HLO name), ``collective_op_counts`` and ``collective_bytes``."""
    flops = 0.0
    bytes_ = 0.0
    coll = {c: 0.0 for c in COLLECTIVE_OPS}
    counts = {c: 0.0 for c in COLLECTIVE_OPS}
    for op in ops:
        flops += op.flops
        bytes_ += op.bytes
        if op.kind in coll:
            coll[op.kind] += op.payload
            counts[op.kind] += 1
    return {"flops": flops, "bytes": bytes_, "collectives": coll,
            "collective_bytes": sum(coll.values()),
            "collective_op_counts": counts}
