"""Op walker: inventory every FLOP-carrying op an entry point runs (the
port's counterpart of ``repro.analysis.jaxpr_walk``).

The reference traces an entry point to a ClosedJaxpr and walks its
equations.  Eager PyTorch has no trace to walk, so ``OpWalker`` is a
``TorchDispatchMode`` that sees every aten op as it runs and records one
``TracedOp`` per FLOP-carrying op: ``mm``, ``addmm``, ``bmm``,
``baddbmm``, ``mv``, ``dot`` and ``convolution`` (``F.linear``,
``matmul`` and ``einsum`` decompose to these before dispatch), with

* exact FLOPs from the operand shapes, in the reference's geometry:
  2 * m * k * n with a batch folded into m; a convolution's m is batch x
  out positions, k in-channels-per-group x kernel, n out channels;
* the marker stack (``markers.py``) joined by ``/`` as its
  ``name_stack``, which the audit classifies;
* a path of the entry and the layer (``decode/layer[3]/mm``).

The port has no scan: its layer loop runs in Python, so every layer's
ops appear once and ``repeats`` stays 1.  A fused kernel (K1, K2, K3) is
a ``ctypes`` launch on the card that no dispatch mode sees; each kernel
entry point therefore records itself (``markers.kernel_scope``) as one
op with its declared FLOPs, on both devices, and the walker drops the
aten ops inside that scope, so a plain version's padded products never
count.  ``markers.logical_scope`` does the same for regions that run
padded for bit identity.  The walker only observes: every op runs as it
would without it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import markers

aten = torch.ops.aten
FLOP_OPS = ("mm", "addmm", "bmm", "baddbmm", "mv", "dot", "convolution")
_PACKETS = {getattr(aten, name): name for name in FLOP_OPS}


@dataclasses.dataclass(frozen=True)
class TracedOp:
    """One FLOP-carrying op found by the walk."""

    primitive: str
    flops: float               # repeats included
    m: int                     # lhs free size (batch folded in)
    k: int                     # contraction size
    n: int                     # rhs free size / out channels
    name_stack: str
    path: str
    repeats: int = 1           # always 1: no scan in eager PyTorch


def _geometry(name: str, args, out):
    """(m, k, n) of a FLOP-carrying aten op from its operand shapes."""
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "convolution":
        n = int(b.shape[0])
        k = math.prod(b.shape[1:])
        return out.numel() // max(n, 1), k, n
    if name == "dot":
        return 1, int(a.shape[0]), 1
    if name == "mv":
        return int(a.shape[0]), int(a.shape[1]), 1
    if name in ("bmm", "baddbmm"):
        return (int(a.shape[0]) * int(a.shape[1]), int(a.shape[2]),
                int(b.shape[2]))
    return int(a.shape[0]), int(a.shape[1]), int(b.shape[1])


class OpWalker(TorchDispatchMode):
    """Record the FLOP-carrying ops run inside the ``with`` as
    ``TracedOp``s in ``ops``; ``entry`` labels their paths' root."""

    def __init__(self, entry: str = "trace"):
        super().__init__()
        self.entry = entry
        self.ops: list = []
        self.opaque = 0            # depth of kernel/logical scopes

    def __enter__(self):
        markers._WALKERS.append(self)
        try:
            return super().__enter__()
        except BaseException:
            markers._WALKERS.remove(self)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            markers._WALKERS.remove(self)

    def _path(self, primitive: str) -> str:
        frames = [s for s in markers._STACK if "layer[" in s]
        return "/".join([self.entry, *frames, primitive])

    def record(self, primitive: str, flops: float, m: int, k: int,
               n: int) -> None:
        """Add one op of declared FLOPs at the current marker stack (a
        kernel's or a logical region's record); nothing inside an
        opaque scope, which declared its own."""
        if self.opaque:
            return
        self.ops.append(TracedOp(
            primitive=primitive, flops=float(flops), m=int(m), k=int(k),
            n=int(n), name_stack=markers.name_stack(),
            path=self._path(primitive)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _PACKETS.get(func.overloadpacket)
        if name is not None and not self.opaque:
            m, k, n = _geometry(name, args, out)
            self.record(name, 2.0 * m * k * n, m, k, n)
        return out


def flop_ops(fn, entry: str = "trace") -> list:
    """Run ``fn()`` under an ``OpWalker`` and return its ``TracedOp``
    inventory.  ``entry`` labels the path root."""
    with OpWalker(entry) as walker:
        fn()
    return walker.ops
