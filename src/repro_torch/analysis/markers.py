"""The auditor's tagging protocol (port of ``repro.analysis.markers``):
scopes pushed on a host-side stack that the op walker (``op_walk.py``)
reads at every op it records.

The reference opens ``jax.named_scope``s, which JAX records into every
traced equation.  Eager PyTorch has no trace, so the port keeps the scope
stack itself: each scope pushes its string while the code inside it runs,
and the walker joins the stack with ``/`` into the op's ``name_stack``.

Three marker families, the first two the reference's strings:

``abft[<scheme>][<site>]``
    Opened by ``protected_matmul`` around the registered executor: every
    op the executor runs (the protected product and its check
    contractions, or the K1 record) is stamped with the resolved scheme
    and the plan-facing site tag (``attn.q``, ``mlp.down``, ...).
``flops[<kind>]``
    Coverage annotations for FLOP-carrying regions deliberately outside
    the matmul-ABFT surface: the attention softmax path (``softmax``,
    allowlisted: the fused flash-ABFT kernels replace it when
    ``flash_attention=True``), the MLA absorbed products (``mla``), the SSD
    scan (``ssm_scan``) and whisper's conv stem (``conv_stem``).
``kernel[K1|K2|K3]``
    The port's own: opened by each fused-kernel entry point
    (``kernels/ops.py``, ``kernels/flash_ops.py``), which records itself
    as ONE op with its logical shape, declared FLOPs and declared bytes
    (what the kernel reads and writes once each), on the card (a
    ``ctypes`` launch no dispatch mode sees), on the CPU (its plain
    version) and on the meta device (its outputs' allocation) alike.
    The walker drops every aten op inside the scope; ``op_walk.OpWalker``
    ignores the bytes, the roofline's ``op_cost.CostWalker`` reads them.

Two structural frames go on the same stack and into the op's ``path``:
``layer[i]`` (``enc.layer[i]`` in whisper's encoder), pushed by the
layer loop, and ``logical[<what>]``, which records the logical
contractions of a region that runs at padded shapes for bit identity
(the serving prefill's row-wise attention, MLA's 256-row absorbed
products) and drops its aten ops, as a kernel scope does.

Scopes cost nothing while no walker records: every opener tests one
module-level list and returns a shared no-op context.  Scope names may
not contain '/'.

``collective`` tells the walkers of one collective's per-rank result
payload (``distributed/collectives.py`` calls it for every collective it
runs, over a process group or a virtual one).
"""

from __future__ import annotations

import contextlib
import re
from typing import NamedTuple

_ABFT_RE = re.compile(r"abft\[([^\]]*)\]\[([^\]]*)\]")
_FLOPS_RE = re.compile(r"flops\[([^\]]*)\]")
_KERNEL_RE = re.compile(r"kernel\[([^\]]*)\]")

# kinds the audit recognizes (see audit.py for their dispositions)
COVERAGE_KINDS = ("softmax", "mla", "ssm_scan", "conv_stem")
KERNELS = ("K1", "K2", "K3")

_NULL = contextlib.nullcontext()
# the open scopes, outermost first, while a walker records
_STACK: list = []
# the walkers recording (op_walk.OpWalker), innermost last
_WALKERS: list = []


class _Scope:
    """Push ``name`` for the duration of the ``with``; ``records``, if
    any, are (primitive, flops, m, k, n, nbytes) tuples recorded as ops
    at entry (``nbytes`` None: a logical region, whose traffic is its aten
    ops'), and ``opaque`` makes every walker drop the FLOPs of the aten
    ops inside (``"kernel"``: their bytes too, a plain version's)."""

    __slots__ = ("name", "records", "opaque")

    def __init__(self, name: str, records=(), opaque: bool = False):
        self.name = name
        self.records = records
        self.opaque = opaque

    def __enter__(self):
        _STACK.append(self.name)
        for rec in self.records:
            for w in _WALKERS:
                w.record(*rec)
        if self.opaque:
            for w in _WALKERS:
                w.enter_opaque(self.opaque)
        return self

    def __exit__(self, *exc):
        if self.opaque:
            for w in _WALKERS:
                w.leave_opaque(self.opaque)
        _STACK.pop()
        return False


def protection_scope(scheme_name: str, site: str):
    """Scope marking 'ops in here belong to the <scheme> executor
    protecting plan site <site>'."""
    if not _WALKERS:
        return _NULL
    return _Scope(f"abft[{scheme_name}][{site}]")


def coverage_scope(kind: str):
    """Scope marking a known non-GEMM-ABFT FLOP region (see module doc)."""
    if kind not in COVERAGE_KINDS:
        raise ValueError(
            f"unknown coverage kind {kind!r}; known: {COVERAGE_KINDS}")
    if not _WALKERS:
        return _NULL
    return _Scope(f"flops[{kind}]")


def kernel_scope(kernel: str, m: int, k: int, n: int, flops: float,
                 nbytes: float = 0.0):
    """Scope of one fused-kernel call: records one op ``kernel`` of
    geometry (m, k, n), ``flops`` declared FLOPs and ``nbytes`` declared
    bytes, and hides the aten ops inside (a plain version's padded
    products and copies never count).  On the meta device the wrapper
    allocates the kernel's outputs inside this scope and launches
    nothing: the meta route of the dry run, not a fallback (a CUDA
    tensor takes the kernel or raises)."""
    if not _WALKERS:
        return _NULL
    return _Scope(f"kernel[{kernel}]", ((kernel, flops, m, k, n, nbytes),),
                  opaque="kernel")


def logical_scope(what: str, contractions):
    """Scope of a region that runs its products at padded or blocked
    shapes: records ``contractions``, (m, k, n) triples of its logical
    products (2 * m * k * n FLOPs each), as ops ``what``, and hides the
    aten ops inside."""
    if not _WALKERS:
        return _NULL
    return _Scope(f"logical[{what}]",
                  tuple((what, 2.0 * m * k * n, m, k, n, None)
                        for m, k, n in contractions), opaque="logical")


def layer_scope(prefix: str, idx: int):
    """Frame of layer ``idx`` of a stack (``prefix``: the stack's site
    prefix, ``"enc."`` in whisper's encoder)."""
    if not _WALKERS:
        return _NULL
    return _Scope(f"{prefix}layer[{idx}]")


def name_stack() -> str:
    return "/".join(_STACK)


def collective(op: str, kind: str, nbytes: float) -> None:
    """Tell every walker of one collective: ``op`` its kind in the
    reference's HLO names (``all-reduce``, ``all-gather``), ``kind`` the
    port's (``collectives.KINDS``), ``nbytes`` its per-rank result
    payload."""
    for w in _WALKERS:
        w.collective(op, kind, nbytes)


class Marker(NamedTuple):
    """Parsed marker state of one op's name stack."""

    scheme: str | None          # abft[...] scheme, if inside one
    site: str | None            # abft[...] site tag, if inside one
    kinds: tuple                # flops[...] kinds, outermost first
    kernel: str | None = None   # kernel[...], the innermost, if any

    @property
    def protected(self) -> bool:
        return self.scheme is not None


def parse_name_stack(name_stack: str) -> Marker:
    """Read the marker state back out of an op's name-stack string.

    Innermost ``abft`` marker wins (nested protected calls would be a
    bug, but the innermost is the one actually executing the op); all
    ``flops`` kinds are collected since regions nest (an SSD scan inside
    a softmax-annotated caller must classify as ``ssm_scan``)."""
    abft = _ABFT_RE.findall(name_stack)
    kinds = tuple(_FLOPS_RE.findall(name_stack))
    kernels = _KERNEL_RE.findall(name_stack)
    kernel = kernels[-1] if kernels else None
    if abft:
        scheme, site = abft[-1]
        return Marker(scheme=scheme, site=site, kinds=kinds, kernel=kernel)
    return Marker(scheme=None, site=None, kinds=kinds, kernel=kernel)
