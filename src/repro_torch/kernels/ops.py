"""Wrapper around the fused ABFT matmul (port of ``repro.kernels.ops``).

Clamps the logical blocks for thin GEMMs (aligned to 8), translates the
fault's output coordinates to (block, offset) pairs and turns the
per-block residual/bound into a threshold and a NaN-safe flag.  A CUDA
operand launches K1 (``kernels/abft_matmul.py``) or raises; CPU operands
take its plain version (``kernels/ref.py``).  Nothing is padded here: the
kernel masks ragged edges itself.

``abft_matmul_batched`` is the same over an expert axis, x (E, C, k) @ w
(E, k, n) in one launch: the reference's ``jax.vmap`` of ``abft_matmul``
over an MoE layer's experts (``repro/models/moe.py``), blocks clamped and
thresholded per expert, the fault (not a vmapped argument there) in
every expert.

Both are differentiable (``_AbftMatmul``): the backward is the
reference's XLA backward of its emulation (``repro/core/protected.py``),
``dX = dY W^T`` and ``dW = X^T dY`` as plain ``torch.matmul`` products,
unprotected — the reference declares ``protect_backward`` and never reads
it, and no TPU kernel has a backward kernel.

The threshold mirrors the reference kernel path
(``repro/kernels/ops.py``): ``ATOL + tolerance_scale(K) * bnd``, without
the output- and weight-quantization terms that the reference's
``use_pallas=False`` emulation adds (``repro/core/protected.py``).
"""

from __future__ import annotations

import torch

from repro_torch.analysis import markers
from repro_torch.core.checksums import ATOL, CheckResult, flag_from, tolerance_scale
from repro_torch.core.faults import FaultSpec
from repro_torch.core.schemes import BlockShape
from repro_torch.kernels.abft_matmul import abft_matmul_kernel, route
from repro_torch.kernels.ref import abft_matmul_batched_ref, abft_matmul_ref


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _clamp_block(dim: int, block: int, align: int = 8) -> int:
    return min(block, _round_up(dim, align))


def k1_flops(m: int, k: int, n: int) -> float:
    """The FLOPs a K1 call records in the coverage audit
    (``analysis/op_walk.py``): the product, 2 m k n, and the check's two
    contractions against the weight's row sums, 2 m k each, as the
    reference's ``use_pallas=False`` emulation counts them for every block
    mode (``repro/core/protected.py``).  An expert batch folds into m."""
    return 2.0 * m * k * n + 4.0 * m * k


class _AbftMatmul(torch.autograd.Function):
    """K1 (CUDA operands) or its plain version (CPU operands) with the
    reference's backward, for x2 (M, K) @ w (K, N) or, batched over
    experts, x2 (E, M, K) @ w (E, K, N).  Residual and bound carry no
    gradient."""

    @staticmethod
    def forward(ctx, x2, w, fidx, delta, mode, bm, bk, bn, out_dtype,
                one_slice, split_rows):
        kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
        if x2.is_cuda or w.is_cuda:
            y, res, bnd = abft_matmul_kernel(x2, w, fidx, delta, **kw,
                                             one_slice=one_slice,
                                             split_rows=split_rows)
        elif x2.dim() == 3:
            y, res, bnd = abft_matmul_batched_ref(x2, w, fidx, delta, **kw)
        else:
            y, res, bnd = abft_matmul_ref(x2, w, fidx, delta, **kw)
        ctx.mark_non_differentiable(res, bnd)
        ctx.save_for_backward(x2, w)
        return y, res, bnd

    @staticmethod
    def backward(ctx, gy, _gres, _gbnd):
        x2, w = ctx.saved_tensors
        gx = gw = None
        g = gy.to(w.dtype)
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, w.transpose(-1, -2))
        if ctx.needs_input_grad[1] and w.dim() == 3:
            gw = torch.matmul(x2.transpose(-1, -2), g)
        elif ctx.needs_input_grad[1]:
            # dW in W's own layout: for the tied head (W = embed.T, a
            # transposed view) the product is formed as (dY^T X)^T, so the
            # view's backward hands ``embed`` a contiguous gradient
            gw = (torch.matmul(g.t(), x2).t() if w.stride(0) == 1
                  and w.stride(1) != 1 else torch.matmul(x2.t(), g))
        return gx, gw, None, None, None, None, None, None, None, None, None


def abft_matmul(x, w, *, mode: str = "1s", blocks: BlockShape = BlockShape(),
                out_dtype=None, fault: FaultSpec | None = None,
                c_factor: float = 16.0, one_slice: bool = False,
                decode_rows: int | None = None):
    """``y = x @ w`` plus the fused integrity check.  x: (..., m, k), w:
    (k, n).  Returns (y, CheckResult); the residual is per (block, row)
    for '1s'/'replica', per block for '2s'.  ``one_slice``: K1 runs pass
    1 as one K slice at any M (``abft_matmul.split_k``); the plain
    version has no split.

    ``decode_rows`` (a speculative verify step, x of shape (B, T, k) with
    B == ``decode_rows``): K1 sums every row in the order of the decode
    step's GEMM of B rows.  Where the B * T rows take the decode shape's
    route (bf16 on the tensor cores; f32 SIMT above 8 slots) one launch
    takes them all with the decode shape's K split
    (``abft_matmul.plan(split_rows=)``); where they cannot (the f32 GEMV,
    or the CUDA-core tiles of the f32 tied head, at B <= 8) each step t
    runs as its own launch at exactly the decode shape.  The plain
    version ignores it."""
    out_dtype = out_dtype or x.dtype
    *lead, m0, k0 = x.shape
    kw, n0 = w.shape
    if k0 != kw:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    f = fault if fault is not None else FaultSpec.none()
    x2 = x.reshape(-1, k0)
    split_rows = None
    if decode_rows is not None and x.is_cuda and x.dim() == 3 \
            and x.shape[0] == decode_rows and m0 > 1:
        bn = _clamp_block(n0, blocks.bn)
        if route(x[:, 0], w, bn, mode) != route(x2, w, bn, mode):
            return _per_step(x, w, mode, blocks, out_dtype, f, c_factor)
        split_rows = int(decode_rows)
    m = x2.shape[0]
    bm = _clamp_block(m, blocks.bm)
    bk = _clamp_block(k0, blocks.bk)
    bn = _clamp_block(n0, blocks.bn)
    fidx = (f.row // bm, f.col // bn, f.row % bm, f.col % bn,
            int(f.enabled), f.bit)
    with markers.kernel_scope("K1", m, k0, n0, k1_flops(m, k0, n0)):
        y, res, bnd = _AbftMatmul.apply(x2, w, fidx, f.delta, mode, bm, bk,
                                        bn, out_dtype, one_slice, split_rows)
    # the reference takes the depth of its zero-padded operand (a multiple
    # of bk) for the threshold; kept so both packages flag alike
    tau = ATOL + tolerance_scale(_round_up(k0, bk), c=c_factor) * bnd
    return (y.reshape(*lead, m0, n0),
            CheckResult(flag=flag_from(res, tau), residual=res,
                        threshold=tau))


def abft_matmul_batched(x, w, *, mode: str = "1s",
                        blocks: BlockShape = BlockShape(), out_dtype=None,
                        fault: FaultSpec | None = None,
                        c_factor: float = 16.0, one_slice: bool = False,
                        split_rows: int | None = None):
    """``y[e] = x[e] @ w[e]`` for every expert e, plus the fused check, in
    one K1 launch (CUDA operands) or through the batched plain version
    (CPU operands).  x: (E, m, k) with unit column stride, w: (E, k, n).
    Blocks are clamped to one expert's GEMM (m, k, n), as under the
    reference's vmap; the residual is per (expert, block, row) for
    '1s'/'replica', per (expert, block) for '2s'; the flag is any
    expert's.  The fault's (row, col) lands in every expert.
    ``split_rows`` (a speculative verify step: the decode step's expert
    capacity): K1 sums every row in the order of an expert GEMM of that
    many rows, where both take one route (``abft_matmul.plan``); the
    plain version ignores it."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"batched shapes mismatch {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    _, m0, k0 = x.shape
    n0 = w.shape[2]
    f = fault if fault is not None else FaultSpec.none()
    bm = _clamp_block(m0, blocks.bm)
    bk = _clamp_block(k0, blocks.bk)
    bn = _clamp_block(n0, blocks.bn)
    fidx = (f.row // bm, f.col // bn, f.row % bm, f.col % bn,
            int(f.enabled), f.bit)
    if split_rows is not None and (
            not x.is_cuda or split_rows >= m0
            or route(x[0, :split_rows], w[0], bn, mode)
            != route(x[0], w[0], bn, mode)):
        split_rows = None
    E = x.shape[0]
    with markers.kernel_scope("K1", E * m0, k0, n0,
                              k1_flops(E * m0, k0, n0)):
        y, res, bnd = _AbftMatmul.apply(x, w, fidx, f.delta, mode, bm, bk,
                                        bn, out_dtype, one_slice, split_rows)
    tau = ATOL + tolerance_scale(_round_up(k0, bk), c=c_factor) * bnd
    return y, CheckResult(flag=flag_from(res, tau), residual=res,
                          threshold=tau)


def _per_step(x, w, mode, blocks, out_dtype, f, c_factor):
    """``abft_matmul`` of x (B, T, k) as T launches of the rows x[:, t]
    (each the decode step's GEMM); the fault's row ``b * T + t`` lands on
    row b of launch t.  Residuals and thresholds are stacked by step."""
    B, T, _ = x.shape
    ys, checks = [], []
    for t in range(T):
        ft = f
        if f.enabled:
            ft = (f._replace(row=f.row // T) if f.row % T == t
                  else FaultSpec.none())
        y, chk = abft_matmul(x[:, t].contiguous(), w, mode=mode,
                             blocks=blocks, out_dtype=out_dtype, fault=ft,
                             c_factor=c_factor)
        ys.append(y)
        checks.append(chk)
    return (torch.stack(ys, dim=1),
            CheckResult(flag=torch.stack([c.flag for c in checks]).any(),
                        residual=torch.cat([c.residual for c in checks]),
                        threshold=torch.cat([c.threshold for c in checks])))
