"""ABFT scheme definitions and their analytic overhead models.

Copied from ``repro.core.schemes`` as it is: the cost model below was
derived for the TPU (MXU/VPU co-issue); re-deriving it for Hopper
(tensor cores / CUDA cores) is later work.

Schemes (paper §2.4–§5.2, adapted to TPU per DESIGN.md §2):

* ``NONE``        — unprotected GEMM.
* ``GLOBAL``      — global ABFT (Hari et al.-style): one column checksum of A,
                    one (offline) row checksum of B, scalar/vector check over
                    the whole GEMM.  Minimal redundant FLOPs; adds HBM reads
                    for the output summation (XLA cannot fuse a reduction
                    into the dot's epilogue on TPU) and a fixed check op.
* ``BLOCK_1S``    — one-sided block-level ABFT fused into the Pallas matmul
                    kernel: per-block checksum of the B tile (VPU), weighted
                    row-sum of the A tile against it (VPU), zero extra HBM
                    traffic.  TPU-native analogue of the paper's one-sided
                    thread-level ABFT.  Residual is a length-bm vector per
                    block → locates the faulty output row.
* ``BLOCK_2S``    — two-sided block-level ABFT: checksums of both tiles plus
                    a scalar dot; fewer VPU FLOPs than one-sided on TPU but
                    scalar (non-locating) residual per block.
* ``REPLICA``     — thread-level replication baseline (paper §4, 'replicated
                    MMA, single accumulation'): the block matmul is re-issued
                    on the MXU accumulating into a single vector.  Doubles
                    MXU work; included as the paper's strawman.

The analytic overhead model mirrors paper Table 1, re-derived for the TPU
execution model (MXU/VPU co-issue, XLA fusion; see DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.intensity import GemmDims, roofline_time


class Scheme(enum.Enum):
    NONE = "none"
    GLOBAL = "global"
    BLOCK_1S = "block_1s"
    BLOCK_2S = "block_2s"
    REPLICA = "replica"
    AUTO = "auto"  # resolved by the intensity-guided selector

    @property
    def is_block_level(self) -> bool:
        return self in (Scheme.BLOCK_1S, Scheme.BLOCK_2S, Scheme.REPLICA)


@dataclasses.dataclass(frozen=True)
class BlockShape:
    """Pallas tile sizes for the fused kernel (MXU-aligned multiples of 128
    on the minor dims; see kernels/abft_matmul.py)."""

    bm: int = 256
    bk: int = 512
    bn: int = 256


@dataclasses.dataclass(frozen=True)
class SchemeCost:
    """Redundant work added by a scheme on top of the plain GEMM."""

    flops_mxu: float      # extra matmul-unit FLOPs
    flops_vpu: float      # extra vector-unit FLOPs (checksum math)
    bytes_hbm: float      # extra HBM traffic
    fixed_ops: int        # extra *unfused* dispatched ops (checks, reduces)


def _grid(dims: GemmDims, blocks: BlockShape) -> tuple:
    """Effective grid extents (ceil-div; thin GEMMs clamp to one block)."""
    gm = max(1, -(-dims.m // blocks.bm))
    gn = max(1, -(-dims.n // blocks.bn))
    return gm, gn


def cost_none(
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    return SchemeCost(0.0, 0.0, 0.0, 0)


def cost_global(
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    # Online: activation checksum colsum(A) (fused unless first layer),
    # checksum product a_sum @ B -> (1, n) [the vector check, which also
    # *locates* the faulty column], output column-summation of C, and a
    # residual compare.  Weight checksum rowsum(B) is built offline.
    #
    # ``first_layer``: the activation checksum of A normally fuses into
    # the previous layer's epilogue; the first protected layer has no
    # producer to fuse with and pays an extra read of A.
    b, m, k, n = dims.batch, dims.m, dims.k, dims.n
    flops_vpu = b * (m * k + m * n)         # colsum(A) + colsum(C)
    flops_mxu = b * 2.0 * k * n             # a_sum @ B on the MXU
    bytes_hbm = b * float(m * n * dims.out_dtype_bytes)  # re-read C
    if first_layer:
        bytes_hbm += dims.bytes_a
    # separate check op: the reduction over C does not fuse into the
    # dot custom-call; the compare itself is tiny but dispatched.
    return SchemeCost(flops_mxu, flops_vpu, bytes_hbm, 2)


def cost_block_1s(
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    # Per k-step per block: b_sum (bk*bn adds, recomputed gm times),
    # weighted row-sum acc += A_tile @ b_sum as VPU multiply-add
    # (2*bm*bk, recomputed gn times), plus the magnitude accumulator for
    # the principled threshold (same cost again), plus final row-sum of
    # the output tile (bm*bn once per block).
    b, m, k, n = dims.batch, dims.m, dims.k, dims.n
    gm, gn = _grid(dims, blocks)
    flops_vpu = b * (
        gm * (k * n)            # b_sum recomputation across block rows
        + 2.0 * m * k * gn * 2  # weighted row-sum + |.| bound accumulator
        + m * n                 # output-tile row sums
    )
    bytes_hbm = b * float(gm * gn * 4 * 2)  # per-block residual flags
    return SchemeCost(0.0, flops_vpu, bytes_hbm, 0)


def cost_block_2s(
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    # a_sum per block (bm*bk per step, recomputed gn times), b_sum
    # (recomputed gm times), scalar dot (2*bk per step per block),
    # output-tile total sum (bm*bn per block).
    b, m, k, n = dims.batch, dims.m, dims.k, dims.n
    gm, gn = _grid(dims, blocks)
    flops_vpu = b * (
        m * k * gn
        + k * n * gm
        + 2.0 * k * gm * gn
        + m * n
    )
    bytes_hbm = b * float(gm * gn * 4 * 2)
    return SchemeCost(0.0, flops_vpu, bytes_hbm, 0)


def cost_replica(
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    # Replicated block matmul accumulating to a single vector: the MXU
    # work doubles (paper §4); comparison is in-register.
    b, m, n = dims.batch, dims.m, dims.n
    return SchemeCost(dims.flops, b * float(m * n), 0.0, 0)


def scheme_cost(
    scheme,
    dims: GemmDims,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> SchemeCost:
    """Analytic redundant-work model, per DESIGN.md §2 / paper Table 1.

    ``scheme`` is a Scheme enum or a registered scheme name; dispatch goes
    through the SchemeRegistry (core/policy.py), so a newly registered
    scheme's cost model participates here — and therefore in the
    intensity-guided selection — without touching this module."""
    if scheme in (Scheme.AUTO, "auto"):
        return SchemeCost(0.0, 0.0, 0.0, 0)
    from repro_torch.core.policy import default_registry

    return default_registry().get(scheme).cost(dims, blocks, first_layer)


def protected_time(
    scheme: Scheme,
    dims: GemmDims,
    hw: HardwareSpec,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> float:
    """Modeled execution time of the GEMM protected by ``scheme``."""
    cost = scheme_cost(scheme, dims, blocks, first_layer)
    return roofline_time(
        flops_mxu=dims.flops + cost.flops_mxu,
        flops_vpu=cost.flops_vpu,
        bytes_hbm=dims.bytes_total + cost.bytes_hbm,
        hw=hw,
        fixed_ops=cost.fixed_ops,
    )


def overhead_pct(
    scheme: Scheme,
    dims: GemmDims,
    hw: HardwareSpec,
    blocks: BlockShape = BlockShape(),
    first_layer: bool = False,
) -> float:
    """Execution-time overhead percentage ((T_r - T_o) / T_o * 100), the
    paper's primary metric (§6.2)."""
    t_o = roofline_time(dims.flops, 0.0, dims.bytes_total, hw)
    t_r = protected_time(scheme, dims, hw, blocks, first_layer)
    return (t_r - t_o) / t_o * 100.0
