"""Arithmetic-intensity accounting for linear layers (paper §3); a copy
of ``repro.core.intensity``.

Every linear layer in the framework is described by ``GemmDims``; its
arithmetic intensity (FLOPs / bytes moved) is compared against the device
CMR to classify the layer as compute- or bandwidth-bound, which drives the
intensity-guided ABFT scheme selection (paper §5.3).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class GemmDims:
    """A (possibly batched) GEMM: (m, k) @ (k, n), repeated ``batch`` times.

    ``bytes_a/b/out`` model the *HBM traffic* of each operand.  Weights that
    are resident and re-read per step still count; operands known to be
    fused away (e.g., an activation checksum produced in a previous layer's
    epilogue) can be excluded by the caller via ``bytes_*_override``.
    """

    m: int
    k: int
    n: int
    batch: int = 1
    dtype_bytes: int = 2          # bf16 operands
    acc_bytes: int = 4            # f32 accumulation/output before downcast
    out_dtype_bytes: int = 2

    @property
    def flops(self) -> float:
        return 2.0 * self.batch * self.m * self.k * self.n

    @property
    def bytes_a(self) -> float:
        return float(self.batch * self.m * self.k * self.dtype_bytes)

    @property
    def bytes_b(self) -> float:
        return float(self.batch * self.k * self.n * self.dtype_bytes)

    @property
    def bytes_out(self) -> float:
        return float(self.batch * self.m * self.n * self.out_dtype_bytes)

    @property
    def bytes_total(self) -> float:
        return self.bytes_a + self.bytes_b + self.bytes_out

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_total


def compute_bound_ai(ai: float, hw: HardwareSpec) -> bool:
    """Paper Eq. (1), the SINGLE boundary predicate: AI strictly greater
    than the device CMR => compute bound.  AI exactly equal to the CMR is
    bandwidth-bound (the kernel still saturates HBM).  Every consumer —
    ``is_compute_bound``, the policy reason strings, the report tables,
    and the chunk-budget autotuner — goes through this one function, so
    the classification can never disagree with itself at the boundary."""
    return float(ai) > hw.cmr


def is_compute_bound(dims: GemmDims, hw: HardwareSpec) -> bool:
    """Paper Eq. (1): AI > CMR => compute bound (see compute_bound_ai)."""
    return compute_bound_ai(dims.arithmetic_intensity, hw)


def gemm_time(dims: GemmDims, hw: HardwareSpec) -> float:
    """Roofline execution-time estimate for the unprotected GEMM."""
    return max(dims.flops / hw.peak_flops, dims.bytes_total / hw.hbm_bw)


def roofline_time(
    flops_mxu: float,
    flops_vpu: float,
    bytes_hbm: float,
    hw: HardwareSpec,
    fixed_ops: int = 0,
) -> float:
    """Three-way roofline: MXU, VPU and HBM operate concurrently; fixed
    per-op overheads serialize.  This is the analytic model referenced by
    paper §7.2 and used by the intensity-guided selector."""
    return (
        max(
            flops_mxu / hw.peak_flops,
            flops_vpu / hw.vpu_flops,
            bytes_hbm / hw.hbm_bw,
        )
        + fixed_ops * hw.fixed_op_overhead_s
    )


def step_gemm_dims(tokens: int, d_model: int, d_ff: int | None = None,
                   dtype_bytes: int = 2,
                   out_dtype_bytes: int | None = None) -> GemmDims:
    """Representative GEMM of one *serving step*: ``tokens`` is the step's
    actual token composition (resident decode tokens + co-scheduled
    prefill-chunk tokens), the weight is the widest per-token projection
    (``d_model x d_ff`` when an FFN exists, else ``d_model x d_model``).

    The step composition — not the static phase — is what moves the
    operating point between the memory-bound regime (decode-only steps,
    ``m ~ batch``) and the compute-bound regime (mixed steps carrying a
    prefill chunk, ``m ~ chunk_tokens``), so the intensity-guided
    selector should be re-consulted with THESE dims every step (paper
    §5.3 applied at serving time; the engine records the resulting
    ``(intensity, scheme)`` trace in ``EngineStats``)."""
    return GemmDims(
        m=int(tokens), k=int(d_model), n=int(d_ff or d_model),
        dtype_bytes=dtype_bytes,
        out_dtype_bytes=(dtype_bytes if out_dtype_bytes is None
                         else out_dtype_bytes),
    )


def aggregate_intensity(layers: list[GemmDims]) -> float:
    """Paper §3.2 'aggregate arithmetic intensity' of a network: total FLOPs
    across linear layers divided by total bytes across linear layers."""
    total_flops = sum(l.flops for l in layers)
    total_bytes = sum(l.bytes_total for l in layers)
    if total_bytes == 0:
        return 0.0
    return total_flops / total_bytes
