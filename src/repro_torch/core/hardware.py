"""Hardware specifications used by the roofline model and scheme selector
(``TPU_V5E`` and ``NVIDIA_T4`` are verbatim copies of ``repro.core.hardware``
so parity tests can hand the same spec to both packages).

The paper (Kosaian & Rashmi, SC '21) keys its adaptive ABFT decision off the
device compute-to-memory-bandwidth ratio (CMR).  We generalize this to a
small spec record covering the terms needed by the three-term roofline
(compute / memory / collective) plus the TPU-specific split between the MXU
(systolic matmul unit) and the VPU (vector unit), which is where the
block-level ABFT checksum math executes (see DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Static per-chip hardware description.

    Attributes:
      name: human-readable device name.
      peak_flops: peak matmul-unit FLOP/s at the working precision (MXU on
        TPU, Tensor Cores on GPU).
      vpu_flops: peak vector-unit FLOP/s (VPU on TPU, CUDA cores on GPU).
        Checksum generation runs here; it co-issues with the matmul unit.
      hbm_bw: main-memory bandwidth, bytes/s.
      ici_bw: per-link interconnect bandwidth, bytes/s (ICI on TPU, NVLink
        on GPU).  Used for the collective roofline term.
      hbm_bytes: main-memory capacity per chip.
      vmem_bytes: on-chip scratchpad (VMEM / shared memory) capacity.
      fixed_op_overhead_s: fixed per-dispatched-op overhead (kernel launch on
        GPU, ~op scheduling on TPU).  Charged once per *unfused* redundant
        op; this is what makes a separate global-ABFT reduction kernel
        non-free on thin, bandwidth-bound layers.
    """

    name: str
    peak_flops: float
    vpu_flops: float
    hbm_bw: float
    ici_bw: float
    hbm_bytes: float
    vmem_bytes: float
    fixed_op_overhead_s: float = 1.5e-6

    @property
    def cmr(self) -> float:
        """Compute-to-memory-bandwidth ratio (FLOPs per byte)."""
        return self.peak_flops / self.hbm_bw


# TPU v5e — the target device for this reproduction.  Constants per the
# assignment brief: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    vpu_flops=1.9e12,        # 8x128 lanes x 2 (FMA) x ~0.94 GHz
    hbm_bw=819e9,
    ici_bw=50e9,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=64 * 1024**2,
    fixed_op_overhead_s=1.5e-6,
)

# NVIDIA T4 — the paper's evaluation device; used only by the
# paper-validation benchmarks to reproduce the published crossovers.
NVIDIA_T4 = HardwareSpec(
    name="nvidia-t4",
    peak_flops=65e12,        # FP16 Tensor Core
    vpu_flops=8.1e12,        # FP32 CUDA cores
    hbm_bw=320e9,
    ici_bw=16e9,             # PCIe gen3 x16
    hbm_bytes=16 * 1024**3,
    vmem_bytes=64 * 1024,    # shared memory per SM
    fixed_op_overhead_s=5e-6,
)

# NVIDIA H100 SXM — the port's target card.  Numbers from NVIDIA's H100
# data sheet (SXM part, dense rates without sparsity): 989 TFLOP/s bf16
# Tensor Core, 67 TFLOP/s FP32 on CUDA cores, 3.35 TB/s HBM3, 80 GB,
# 900 GB/s NVLink (450 GB/s each way), 227 KB shared memory per block.
# The fixed per-op overhead keeps the dataclass default until a chip run
# measures Hopper's launch cost.
NVIDIA_H100_SXM = HardwareSpec(
    name="nvidia-h100-sxm",
    peak_flops=989e12,
    vpu_flops=67e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    hbm_bytes=80e9,
    vmem_bytes=227 * 1024,
)

DEFAULT = NVIDIA_H100_SXM


def get_hardware(name: str) -> HardwareSpec:
    table = {h.name: h for h in (TPU_V5E, NVIDIA_T4, NVIDIA_H100_SXM)}
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown hardware {name!r}; known: {sorted(table)}") from None
