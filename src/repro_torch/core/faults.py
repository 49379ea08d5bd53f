"""Soft-error fault injection (paper §2.3 fault model; port of the
one-shot surface of ``repro.core.faults``).

A single faulty output value per GEMM: ``inject_output_fault`` corrupts a
materialized output (global/none paths); the fused ABFT matmul kernel
takes the same ``FaultSpec`` and corrupts its f32 accumulator after the
checksums have read the tiles.  Bit flips XOR the raw bit pattern; value
faults add a delta.  The port runs eagerly, so the spec holds plain
Python numbers.  ``FaultModel`` campaigns are not ported in this slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FaultSpec(NamedTuple):
    """Where/what to inject.  row/col: coordinates in the 2-D GEMM output;
    delta: value added (value mode); bit: if >= 0, flip this bit instead
    (dtype-relative: f32 accumulator bits on the block path, the output
    dtype's bits on the global path); enabled: 0/1 master switch."""

    row: int
    col: int
    delta: float
    bit: int
    enabled: int

    @staticmethod
    def none() -> "FaultSpec":
        return FaultSpec(row=0, col=0, delta=0.0, bit=-1, enabled=0)

    @staticmethod
    def value(row: int, col: int, delta: float) -> "FaultSpec":
        return FaultSpec(row=int(row), col=int(col), delta=float(delta),
                         bit=-1, enabled=1)

    @staticmethod
    def bitflip(row: int, col: int, bit: int) -> "FaultSpec":
        return FaultSpec(row=int(row), col=int(col), delta=0.0,
                         bit=int(bit), enabled=1)


_INT_FOR_BYTES = {2: torch.int16, 4: torch.int32}


def flip_bit(value: torch.Tensor, bit: int) -> torch.Tensor:
    """XOR one bit of each element of ``value`` (same shape and dtype)."""
    nbits = 8 * value.element_size()
    mask = 1 << int(bit)
    if mask >= 1 << (nbits - 1):          # the sign bit, as a signed int
        mask -= 1 << nbits
    raw = value.contiguous().view(_INT_FOR_BYTES[value.element_size()])
    return torch.bitwise_xor(raw, mask).view(value.dtype)


def inject_output_fault(y: torch.Tensor, fault: FaultSpec) -> torch.Tensor:
    """Corrupt element ``(row, col)`` of a (..., m, n) output — in every
    leading batch index, as the reference's broadcast mask does."""
    m, n = y.shape[-2], y.shape[-1]
    if not fault.enabled or not (0 <= fault.row < m and 0 <= fault.col < n):
        return y
    y = y.clone()
    cell = y[..., fault.row, fault.col]
    if fault.bit >= 0:
        y[..., fault.row, fault.col] = flip_bit(cell, fault.bit)
    else:
        y[..., fault.row, fault.col] = cell + torch.tensor(
            fault.delta, dtype=torch.float32).to(y.dtype).to(y.device)
    return y
