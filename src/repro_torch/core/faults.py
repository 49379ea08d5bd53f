"""Soft-error fault injection (paper §2.3 fault model; port of the
one-shot surface of ``repro.core.faults``).

A single faulty output value per GEMM: ``inject_output_fault`` corrupts a
materialized output (global/none paths); the fused ABFT matmul kernel
takes the same ``FaultSpec`` and corrupts its f32 accumulator after the
checksums have read the tiles.  Bit flips XOR the raw bit pattern; value
faults add a delta.  The port runs eagerly, so the spec holds plain
Python numbers.

Campaign injection (``FaultModel``) generalizes the one-shot surface to a
fault *process*: Bernoulli-per-step transient faults at a configurable
rate, plus sticky *permanent* faults (a faulty output unit corrupting
every matching GEMM output from onset until cleared).  The schedule is
driven by one seeded ``numpy.random.Generator`` in the reference's draw
order, so a campaign replays the reference's schedule record for record.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
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


# exponent-bit index range [lo, hi) per floating dtype: flips there scale
# the value by powers of two, the classic catastrophic soft-error signature
_EXPONENT_BITS = {
    torch.bfloat16: (8, 15),      # s1 e8 m7
    torch.float32: (23, 31),      # s1 e8 m23
    torch.float16: (10, 15),      # s1 e5 m10
}
_BY_NAME = {str(dt).removeprefix("torch."): dt for dt in _EXPONENT_BITS}


def _torch_dtype(dtype):
    """A torch dtype, or the torch dtype of a numpy dtype or dtype name
    (``np.float32``, ``"bfloat16"``); None when there is none."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = getattr(dtype, "__name__", str(dtype))
    return _BY_NAME.get(name)


def exponent_bit_range(dtype) -> tuple:
    """``[lo, hi)`` exponent-bit indices of a floating dtype (bf16 bits
    8-14, f32 bits 23-30, f16 bits 10-14); torch dtypes, numpy dtypes and
    their names are accepted."""
    dt = _torch_dtype(dtype)
    if dt not in _EXPONENT_BITS:
        raise ValueError(
            f"no exponent-bit range for dtype {dtype}; known: "
            f"{sorted(_BY_NAME)}")
    return _EXPONENT_BITS[dt]


def random_fault(rng: np.random.Generator, m: int, n: int,
                 magnitude: float | None = None,
                 dtype=torch.bfloat16) -> FaultSpec:
    """Sample a random single-output fault for campaigns: an exponent-bit
    flip in ``dtype`` (the corrupted buffer's dtype: f32 for the block
    path's accumulator) or a value fault of the given magnitude."""
    row = int(rng.integers(m))
    col = int(rng.integers(n))
    if magnitude is None:
        lo, hi = exponent_bit_range(dtype)
        return FaultSpec.bitflip(row, col, int(rng.integers(lo, hi)))
    return FaultSpec.value(row, col, magnitude)


# ------------------------------------------------------------- campaigns

@dataclasses.dataclass
class CampaignFault:
    """One fault the campaign process emitted for one engine step.

    ``kind`` is "transient" (fires once) or "permanent" (a sticky faulty
    output unit: the SAME (layer, site, row, col, bit) target re-emitted
    every step from ``onset_step`` until cleared).  ``model_fault`` is the
    ``ModelFault`` the engine threads into the model call."""

    kind: str
    onset_step: int
    layer: int
    site: str
    row: int
    col: int
    bit: int                       # -1 => value fault of ``delta``
    delta: float
    model_fault: object            # ModelFault

    def describe(self) -> dict:
        """JSON-ready ground truth (the replay-equality surface)."""
        return {
            "kind": self.kind, "onset_step": self.onset_step,
            "layer": self.layer, "site": self.site,
            "row": self.row, "col": self.col,
            "bit": self.bit, "delta": self.delta,
        }


class FaultModel:
    """Seeded, deterministic fault process for serving campaigns.

    ``poll()`` is called once per engine step and returns at most ONE
    ``CampaignFault``: an active sticky permanent fault takes precedence,
    else a Bernoulli(``transient_rate``) draw decides whether this step
    suffers a transient fault.  A Bernoulli(``permanent_rate``) draw
    governs the ONSET of a sticky fault, which then corrupts every
    subsequent step until ``permanent_duration`` steps elapse (or
    ``clear_sticky()``).

    Every random decision flows through one ``numpy.random.Generator``
    seeded at construction, in a fixed order per poll, so the same seed
    replays the same schedule (``self.schedule`` records it).

    ``rows``/``cols`` bound the (row, col) target within the faulted GEMM
    call: decode-step GEMMs only ever see row 0 by default.  An
    out-of-range target is a physical no-op and classifies as ``masked``.
    """

    def __init__(self, *, transient_rate: float = 0.0,
                 permanent_rate: float = 0.0,
                 permanent_duration: int | None = 8,
                 seed: int = 0, layers: int = 1,
                 sites: tuple = ("qkv", "attn_out", "mlp_up", "mlp_down"),
                 rows: int = 1, cols: int = 32,
                 dtype=torch.bfloat16, magnitude: float | None = None):
        if not 0.0 <= transient_rate <= 1.0:
            raise ValueError("transient_rate must be in [0, 1]")
        if not 0.0 <= permanent_rate <= 1.0:
            raise ValueError("permanent_rate must be in [0, 1]")
        if permanent_duration is not None and permanent_duration < 1:
            raise ValueError("permanent_duration must be >= 1 or None")
        self.transient_rate = float(transient_rate)
        self.permanent_rate = float(permanent_rate)
        self.permanent_duration = permanent_duration
        self.seed = int(seed)
        self.layers = int(layers)
        self.sites = tuple(sites)
        self.rows = int(rows)
        self.cols = int(cols)
        self.dtype = dtype
        self.magnitude = magnitude
        self.reset()

    def reset(self) -> None:
        """Rewind to the seed: same schedule on the next run (replay)."""
        self._rng = np.random.default_rng(self.seed)
        self.step = 0
        self.sticky: CampaignFault | None = None
        self.schedule: list = []

    def clear_sticky(self) -> None:
        """Repair the faulty unit (ends the permanent fault early)."""
        self.sticky = None

    def _draw_target(self, kind: str) -> CampaignFault:
        # deferred import: models.layers imports this module
        from repro_torch.models.layers import ModelFault

        layer = int(self._rng.integers(self.layers))
        site = self.sites[int(self._rng.integers(len(self.sites)))]
        spec = random_fault(self._rng, self.rows, self.cols,
                            magnitude=self.magnitude, dtype=self.dtype)
        return CampaignFault(
            kind=kind, onset_step=self.step, layer=layer, site=site,
            row=spec.row, col=spec.col, bit=spec.bit,
            # the delta as the f32 the kernels add (the reference records
            # its f32 device scalar)
            delta=float(np.float32(spec.delta)),
            model_fault=ModelFault.at(layer, site, spec))

    def poll(self) -> CampaignFault | None:
        """Advance the process by one engine step; return this step's
        fault (or None).  Two Bernoulli draws every poll, then target
        draws only when one fires."""
        u_perm = float(self._rng.random())
        u_trans = float(self._rng.random())
        if self.sticky is not None and self.permanent_duration is not None \
                and self.step - self.sticky.onset_step >= \
                self.permanent_duration:
            self.sticky = None                       # repaired/remapped
        if self.sticky is None and u_perm < self.permanent_rate:
            self.sticky = self._draw_target("permanent")
        if self.sticky is not None:
            fired: CampaignFault | None = self.sticky
        elif u_trans < self.transient_rate:
            fired = self._draw_target("transient")
        else:
            fired = None
        if fired is not None:
            rec = fired.describe()
            rec["step"] = self.step
            self.schedule.append(rec)
        self.step += 1
        return fired
