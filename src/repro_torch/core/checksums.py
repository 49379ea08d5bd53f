"""ABFT checksum math shared by the global path and the kernels (port of
``repro.core.checksums``).

Checksum equality is a *threshold* test: residuals are compared against
a bound built from the magnitude sum of the products entering the check,

    tau = atol + eps_acc * c * sqrt(K) * Sigma|a_ik||b_kj|
          (+ eps_out/2 * rowsum|y| when the checked output was downcast),

which assumes f32 accumulation — on the GPU, TF32 and reduced-precision
bf16 reductions must stay off.  NaN/Inf residuals always flag (the
compare is ``~(residual <= tau)``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32

DEFAULT_C_FACTOR = 16.0
ATOL = 1e-30


def eps_of(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def tolerance_scale(k: int, acc_dtype=F32, c: float = DEFAULT_C_FACTOR):
    """eps_acc * c * sqrt(k): the relative threshold multiplier."""
    return eps_of(acc_dtype) * c * math.sqrt(max(k, 1))


class CheckResult(NamedTuple):
    """Outcome of one ABFT check: ``flag`` is a 0-d bool tensor on the
    device of the checked GEMM (read it on the host once per step, not
    per GEMM); ``residual``/``threshold`` are the raw arrays."""

    flag: torch.Tensor
    residual: torch.Tensor
    threshold: torch.Tensor

    @staticmethod
    def clean(device=None) -> "CheckResult":
        z = torch.zeros((), dtype=F32, device=device)
        return CheckResult(flag=torch.zeros((), dtype=torch.bool,
                                            device=device),
                           residual=z, threshold=z)


def flag_from(residual, threshold):
    """NaN-safe threshold compare: NaN/Inf residuals always flag."""
    return torch.logical_not(torch.all(residual <= threshold))


def weight_row_checksum(w: torch.Tensor) -> torch.Tensor:
    """rowsum over the output dim: (k, n) -> (k,), f32 (no f32 copy of w)."""
    return torch.sum(w, dim=-1, dtype=F32)


def weight_abs_checksum(w: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(w), dim=-1, dtype=F32)


def global_row_check(x, w_sum, w_abs_sum, y,
                     c_factor: float = DEFAULT_C_FACTOR) -> CheckResult:
    """Check y == x @ w using the offline checksum of w.
    x: (..., m, k); y: (..., m, n); w_sum/w_abs_sum: (k,).

    Mirrors a caveat of the reference: ``c_factor`` is accepted but the
    threshold uses ``tolerance_scale(k)`` with its default c=16
    (``repro/core/checksums.py``: ``global_row_check``).  Kept as is so
    the two packages flag the same GEMMs."""
    k = x.shape[-1]
    xf = x.to(F32)
    check = xf @ w_sum
    bound = torch.abs(xf) @ w_abs_sum
    yf = y.to(F32)
    residual = torch.abs(check - yf.sum(dim=-1))
    tau = ATOL + tolerance_scale(k) * bound
    if y.dtype != F32:
        tau = tau + 0.5 * eps_of(y.dtype) * torch.abs(yf).sum(dim=-1)
    return CheckResult(flag=flag_from(residual, tau), residual=residual,
                       threshold=tau)
