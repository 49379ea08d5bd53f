"""``protected_matmul`` — the paper's contribution as a PyTorch op (port
of ``repro.core.protected``).

Every linear layer calls this instead of ``x @ w``.  The active policy
resolves the scheme per GEMM shape; the scheme's registered executor runs
and returns (y, CheckResult):

  none     — plain matmul, clean check;
  global   — plain matmul (cuBLAS on the card) + the global row check
             against the weight's row checksum;
  block_*  — the fused ABFT matmul (``kernels/ops.py``): K1 for CUDA
             tensors, its plain version for CPU tensors.  There is no
             switch that routes a CUDA tensor anywhere else;
  replica  — K1 in replica mode (ablation baseline).

The global path's f32 threshold assumes f32 accumulation: on the card,
TF32 and reduced-precision bf16 reductions must be off (the serving
engine and ``chip_smoke.py`` set both flags).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.markers import protection_scope
from repro_torch.core import checksums
from repro_torch.core.checksums import CheckResult
from repro_torch.core.faults import FaultSpec, inject_output_fault
from repro_torch.core.hardware import DEFAULT, HardwareSpec
from repro_torch.core.intensity import GemmDims
from repro_torch.core.policy import (
    FixedPolicy,
    IntensityGuidedPolicy,
    ProtectionPolicy,
    default_registry,
    scheme_name_of,
)
from repro_torch.core.schemes import BlockShape, Scheme

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ABFTConfig:
    """Execution knobs of the protected GEMMs plus the selection policy.
    ``policy=None`` means ``IntensityGuidedPolicy()``; ``hardware`` is the
    roofline the policy selects against (the H100 by default)."""

    enabled: bool = True
    hardware: HardwareSpec = DEFAULT
    blocks: BlockShape = BlockShape()
    c_factor: float = 16.0
    # fused-ABFT flash attention: K2 for the full-sequence forward, K3 for
    # decode attention; plain attention outside any kernel otherwise
    flash_attention: bool = False
    policy: ProtectionPolicy | None = None
    # K1 runs pass 1 as one K slice at any M (``abft_matmul.split_k``):
    # the serving prefill paths, so a row gets the same bits whatever the
    # height of the GEMM it sits in (whole prompt, suffix or chunk)
    one_slice: bool = False
    # each row of a (B, T, k) GEMM with B == decode_rows is summed in the
    # order of the decode step's B-row GEMM, by K1 (``kernels/ops``) and
    # by the plain product of ``none``/``global`` (``_plain_dot``): the
    # speculative verify step, so its rows get decode's bits
    decode_rows: int | None = None

    def effective_policy(self) -> ProtectionPolicy:
        if not self.enabled:
            return FixedPolicy(Scheme.NONE)
        return self.policy if self.policy is not None \
            else IntensityGuidedPolicy()

    def resolve(self, dims: GemmDims, first_layer: bool = False):
        return self.effective_policy().select(
            dims, self.hardware, first_layer=first_layer, cfg=self).scheme

    @staticmethod
    def from_policy(policy: ProtectionPolicy, **kw) -> "ABFTConfig":
        return ABFTConfig(policy=policy, **kw)


def _gemm_dims(x, w, out_dtype) -> GemmDims:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return GemmDims(m=m, k=x.shape[-1], n=w.shape[-1], batch=1,
                    dtype_bytes=x.element_size(),
                    out_dtype_bytes=out_dtype.itemsize)


def protected_matmul(x, w, cfg: ABFTConfig = ABFTConfig(), *, wsums=None,
                     out_dtype=None, fault: FaultSpec | None = None,
                     first_layer: bool = False, site: str = "unlabeled",
                     select_dtype=None):
    """ABFT-protected ``y = x @ w``; x: (..., m, k), w: (k, n).  Returns
    (y, CheckResult).  ``site`` is the plan-facing layer tag.
    ``select_dtype``: the output dtype the scheme is selected for, where
    it differs from ``out_dtype`` (a row-parallel partial runs in f32 and
    keeps the site's selection).  The
    executor runs inside an ``abft[<scheme>][<site>]`` marker scope, which
    the coverage audit (``repro_torch.analysis``) reads at every op it
    records; with no audit running the scope is a no-op."""
    out_dtype = out_dtype or x.dtype
    scheme = cfg.resolve(_gemm_dims(x, w, select_dtype or out_dtype),
                         first_layer=first_layer)
    executor = default_registry().executor(scheme)
    with protection_scope(scheme_name_of(scheme), site):
        return executor(x, w, cfg, wsums=wsums, out_dtype=out_dtype,
                        fault=fault)


_BLOCK_MODES = {"block_1s": "1s", "block_2s": "2s", "replica": "replica"}


def protected_matmul_batched(x, w, cfg: ABFTConfig = ABFTConfig(), *,
                             out_dtype=None, fault: FaultSpec | None = None,
                             site: str = "unlabeled",
                             split_rows: int | None = None,
                             select_dtype=None):
    """``protected_matmul`` of E expert GEMMs x (E, C, k) @ w (E, k, n) in
    one call: the reference's ``jax.vmap`` of it over an MoE layer's
    experts.  The scheme is the one the policy picks for one expert's
    GEMM (m = C), as under the vmap.  Block schemes run K1 batched over
    the experts, one launch (``kernels/ops.abft_matmul_batched``);
    ``none`` and ``global`` a batched plain product, ``global`` checked
    against each expert's weight checksums.  The fault is not batched: it
    lands in every expert.  Schemes registered beyond the built-in ones
    have no batched executor and raise.  ``split_rows``: K1's
    (``ops.abft_matmul_batched``).  ``select_dtype``: as
    ``protected_matmul``'s (a row-parallel expert FFN's f32 partial keeps
    the site's selection).  Returns (y (E, C, n), flag: any expert's)."""
    out_dtype = out_dtype or x.dtype
    name = scheme_name_of(cfg.resolve(_gemm_dims(
        x[0], w[0], select_dtype or out_dtype)))
    with protection_scope(name, site):
        return _batched(x, w, cfg, name, out_dtype, fault, split_rows)


def _batched(x, w, cfg, name, out_dtype, fault, split_rows):
    """``protected_matmul_batched``'s executors, the scheme resolved."""
    if name in _BLOCK_MODES:
        from repro_torch.kernels import ops

        y, chk = ops.abft_matmul_batched(
            x, w, mode=_BLOCK_MODES[name], blocks=cfg.blocks,
            out_dtype=out_dtype, fault=fault, c_factor=cfg.c_factor,
            one_slice=cfg.one_slice, split_rows=split_rows)
        return y, chk.flag
    if name not in ("none", "global"):
        raise NotImplementedError(
            f"scheme {name!r} has no executor batched over experts")
    y = _plain_dot(x, w, out_dtype, fault)
    if name == "none":
        return y, CheckResult.clean(x.device).flag
    return y, checksums.global_row_check(
        x, checksums.weight_row_checksum(w),
        checksums.weight_abs_checksum(w), y, c_factor=cfg.c_factor).flag


# ------------------------------------------------------------- executors

def _plain_dot(x, w, out_dtype, fault, decode_rows=None):
    """``x @ w`` with f32 accumulation, cast once to ``out_dtype``.  A
    low-precision product widened for an f32 output (the bf16 model's
    tied head) returns the f32 accumulator itself, as the reference's
    ``preferred_element_type=f32`` does: on the card through cuBLAS's
    ``mm(..., out_dtype=f32)``, on the CPU (which has no such kernel) as
    an f32 product of the widened operands (on the meta device as on the
    card, so a dry run walks the card's ops).  ``mm(..., out_dtype=)``
    has no derivative, so a product autograd records (a bf16 training
    step's tied head) takes the widened operands on every device.

    ``decode_rows`` (a speculative verify step on the card, x of shape
    (B, T, k) with B == ``decode_rows``): each step t runs as its own
    product at the decode step's shape (B, 1, k), since the library picks
    its kernel, and so a row's summation order, by the row count."""
    if decode_rows is not None and x.is_cuda and x.dim() == 3 \
            and x.shape[0] == decode_rows and x.shape[1] > 1:
        y = torch.cat([_plain_dot(x[:, t:t + 1].contiguous(), w, out_dtype,
                                  None) for t in range(x.shape[1])], dim=1)
    elif out_dtype == F32 and x.dtype != F32:
        x2 = x.reshape(-1, x.shape[-1])
        grad = torch.is_grad_enabled() and (x2.requires_grad
                                             or w.requires_grad)
        if x2.device.type in ("cuda", "meta") and not grad:
            # the meta device (the dry run's shapes) takes the card's op
            y = torch.mm(x2, w, out_dtype=F32)
        else:
            y = x2.float() @ w.float()
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = torch.matmul(x, w).to(out_dtype)
    if fault is not None:
        y = inject_output_fault(y, fault)
    return y


def _exec_none(x, w, cfg, *, wsums, out_dtype, fault):
    return (_plain_dot(x, w, out_dtype, fault, cfg.decode_rows),
            CheckResult.clean(x.device))


def _exec_global(x, w, cfg, *, wsums, out_dtype, fault):
    y = _plain_dot(x, w, out_dtype, fault, cfg.decode_rows)
    if wsums is None:
        wsums = (checksums.weight_row_checksum(w),
                 checksums.weight_abs_checksum(w))
    x2 = x.reshape(-1, x.shape[-1])
    y2 = y.reshape(-1, y.shape[-1])
    return y, checksums.global_row_check(x2, wsums[0], wsums[1], y2,
                                         c_factor=cfg.c_factor)


def _block_executor(mode: str):
    def _exec(x, w, cfg, *, wsums, out_dtype, fault):
        from repro_torch.kernels import ops

        return ops.abft_matmul(x, w, mode=mode, blocks=cfg.blocks,
                               out_dtype=out_dtype, fault=fault,
                               c_factor=cfg.c_factor,
                               one_slice=cfg.one_slice,
                               decode_rows=cfg.decode_rows)

    return _exec


for _name, _exec in (
    ("none", _exec_none),
    ("global", _exec_global),
    ("block_1s", _block_executor("1s")),
    ("block_2s", _block_executor("2s")),
    ("replica", _block_executor("replica")),
):
    default_registry().set_executor(_name, _exec)
