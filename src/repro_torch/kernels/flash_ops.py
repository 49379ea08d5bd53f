"""Wrappers for fused-ABFT attention (port of ``repro.kernels.flash_ops``):
``flash_attention`` over a full sequence (K2) and ``flash_decode`` /
``flash_decode_paged`` for decode (K3), all in ``kernels/flash_attention.py``.
CUDA tensors launch the kernel or raise; CPU tensors take its plain
version.  q/k/v and the dense cache are read in place: no kv-head repeat
and no pad copy (the reference wrapper does both before its kernel).
"""

from __future__ import annotations

import torch

from repro_torch.analysis import markers
from repro_torch.core.checksums import ATOL, CheckResult, flag_from, tolerance_scale
from repro_torch.core.faults import FaultSpec
from repro_torch.kernels.flash_attention import (
    f32_bits,
    flash_attention_kernel,
    flash_attention_ref,
    flash_decode_kernel,
    flash_decode_ref,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def attn_flops(rows: int, d: int, dv: int, keys: int) -> float:
    """The FLOPs a K2/K3 call records in the coverage audit
    (``analysis/op_walk.py``): its score product (``rows`` query rows x
    depth ``d`` x ``keys``) and its PV product (``rows`` x ``keys`` x
    ``dv``), over every key, as the plain attention paths' products count
    them; a query row is one (batch, position, head)."""
    return 2.0 * rows * keys * (d + dv)


def _attn_check(rs, bs, rp, bp, d: int, s: int,
                c_factor: float) -> CheckResult:
    """Fold the residual/bound vectors of both attention GEMMs (scores:
    depth ``d``; PV: depth ``s``) into one CheckResult."""
    tau_s = ATOL + tolerance_scale(d, c=c_factor) * bs
    tau_pv = ATOL + tolerance_scale(s, c=c_factor) * bp
    flag = torch.logical_or(flag_from(rs, tau_s), flag_from(rp, tau_pv))
    residual = torch.stack([rs.max(), rp.max()])
    threshold = torch.stack([tau_s.min(), tau_pv.min()])
    return CheckResult(flag=flag, residual=residual, threshold=threshold)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128, fault: FaultSpec | None = None,
                    c_factor: float = 16.0):
    """Fused-ABFT attention.  q: (B, Lq, H, D); k/v: (B, Lk, KV, D[v]).
    Returns (out (B, Lq, H, Dv), CheckResult) covering both attention
    GEMMs (scores and PV).  ``fault`` adds its delta to the output
    accumulator at (row, col) of every (batch, head), as the reference's
    shared fault vector does.  No backward exists (the reference kernel has
    none either): called while autograd records, it raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward (neither has the reference "
            "kernel): train with flash_attention=False")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    bq_eff = min(bq, _round_up(Lq, 8))
    bk_eff = min(bk, _round_up(Lk, 8))
    lq_pad, lk_pad = _round_up(Lq, bq_eff), _round_up(Lk, bk_eff)
    if not causal and lk_pad != Lk:
        raise ValueError("non-causal padding not supported; pad caller")
    f = fault if fault is not None else FaultSpec.none()
    fi = (f.row // bq_eff, 0, f.row % bq_eff, f.col, int(f.enabled),
          f32_bits(f.delta))
    run = flash_attention_kernel if (q.is_cuda or k.is_cuda) \
        else flash_attention_ref
    rows, Dv = B * Lq * H, v.shape[-1]
    with markers.kernel_scope("K2", rows, D, Lk,
                              attn_flops(rows, D, Dv, Lk)):
        out, rs, bs, rp, bp = run(q, k, v, fi, bq=bq_eff, bk=bk_eff,
                                  causal=causal, lq_pad=lq_pad,
                                  lk_pad=lk_pad)
    return out, _attn_check(rs, bs, rp, bp, D, Lk, c_factor)


def _lengths(lengths, B: int, device) -> torch.Tensor:
    return torch.as_tensor(lengths, dtype=torch.int32).to(
        device).expand(B).contiguous()


def _lse(on: bool) -> dict:
    """The kernel's ``lse`` keyword where the caller asks for it."""
    return {"lse": True} if on else {}


def flash_decode(q, k_cache, v_cache, lengths, *, bk: int = 128,
                 c_factor: float = 16.0, return_lse: bool = False):
    """Decode attention against a ragged dense cache.  q: (B, 1, H, D);
    k_cache/v_cache: (B, S, KV, D[v]); lengths: (B,) valid lengths.
    Returns (out, CheckResult), and with ``return_lse`` the (B, KV, G)
    f32 log-sum-exp of each head's scores over the valid keys (-inf and a
    zero output for a row of none: a sequence shard's partial)."""
    B, _, H, D = q.shape
    S = k_cache.shape[1]
    block = min(bk, _round_up(S, 8))
    run = flash_decode_kernel if (q.is_cuda or k_cache.is_cuda) \
        else flash_decode_ref
    with markers.kernel_scope("K3", B * H, D, S,
                              attn_flops(B * H, D, v_cache.shape[-1], S)):
        out, rs, bs, rp, bp, *lse = run(q, k_cache, v_cache, None,
                                        _lengths(lengths, B, q.device),
                                        block=block, **_lse(return_lse))
    return (out, _attn_check(rs, bs, rp, bp, D, S, c_factor), *lse)


def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths, *,
                       c_factor: float = 16.0, return_lse: bool = False):
    """Decode attention against a paged cache.  k_pool/v_pool:
    (NB, BS, KV, D[v]); block_tables: (B, W) int32 (sentinel tails are
    clamped; the lengths mask makes their contribution exactly zero).
    ``return_lse`` as ``flash_decode``'s."""
    B, _, H, D = q.shape
    BS = v_pool.shape[1]
    W = block_tables.shape[1]
    run = flash_decode_kernel if (q.is_cuda or k_pool.is_cuda) \
        else flash_decode_ref
    with markers.kernel_scope("K3", B * H, D, W * BS,
                              attn_flops(B * H, D, v_pool.shape[-1],
                                         W * BS)):
        out, rs, bs, rp, bp, *lse = run(
            q, k_pool, v_pool, block_tables.to(torch.int32).contiguous(),
            _lengths(lengths, B, q.device), block=BS, **_lse(return_lse))
    return (out, _attn_check(rs, bs, rp, bp, D, W * BS, c_factor), *lse)
