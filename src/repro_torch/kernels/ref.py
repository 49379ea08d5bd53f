"""Plain PyTorch version of the fused ABFT matmul kernel (K1).

``abft_matmul_ref`` computes what ``csrc/abft_matmul.cu`` computes — and
what the TPU kernel ``repro.kernels.abft_matmul.abft_matmul_kernel``
computes — with the reference's zero padding to block multiples: the f32
product accumulated per logical k-block, the per-(block, row) one-sided
checksum and magnitude bound, the two-sided fold, the replica checksum
flushed per k-block, and the optional accumulator fault applied after the
checksums.  CPU tensors in the serving path take this version; on the card
it is the kernel's yardstick (``chip_smoke.py``).  The sums run in another
order than the kernel's, so results agree within rounding, not bitwise.
"""

from __future__ import annotations

import torch

from repro_torch.core.faults import flip_bit

F32 = torch.float32


def _pad2d(a: torch.Tensor, m: int, n: int) -> torch.Tensor:
    pm, pn = m - a.shape[0], n - a.shape[1]
    if pm == 0 and pn == 0:
        return a
    return torch.nn.functional.pad(a, (0, pn, 0, pm))


def abft_matmul_ref(x, w, fault=(0, 0, 0, 0, 0, -1), delta: float = 0.0, *,
                    mode: str, bm: int, bk: int, bn: int, out_dtype):
    """x: (M, K), w: (K, N) (any strides) -> (y (M, N) out_dtype, res, bnd)
    with res/bnd of shape (gm, gn, bm) for '1s'/'replica', (gm, gn) for
    '2s'.  ``fault`` = (block_i, block_j, row, col, enabled, bit) in
    logical block coordinates, ``delta`` the value-fault delta."""
    m, k = x.shape
    n = w.shape[1]
    gm, gk, gn = -(-m // bm), -(-k // bk), -(-n // bn)
    xb = _pad2d(x.to(F32), gm * bm, gk * bk).reshape(gm, bm, gk, bk)
    wb = _pad2d(w.to(F32), gk * bk, gn * bn).reshape(gk, bk, gn, bn)
    acc = torch.zeros((gm, bm, gn, bn), dtype=F32, device=x.device)
    chk = torch.zeros((gm, bm, gn), dtype=F32, device=x.device)
    bnd = torch.zeros_like(chk)
    for kk in range(gk):
        a, b = xb[:, :, kk, :], wb[kk]
        prod = torch.einsum("aib,bcn->aicn", a, b)
        acc += prod
        if mode == "replica":
            chk += prod.sum(-1)
            bnd += prod.abs().sum(-1)
        else:
            chk += torch.einsum("aib,bc->aic", a, b.sum(-1))
            bnd += torch.einsum("aib,bc->aic", a.abs(), b.abs().sum(-1))
    acc = acc.permute(0, 2, 1, 3).contiguous()          # (gm, gn, bm, bn)
    bi, bj, r, c, enabled, bit = (int(v) for v in fault)
    if enabled and bi < gm and bj < gn and r < bm and c < bn:
        cell = acc[bi, bj, r, c]
        acc[bi, bj, r, c] = (flip_bit(cell, bit) if bit >= 0
                             else cell + delta)
    rowsum = acc.sum(-1)                                # (gm, gn, bm)
    chk, bnd = chk.permute(0, 2, 1), bnd.permute(0, 2, 1)
    if mode == "2s":
        res = (chk.sum(-1) - rowsum.sum(-1)).abs()
        bnd = bnd.sum(-1)
    else:
        res = (chk - rowsum).abs()
    y = acc.permute(0, 2, 1, 3).reshape(gm * bm, gn * bn)[:m, :n]
    return y.to(out_dtype), res.contiguous(), bnd.contiguous()
