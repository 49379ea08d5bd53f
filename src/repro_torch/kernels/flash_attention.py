"""K3: fused-ABFT paged flash decode, the CUDA kernel
``csrc/flash_decode.cu``, and its plain PyTorch version.

Replaces the TPU kernel ``repro.kernels.flash_attention.
flash_decode_paged_kernel`` (and its dense form ``flash_decode_kernel``,
the same body through an identity block table).  The flash attention
kernel for full sequences (``flash_attention_kernel``, K2) is not on the
serving path and is not ported yet.

Shapes follow the reference's wrappers: q (B, 1, H, D) with heads stored
kv-major (kv, group); a dense cache (B, S, KV, D) or paged pools
(NB, BS, KV, D) with a (B, W) int32 block table; lengths (B,) int32.
Returns (out (B, 1, H, Dv), res_s, bnd_s, res_pv, bnd_pv), the four check
vectors of shape (B, KV, G).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library

F32 = torch.float32
NEG_INF = -1e30
KERNEL = library.Kernel("flash_decode",
                        "src/repro_torch/kernels/csrc/flash_decode.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_kernel(q, k_cache, v_cache, table, lengths, *, block: int,
                        scale: float | None = None):
    """Launch K3.  ``table is None`` selects the dense cache (identity
    table over ``block``-sized k-blocks); otherwise the pools' block size
    is ``block`` and sentinel table entries are clamped in the kernel."""
    B, _, H, D = q.shape
    dense = table is None
    KV, DV = k_cache.shape[2], v_cache.shape[3]
    tensors = [q, k_cache, v_cache, lengths] + ([] if dense else [table])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_decode_kernel takes CUDA tensors on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode_kernel takes contiguous tensors")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError("q and the cache must share f32 or bf16")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError("lengths must be (B,) int32")
    if H % KV or q.shape[1] != 1 or k_cache.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)}")
    if dense:
        S = k_cache.shape[1]
        NB, W, tstride = S, -(-S // block), 0
        if k_cache.shape[0] != B:
            raise ValueError("dense cache rows must match the batch")
    else:
        NB = k_cache.shape[0]
        if k_cache.shape[1] != block or table.dtype != torch.int32 \
                or table.shape[0] != B:
            raise ValueError("paged pools (NB, block, KV, D) need a (B, W) "
                             "int32 table")
        W, tstride = table.shape[1], table.stride(0)
    scale = scale if scale is not None else D ** -0.5
    G = H // KV
    out = torch.empty((B, 1, H, DV), dtype=q.dtype, device=q.device)
    rs, bs, rp, bp = (torch.empty((B, KV, G), dtype=F32, device=q.device)
                      for _ in range(4))
    P = library.ptr
    err = library.library("flash_decode").flash_decode_launch(
        P(q), P(k_cache), P(v_cache), P(table) if not dense else None,
        P(lengths), P(out), P(rs), P(bs), P(rp), P(bp), B, KV, G, D, DV,
        block, W, NB, int(dense), tstride, float(scale), _DTYPES[q.dtype],
        library.stream())
    library.check(err, KERNEL.name)
    KERNEL.launches += 1
    return out, rs, bs, rp, bp


def flash_decode_ref(q, k_cache, v_cache, table, lengths, *, block: int,
                     scale: float | None = None):
    """Plain version of K3 (the Pallas body's arithmetic, block by block,
    every block of the table walked as the TPU grid does)."""
    B, _, H, D = q.shape
    KV, DV = k_cache.shape[2], v_cache.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    if table is None:
        S = k_cache.shape[1]
        W = -(-S // block)
        pad = (0, 0, 0, 0, 0, W * block - S)
        kb = torch.nn.functional.pad(k_cache, pad).reshape(
            B, W, block, KV, D)
        vb = torch.nn.functional.pad(v_cache, pad).reshape(
            B, W, block, KV, DV)
    else:
        idx = table.long().clamp(0, k_cache.shape[0] - 1)
        kb, vb = k_cache[idx], v_cache[idx]       # (B, W, BS, KV, D)
        W = table.shape[1]
    dev = q.device
    qf = q[:, 0].reshape(B, KV, G, D).to(F32)
    lens = lengths.to(dev).reshape(B, 1)
    m = torch.full((B, KV, G), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, DV), dtype=F32, device=dev)
    chk, bndc, ress, bnds = (torch.zeros_like(l) for _ in range(4))
    for j in range(W):
        k = kb[:, j].to(F32)                                 # (B, T, KV, D)
        v = vb[:, j].to(F32)
        s = torch.einsum("bkgd,btkd->bkgt", qf, k) * scale
        pos = j * block + torch.arange(block, device=dev)
        vmask = (pos[None, :] < lens).to(F32)                # (B, T)
        k_sum = torch.einsum("btkd,bt->bkd", k, vmask)
        k_abs = torch.einsum("btkd,bt->bkd", k.abs(), vmask)
        chk_s = torch.einsum("bkgd,bkd->bkg", qf, k_sum) * scale
        bnd_s = torch.einsum("bkgd,bkd->bkg", qf.abs(), k_abs) * abs(scale)
        vm = vmask[:, None, None, :]
        ress = torch.maximum(ress, (chk_s - (s * vm).sum(-1)).abs())
        bnds = torch.maximum(bnds, bnd_s)
        s = torch.where(vm > 0, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        m = m_new
        acc = acc * corr[..., None] + torch.einsum("bkgt,btkv->bkgv", p, v)
        chk = chk * corr + torch.einsum("bkgt,btk->bkg", p, v.sum(-1))
        bndc = bndc * corr + torch.einsum("bkgt,btk->bkg", p,
                                          v.abs().sum(-1))
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    rp = (chk - acc.sum(-1)).abs()
    return out.reshape(B, 1, H, DV), ress, bnds, rp, bndc
