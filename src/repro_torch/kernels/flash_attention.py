"""K2 and K3: fused-ABFT flash attention over a full sequence
(``csrc/flash_attention.cu``) and paged flash decode
(``csrc/flash_decode.cu``), the CUDA kernels and their plain PyTorch
versions.

K2 replaces the TPU kernel ``repro.kernels.flash_attention.
flash_attention_kernel`` (body ``_kernel``): causal or non-causal
attention with the two fused checks and the ``(6,)`` delta fault on the
output accumulator.  bf16 runs on the tensor cores, f32 on the CUDA cores
(``tc_path`` decides before the launch).  q (B, Lq, H, D) and k/v (B, Lk, KV, D[v]) are read in
place through their strides (query head h on kv head h // G); the padded
lengths ``Lq_pad``/``Lk_pad`` (block multiples) are what the reference
pads to, and rows/keys past the true lengths count as zeros.  Returns
(o (B, Lq, H, Dv), res_s, bnd_s, res_pv, bnd_pv), the check arrays of
shape (B, H, gq, bq) as the reference's vmapped kernel returns them.

K3 replaces ``flash_decode_paged_kernel`` (and its dense form
``flash_decode_kernel``, the same body through an identity block table).
Shapes follow the reference's wrappers: q (B, 1, H, D) with heads stored
kv-major (kv, group); a dense cache (B, S, KV, D) or paged pools
(NB, BS, KV, D) with a (B, W) int32 block table; lengths (B,) int32.
Returns (out (B, 1, H, Dv), res_s, bnd_s, res_pv, bnd_pv), the four check
vectors of shape (B, KV, G), and on request (``lse=True``) the (B, KV, G)
f32 log-sum-exp of each head's scaled scores over the row's valid keys,
m + log(l) of the merged state (-inf, with a zero output, for a row of
no valid key): a sequence shard's partial, which the data ranks merge
(``collectives.lse_combine``).  The kernel splits each row's block walk
over ``decode_splits`` CTAs and merges them (flash decoding);
``flash_decode_split_ref`` is that split and merge in plain PyTorch,
``flash_decode_ref`` the sequential walk.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library

F32 = torch.float32
NEG_INF = -1e30
KERNEL = library.Kernel("flash_decode",
                        "src/repro_torch/kernels/csrc/flash_decode.cu")
FULL_KERNEL = library.Kernel(
    "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128       # K2 keeps a 4 x 8 register tile over <= 128 cols
MAX_BK = 128
_SMS = 132               # H100 SXM streaming multiprocessors
DECODE_HEADS = 8         # query heads a K3 CTA holds at most
MAX_SPLITS = 64          # K3's split merge stages the splits' stats
_SMEM_MAX = 232448       # shared memory a CTA may use on the H100 (bytes)
_TICKETS: dict = {}      # (device, stream, capture) -> K3's split tickets


def decode_splits(B: int, KV: int, W: int, T: int, G: int = 1) -> int:
    """K3's split count for B rows x KV kv heads (of G query heads each:
    ceil(G / 8) CTAs a kv head) over a table of W blocks of T keys: at
    most one wave of CTAs over the SMs (a CTA is 8 warps and takes an SM's
    registers: two waves of 4-warp CTAs), each split a run of whole blocks
    (the score check's partition) of at least 32 keys (two 16-key warp
    chunks).  It reads shapes only, never the lengths: the launch shape is
    fixed (a CUDA graph can capture it) and a retry runs the same split."""
    ctas = B * KV * -(-G // DECODE_HEADS)
    want = min(MAX_SPLITS, max(1, _SMS // ctas))
    per = max(-(-W // want), -(-32 // T))
    return -(-W // per)


def _decode_units_ok(d: int, esz: int) -> bool:
    """K3 reads a row in whole 16-byte units, at most 32 of them."""
    return d * esz % 16 == 0 and 16 <= d * esz <= 512


def _tickets(lib, device, n: int) -> torch.Tensor:
    """The tickets (one int32 a row, kv head and head group) that elect
    the CTA merging the splits; every launch leaves them zero.  One buffer
    a (device, stream, graph capture), grown as needed.  Eager launches
    on a stream are ordered, so no two draw tickets at once, and an
    outgrown buffer goes back to the allocator, which hands it out on that
    stream only after them.  The launches captured in one CUDA graph share
    a buffer of that graph's own, taken from its pool and zeroed by its
    own node before the first of them: every replay starts from zero, and
    no eager launch or other graph shares its tickets (two replays of one
    graph must not run at once, as for any graph)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    capture = (lib.flash_decode_capture_id(stream)
               if torch.cuda.is_current_stream_capturing() else 0)
    key = (device, stream, capture)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def tc_path(q, k, v, bk: int) -> bool:
    """K2's route: the tensor-core kernel takes bf16 q/k/v whose head dims
    and k block ``bk`` are multiples of 8 and whose rows (every batch,
    position and head stride) and base pointers are 16-byte aligned, so
    that each 16-byte chunk of a row lands by one cp.async.  Everything
    else — f32 (TF32 stays off), or bf16 that breaks an alignment term —
    runs on the CUDA-core kernel."""
    return (q.dtype == torch.bfloat16
            and all(t.dtype == torch.bfloat16 for t in (k, v))
            and q.shape[3] % 8 == 0 and v.shape[3] % 8 == 0 and bk % 8 == 0
            and all(t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                                   for s in t.stride()[:3])
                    for t in (q, k, v)))


def f32_bits(x: float) -> int:
    """The int32 whose bits are the f32 ``x`` (the reference's fault
    vector carries the delta so)."""
    return int(torch.tensor(x, dtype=F32).view(torch.int32).item())


def flash_attention_kernel(q, k, v, fault=(0, 0, 0, 0, 0, 0), *, bq: int,
                           bk: int, causal: bool, lq_pad: int, lk_pad: int,
                           scale: float | None = None):
    """Launch K2.  ``fault`` is the reference's (6,) int vector
    [q_block, 0, row, col, enabled, delta_bits]; ``bq``/``bk`` are the
    logical blocks and ``lq_pad``/``lk_pad`` their multiples that the
    reference pads q and k/v to.  ``tc_path`` picks the kernel."""
    B, Lq, H, D = q.shape
    Lk, KV, DV = k.shape[1], k.shape[2], v.shape[3]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_kernel takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share f32 or bf16")
    if (k.dim() != 4 or v.dim() != 4 or k.shape[0] != B or v.shape[0] != B
            or v.shape[1] != Lk or v.shape[2] != KV or k.shape[3] != D
            or H % KV):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride in the head dim")
    if D > MAX_HEAD_DIM or DV > MAX_HEAD_DIM or not 0 < bk <= MAX_BK \
            or bq <= 0 or lq_pad % bq or lk_pad % bk or lq_pad < Lq \
            or lk_pad < Lk:
        raise ValueError(f"unsupported blocks/dims: D={D} Dv={DV} bq={bq} "
                         f"bk={bk} pads=({lq_pad}, {lk_pad})")
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    out = torch.empty((B, Lq, H, DV), dtype=q.dtype, device=dev)
    gq = lq_pad // bq
    rs, bs, rp, bp = (torch.empty((B, H, gq, bq), dtype=F32, device=dev)
                      for _ in range(4))
    fq, _, frow, fcol, fen, fbits = (int(x) for x in fault)
    P = library.ptr
    lib = library.library("flash_attention")
    launch = lib.flash_attention_tc_launch if tc_path(q, k, v, bk) \
        else lib.flash_attention_launch
    err = launch(
        P(q), P(k), P(v), P(out), P(rs), P(bs), P(rp), P(bp), B, H, KV, Lq,
        Lk, lq_pad, lk_pad, D, DV, bq, bk, int(causal), q.stride(0),
        q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), fq, frow, fcol,
        fen, fbits, _DTYPES[q.dtype], library.stream())
    library.check(err, FULL_KERNEL.name)
    FULL_KERNEL.launches += 1
    return out, rs, bs, rp, bp


def flash_attention_ref(q, k, v, fault=(0, 0, 0, 0, 0, 0), *, bq: int,
                        bk: int, causal: bool, lq_pad: int, lk_pad: int,
                        scale: float | None = None):
    """Plain version of K2: the Pallas body's arithmetic on the zero-padded
    operands, all (batch, head, q block) programs at once, one k block at
    a time in order as the TPU grid walks them."""
    B, Lq, H, D = q.shape
    Lk, KV, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    gq, gk = lq_pad // bq, lk_pad // bk
    dev = q.device
    pad = torch.nn.functional.pad
    qf = pad(q.to(F32), (0, 0, 0, 0, 0, lq_pad - Lq))
    kf = pad(k.to(F32), (0, 0, 0, 0, 0, lk_pad - Lk))
    vf = pad(v.to(F32), (0, 0, 0, 0, 0, lk_pad - Lk))
    qf = qf.permute(0, 2, 1, 3).reshape(B, H, gq, bq, D)
    kf = kf.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)   # (B,H,Lk,D)
    vf = vf.repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    m = torch.full((B, H, gq, bq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, gq, bq, DV), dtype=F32, device=dev)
    chk, bndc, ress, bnds = (torch.zeros_like(m) for _ in range(4))
    q_pos = torch.arange(lq_pad, device=dev).reshape(gq, bq, 1)
    for j in range(gk):
        kb = kf[:, :, j * bk:(j + 1) * bk]
        vb = vf[:, :, j * bk:(j + 1) * bk]
        s = torch.einsum("bhiqd,bhkd->bhiqk", qf, kb) * scale
        k_sum, k_abs = kb.sum(2), kb.abs().sum(2)              # (B, H, D)
        chk_s = torch.einsum("bhiqd,bhd->bhiq", qf, k_sum) * scale
        bnd_s = torch.einsum("bhiqd,bhd->bhiq", qf.abs(), k_abs) * abs(scale)
        ress = torch.maximum(ress, (chk_s - s.sum(-1)).abs())
        bnds = torch.maximum(bnds, bnd_s)
        if causal:
            k_pos = j * bk + torch.arange(bk, device=dev)
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        m = m_new
        acc = acc * corr[..., None] + torch.einsum("bhiqk,bhkv->bhiqv", p, vb)
        chk = chk * corr + torch.einsum("bhiqk,bhk->bhiq", p, vb.sum(-1))
        bndc = bndc * corr + torch.einsum("bhiqk,bhk->bhiq", p,
                                          vb.abs().sum(-1))
    fq, _, frow, fcol, fen, fbits = (int(x) for x in fault)
    if fen == 1 and 0 <= fq < gq and 0 <= frow < bq and 0 <= fcol < DV:
        delta = torch.tensor(fbits, dtype=torch.int32).view(F32).item()
        acc[:, :, fq, frow, fcol] += delta
    o = acc / l.clamp_min(1e-30)[..., None]
    o = o.reshape(B, H, lq_pad, DV).permute(0, 2, 1, 3)[:, :Lq]
    rp = (chk - acc.sum(-1)).abs()
    return o.to(q.dtype), ress, bnds, rp, bndc


def flash_decode_kernel(q, k_cache, v_cache, table, lengths, *, block: int,
                        scale: float | None = None,
                        splits: int | None = None, lse: bool = False):
    """Launch K3.  ``table is None`` selects the dense cache (identity
    table over ``block``-sized k-blocks); otherwise the pools' block size
    is ``block`` and sentinel table entries are clamped in the kernel.
    ``splits`` CTAs walk each row (``decode_splits`` unless forced, to
    time one count against another; 1 is the single-CTA walk); a count
    outside 1..min(W, 64) raises.  Rows of q, K and V are read in whole
    16-byte units, at most 32 of them; any G = H / KV (at most 8 heads a
    CTA).  ``lse``: also return the rows' log-sum-exps (module
    docstring)."""
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
    esz = q.element_size()
    lib = library.library("flash_decode")
    if not (_decode_units_ok(D, esz) and _decode_units_ok(DV, esz)) \
            or lib.flash_decode_smem_bytes(G, D, DV, esz) > _SMEM_MAX:
        raise ValueError(f"K3 takes rows of 1 to 32 16-byte units: D={D} "
                         f"Dv={DV} {q.dtype}")
    if splits is None:
        splits = decode_splits(B, KV, W, block, G)
    if not 1 <= splits <= min(W, MAX_SPLITS):
        raise ValueError(f"splits={splits} outside 1..{min(W, MAX_SPLITS)}"
                         f" (the table's {W} blocks, at most {MAX_SPLITS})")
    per = -(-W // splits)
    dev = q.device
    out = torch.empty((B, 1, H, DV), dtype=q.dtype, device=dev)
    rs, bs, rp, bp = (torch.empty((B, KV, G), dtype=F32, device=dev)
                      for _ in range(4))
    lse_out = (torch.empty((B, KV, G), dtype=F32, device=dev) if lse
               else None)
    scratch = torch.empty((lib.flash_decode_scratch_floats(
        B, KV, G, DV, esz, splits),), dtype=F32, device=dev)
    tickets = (_tickets(lib, dev, B * KV * -(-G // DECODE_HEADS))
               if splits > 1 else None)
    P = library.ptr
    err = lib.flash_decode_launch(
        P(q), P(k_cache), P(v_cache), P(table) if not dense else None,
        P(lengths), P(out), P(rs), P(bs), P(rp), P(bp), P(scratch),
        P(tickets) if tickets is not None else None,
        P(lse_out) if lse else None, B, KV, G, D, DV, block, W, NB,
        int(dense), splits, per, tstride, float(scale), _DTYPES[q.dtype],
        library.stream())
    library.check(err, KERNEL.name)
    KERNEL.launches += 1
    return (out, rs, bs, rp, bp) + ((lse_out,) if lse else ())


def _decode_blocks(q, k_cache, v_cache, table, block: int):
    """The plain versions' view of the cache: per row, W blocks of
    ``block`` keys (B, W, block, KV, D[v]), gathered through the clamped
    table for pools, zero-padded for a dense cache."""
    B = q.shape[0]
    KV, D, DV = k_cache.shape[2], k_cache.shape[3], v_cache.shape[3]
    if table is None:
        S = k_cache.shape[1]
        W = -(-S // block)
        pad = (0, 0, 0, 0, 0, W * block - S)
        kb = torch.nn.functional.pad(k_cache, pad).reshape(
            B, W, block, KV, D)
        vb = torch.nn.functional.pad(v_cache, pad).reshape(
            B, W, block, KV, DV)
        return kb, vb
    idx = table.long().clamp(0, k_cache.shape[0] - 1)
    return k_cache[idx], v_cache[idx]             # (B, W, BS, KV, D)


def _decode_walk(qf, kb, vb, lens, block: int, j_lo: int, j_hi: int,
                 scale: float):
    """The Pallas body's arithmetic over blocks j_lo .. j_hi - 1 of every
    row, one block at a time as the TPU grid walks them.  Returns the
    online-softmax state (m, l, acc, chk, bndc, ress, bnds).  p is masked
    to the valid keys, so a walk whose keys all lie past the length keeps
    l = 0 and acc = 0 (m stays at the finite sentinel)."""
    B, KV, G, _ = qf.shape
    DV = vb.shape[-1]
    dev = qf.device
    m = torch.full((B, KV, G), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, DV), dtype=F32, device=dev)
    chk, bndc, ress, bnds = (torch.zeros_like(l) for _ in range(4))
    for j in range(j_lo, j_hi):
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
        p = torch.where(vm > 0, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        m = m_new
        acc = acc * corr[..., None] + torch.einsum("bkgt,btkv->bkgv", p, v)
        chk = chk * corr + torch.einsum("bkgt,btk->bkg", p, v.sum(-1))
        bndc = bndc * corr + torch.einsum("bkgt,btk->bkg", p,
                                          v.abs().sum(-1))
    return m, l, acc, chk, bndc, ress, bnds


def _decode_finish(q, m, acc, l, chk, bndc, ress, bnds, lse: bool):
    B, _, H, _ = q.shape
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    rp = (chk - acc.sum(-1)).abs()
    res = (out.reshape(B, 1, H, acc.shape[-1]), ress, bnds, rp, bndc)
    if not lse:
        return res
    neg = torch.full((), float("-inf"), dtype=F32, device=q.device)
    return res + (torch.where(l > 0, m + torch.log(l), neg),)


def _decode_inputs(q, k_cache, v_cache, table, lengths, block, scale):
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    kb, vb = _decode_blocks(q, k_cache, v_cache, table, block)
    qf = q[:, 0].reshape(B, KV, H // KV, D).to(F32)
    lens = lengths.to(q.device).reshape(B, 1)
    return qf, kb, vb, lens, scale


def flash_decode_ref(q, k_cache, v_cache, table, lengths, *, block: int,
                     scale: float | None = None, lse: bool = False):
    """Plain version of K3 (the Pallas body's arithmetic, block by block,
    every block of the table walked as the TPU grid does); ``lse`` as
    the kernel's."""
    qf, kb, vb, lens, scale = _decode_inputs(q, k_cache, v_cache, table,
                                             lengths, block, scale)
    m, l, acc, chk, bndc, ress, bnds = _decode_walk(
        qf, kb, vb, lens, block, 0, kb.shape[1], scale)
    return _decode_finish(q, m, acc, l, chk, bndc, ress, bnds, lse)


def flash_decode_split_ref(q, k_cache, v_cache, table, lengths, *,
                           block: int, splits: int,
                           scale: float | None = None, lse: bool = False):
    """Plain version of K3's split walk and merge: split s walks blocks
    [s * per, (s + 1) * per) with per = ceil(W / splits), from a fresh
    state; the splits merge in order: m = max m_s, w_s = exp(m_s - m), l,
    acc, chk and bndc the w_s-weighted sums, the score residual and bound
    maxima; then o = acc / l and the PV residual |chk - rowsum(acc)|.
    Used by the tests only."""
    qf, kb, vb, lens, scale = _decode_inputs(q, k_cache, v_cache, table,
                                             lengths, block, scale)
    W = kb.shape[1]
    if not 1 <= splits <= W:
        raise ValueError(f"splits={splits} outside 1..{W}")
    per = -(-W // splits)
    parts = [_decode_walk(qf, kb, vb, lens, block, s * per,
                          min((s + 1) * per, W), scale)
             for s in range(splits)]
    m = torch.stack([p[0] for p in parts]).amax(0)
    wts = [torch.exp(p[0] - m) for p in parts]
    l = sum(w * p[1] for w, p in zip(wts, parts))
    acc = sum(w[..., None] * p[2] for w, p in zip(wts, parts))
    chk = sum(w * p[3] for w, p in zip(wts, parts))
    bndc = sum(w * p[4] for w, p in zip(wts, parts))
    ress = torch.stack([p[5] for p in parts]).amax(0)
    bnds = torch.stack([p[6] for p in parts]).amax(0)
    return _decode_finish(q, m, acc, l, chk, bndc, ress, bnds, lse)
