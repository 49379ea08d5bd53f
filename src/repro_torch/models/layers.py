"""Shared NN building blocks (port of ``repro.models.layers``).  Every GEMM
routes through ``protected_matmul``.  Norms, rotary embeddings and the
attention used outside the fused kernels are plain PyTorch, as the
reference computes them in XLA outside any kernel.  Params are plain
dicts of tensors; flags are 0-d bool tensors on the compute device, read
on the host once per engine step.

Tensor parallelism (``LayerCtx.tp``, the rank's ``TPGroup``): a GEMM
whose weight the sharding rules split on its output dim (``wq``/``wk``/
``wv``, ``up``/``gate``, ``in_z``/``in_x``/``in_dt``, a sliced expert
FFN's ``w_up``/``w_gate``, the head) is column-parallel, each rank
computing its columns; one split on its input dim (``wo``, ``down``,
``out_proj``, a sliced ``w_down``) is row-parallel: each rank computes its
partial product in f32, the partials are summed over the model axis in
f32 and rounded to the site's dtype once, after the sum, so the output
rounds once as the unsharded GEMM's does.  A leaf the rules replicate is
computed whole on every rank.  Whether a leaf is split is looked up by
its path below the layer (``tp_par``).

Data parallelism (``LayerCtx.dp``, the rank's data-axis ``TPGroup``):
a leaf the rules shard over ``data`` as well (FSDP, models of at least
``sharding.FSDP_THRESHOLD`` parameters) is gathered whole along its data
dim just before its GEMM and freed after it (``fsdp_view``), so the GEMM
sees the model-shard dims it sees at ``data == 1``.  A serving call runs
either the whole batch on every data rank (prefill) or, where the cache
splits its slots over ``data``, only the rank's own slots
(``LayerCtx.rows``: a split decode or verify); ``LayerCtx.cache_split``
says how the dense cache's per-slot leaves lie over the data ranks
(``CacheSplit``), which the cache writes and reads follow.  A fault's
logical row on a split call lands on the data rank that owns it, at its
local row (``dense``).

Training (``train/train_step.py``) runs each data rank's own rows of the
global batch (``LayerCtx.rows``) and differentiates through the
collectives (``distributed/collectives.py``): a column-parallel GEMM's
replicated input passes through ``copy_to_model``, so its gradient is
summed over the model axis and every rank holds a replicated
activation's whole gradient.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.analysis.markers import coverage_scope, logical_scope
from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import (
    ABFTConfig,
    protected_matmul,
    protected_matmul_batched,
)
from repro_torch.distributed.collectives import (
    TPGroup,
    all_reduce_sum,
    copy_to_model,
    fsdp_gather,
)

F32 = torch.float32
NEG_INF = -1e30

# Injection sites (static ids), as in the reference.
SITES = {
    "qkv": 0, "attn_out": 1, "mlp_up": 2, "mlp_down": 3,
    "router": 4, "expert_up": 5, "expert_down": 6,
    "lm_head": 7, "ssm_in": 8, "ssm_out": 9,
    "cross_qkv": 10, "cross_out": 11, "q_a": 12, "kv_a": 13,
}


class ModelFault(NamedTuple):
    """A single-fault campaign target inside a full model."""

    layer: int
    site: int
    spec: FaultSpec

    @staticmethod
    def none() -> "ModelFault":
        return ModelFault(layer=0, site=0, spec=FaultSpec.none())

    @staticmethod
    def at(layer: int, site: str, spec: FaultSpec) -> "ModelFault":
        return ModelFault(layer=int(layer), site=SITES[site], spec=spec)


@dataclasses.dataclass(frozen=True)
class ShardingHints:
    """The reference's layer-level sharding hints: ``dp`` the data axes
    of token dims, ``dp_size`` their product (the MoE dispatch's group
    count), ``ep`` the expert axes, ``moe_mode`` 'ep' (experts sharded) or
    'tp' (the expert FFN dim sharded).  ``constrain`` is the identity: the
    port places its data explicitly, so only ``dp_size`` changes what a
    layer computes."""

    dp: tuple = ("data",)
    dp_size: int = 1
    ep: tuple = ("model",)
    tp: str = "model"
    moe_mode: str = "ep"

    def constrain(self, x, *spec):
        return x


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """How a dense cache's per-slot leaves lie over the data ranks
    (``sharding.cache_specs``): ``kind`` ``"slot"`` (data rank r holds
    slots [lo, lo + n): every per-slot leaf, GQA's ``k``/``v``, MLA's
    ``latent``, a Mamba2 layer's state) or ``"seq"`` (fewer slots than
    data ranks: rank r holds positions [lo, lo + n) of the attention
    leaves ``k``/``v``/``latent``, and every per-slot state whole).  A
    paged pool is never split over ``data``: its cells are written whole
    by a whole-batch call and by a split call's own slots."""

    kind: str
    lo: int
    n: int

    def owns(self, idx):
        """A bool mask: which of ``idx`` (slots, or positions) the rank
        holds."""
        return (idx >= self.lo) & (idx < self.lo + self.n)

    def local(self, cells: tuple) -> tuple:
        """Dense cache cells (rows, positions: index tensors broadcast to
        one shape) cut to those the rank holds: (their local index, the
        mask of the kept cells)."""
        r, p = torch.broadcast_tensors(*cells)
        which = 0 if self.kind == "slot" else 1
        keep = self.owns((r, p)[which])
        idx = [r[keep], p[keep]]
        idx[which] = idx[which] - self.lo
        return tuple(idx), keep


@dataclasses.dataclass(frozen=True)
class LayerCtx:
    """Per-forward context: the ABFT config, the fault target, the
    current layer index (set by the stack loop), the prefix of the
    plan-facing site tags (``"enc."`` inside whisper's encoder; fault
    matching reads the site and the layer index alone, so an encoder
    layer i is hit by a fault aimed at decoder layer i), the sharding
    ``hints`` and ``tp``, this rank's place on the mesh's model axis
    (None: unsharded).  Data parallelism: ``dp``, the rank's place on the
    data axis; ``cache_split`` (``CacheSplit``, None: the dense cache is
    whole on every data rank); ``rows`` (lo, n): the call runs the
    logical slots [lo, lo + n) alone (a split decode or verify), None the
    whole batch; ``moe_groups``: the MoE dispatch's group count for this
    call, None for the hints' ``dp_size`` (a split call holds exactly one
    group, its slots, and sets 1).  ``aux_over_data``: a training
    forward whose data ranks run their own rows, so the MoE load-balance
    loss takes its means over every data rank's tokens (``moe.py``)."""

    abft: ABFTConfig = ABFTConfig()
    fault: ModelFault | None = None
    layer_idx: int | None = None
    site_prefix: str = ""
    hints: ShardingHints | None = None
    tp: TPGroup | None = None
    dp: TPGroup | None = None
    cache_split: CacheSplit | None = None
    rows: tuple | None = None
    moe_groups: int | None = None
    aux_over_data: bool = False

    def with_layer(self, idx: int) -> "LayerCtx":
        return dataclasses.replace(self, layer_idx=idx)


def _site_fault(ctx: LayerCtx, site: str) -> FaultSpec | None:
    """The context's fault if it targets this site of this layer."""
    f = ctx.fault
    if f is not None and f.spec.enabled and f.site == SITES[site] and (
            ctx.layer_idx is None or f.layer == ctx.layer_idx):
        return f.spec
    return None


def tp_par(ctx: LayerCtx, path: str, kind: str) -> str | None:
    """``kind`` ("col" or "row") when the rank's params hold a shard of
    the leaf at ``path`` below its layer (``"mixer/wq"``,
    ``"ffn/shared/down"``; ``TPGroup.sharded``), else None (unsharded, or
    replicated)."""
    return kind if ctx.tp is not None and ctx.tp.splits(path) else None


def fsdp_leaf(t, ctx: LayerCtx, path: str):
    """``t`` (the leaf at ``path``) whole along its FSDP dim: gathered
    over the data axis where the rules shard it there, else ``t``."""
    dp = ctx.dp
    if dp is None or not dp.splits(path):
        return t
    return fsdp_gather(t, dp, dp.dims[path])


class FSDPView(dict):
    """A read-only view of a layer's params whose FSDP leaves come back
    gathered (``fsdp_leaf``) each time they are read: a GEMM's weight is
    gathered as its call evaluates its arguments and freed when the call
    returns.  ``raw(key)`` reads a leaf as stored (its shape for a
    count that the data dim does not change)."""

    def __init__(self, tree: dict, ctx: LayerCtx, prefix: str = ""):
        super().__init__(tree)
        self._ctx, self._prefix = ctx, prefix

    def __getitem__(self, key):
        val = super().__getitem__(key)
        path = f"{self._prefix}{key}"
        if isinstance(val, dict):
            return FSDPView(val, self._ctx, path + "/")
        return fsdp_leaf(val, self._ctx, path)

    def get(self, key, default=None):
        return self[key] if key in self else default

    def raw(self, key):
        return super().__getitem__(key)


def fsdp_view(tree: dict, ctx: LayerCtx):
    """``tree`` (a layer's params) as an ``FSDPView`` where the context's
    data axis holds FSDP leaves, else ``tree`` itself."""
    dp = ctx.dp
    if dp is None or dp.size == 1 or not dp.sharded:
        return tree
    return FSDPView(tree, ctx)


def raw(p, key):
    """``p[key]`` as stored (no FSDP gather)."""
    return p.raw(key) if isinstance(p, FSDPView) else p[key]


def put_cells(leaf, cells: tuple, values, ctx: LayerCtx) -> None:
    """``leaf[cells] = values`` on a dense cache leaf (rows, then
    positions; index tensors broadcastable to ``values``' leading dims),
    the cells this data rank holds alone, at their local index, where a
    whole-batch call writes a split cache (``LayerCtx.cache_split``); a
    split call's cells are the rank's own already."""
    sp = ctx.cache_split
    values = values.to(leaf.dtype)
    if sp is None or ctx.rows is not None:
        leaf[cells] = values
        return
    idx, keep = sp.local(cells)
    leaf[idx] = values[keep]


def _row_fault(fault, x, w, ctx: LayerCtx, out_dtype):
    """A split call's fault on this data rank: its logical row moved to
    the rank's local one where the rank runs it, else None.  The row
    indexes the flattened (slot, position) rows of a block scheme's GEMM,
    or of a 2-D operand; on the plain and global paths a (B, L, k)
    operand's fault row is its position, in every slot (the reference's
    broadcast), and lands on every rank unchanged."""
    if fault is None or ctx.rows is None:
        return fault
    from repro_torch.core.policy import scheme_name_of
    from repro_torch.core.protected import _BLOCK_MODES, _gemm_dims

    if x.dim() > 2 and scheme_name_of(ctx.abft.resolve(
            _gemm_dims(x, w, out_dtype))) not in _BLOCK_MODES:
        return fault
    lo, n = ctx.rows
    m = x.numel() // x.shape[-1]
    row = fault.row - lo * (m // n)
    if not 0 <= row < m:
        return None
    return fault._replace(row=row)


def _col_fault(fault, ctx: LayerCtx, n: int):
    """A column-parallel site's fault on this rank: its logical column
    moved to the rank's local one where the rank owns it (``n`` columns
    from ``rank * n``), else None."""
    lo = ctx.tp.rank * n
    if fault is None or not lo <= fault.col < lo + n:
        return None
    return fault._replace(col=fault.col - lo)


def dense(x, w, ctx: LayerCtx, site: str, b=None, out_dtype=None,
          tag: str | None = None, par: str | None = None):
    """ABFT-protected ``x @ w (+ b)``.  Returns (y, flag).

    ``par`` (``tp_par``): "col", ``w`` holds this rank's columns (``x``
    through ``copy_to_model``: its gradient summed over the model axis);
    "row", its rows, and the f32 partials are summed over the model axis
    before the one rounding to ``out_dtype`` and the bias.  The scheme is
    selected with the site's ``out_dtype`` (the plan's), never the
    partial's f32.  A fault names a logical (row, col): at a "col" site it
    fires on the rank that owns the column, at its local column; at a
    "row" site on rank 0's partial only, so a value fault reaches the sum
    as it reaches the unsharded output (a bit flip there flips a bit of
    the partial, not of the sum)."""
    out_dtype = out_dtype or x.dtype
    fault = _row_fault(_site_fault(ctx, site), x, w, ctx, out_dtype)
    site = ctx.site_prefix + (tag or site)
    if par is None:
        y, chk = protected_matmul(x, w, ctx.abft, out_dtype=out_dtype,
                                  fault=fault, site=site)
    elif par == "col":
        y, chk = protected_matmul(copy_to_model(x, ctx.tp), w, ctx.abft,
                                  out_dtype=out_dtype,
                                  fault=_col_fault(fault, ctx, w.shape[-1]),
                                  site=site)
    elif par == "row":
        if ctx.tp.rank != 0:
            fault = None
        y, chk = protected_matmul(x, w, ctx.abft, out_dtype=F32,
                                  select_dtype=out_dtype, fault=fault,
                                  site=site)
        y = all_reduce_sum(y, ctx.tp).to(out_dtype)
    else:
        raise ValueError(f"par must be 'col', 'row' or None, got {par!r}")
    if b is not None:
        y = y + b.to(y.dtype)
    return y, chk.flag


def batched_dense(x_e, w_e, ctx: LayerCtx, site: str,
                  tag: str | None = None, split_rows: int | None = None,
                  par: str | None = None):
    """Per-expert protected GEMMs x_e (E, C, D) @ w_e (E, D, F) in one
    call (the reference's ``moe._batched_dense``, a ``jax.vmap`` of
    ``dense``): the scheme of one expert's GEMM, the site's fault in
    every expert; ``split_rows`` K1's (``ops.abft_matmul_batched``).
    ``par`` as ``dense``'s, over each expert's F: "col", ``w_e`` holds
    this rank's columns of every expert (the fault's column mapped to the
    owning rank's); "row", its rows, the (E, C, F) f32 partials summed
    over the model axis and rounded once, the scheme selected at x's
    dtype, the fault on rank 0's partial only; "col" passes ``x_e``
    through ``copy_to_model``.  Returns (y (E, C, F), flag: any
    expert's)."""
    fault = _site_fault(ctx, site)
    site = tag or site
    if par is None:
        return protected_matmul_batched(x_e, w_e, ctx.abft, fault=fault,
                                        site=site, split_rows=split_rows)
    if par == "col":
        return protected_matmul_batched(
            copy_to_model(x_e, ctx.tp), w_e, ctx.abft,
            fault=_col_fault(fault, ctx, w_e.shape[-1]), site=site,
            split_rows=split_rows)
    if par != "row":
        raise ValueError(f"par must be 'col', 'row' or None, got {par!r}")
    y, flag = protected_matmul_batched(
        x_e, w_e, ctx.abft, out_dtype=F32, select_dtype=x_e.dtype,
        fault=fault if ctx.tp.rank == 0 else None, site=site,
        split_rows=split_rows)
    return all_reduce_sum(y, ctx.tp).to(x_e.dtype), flag


def or_flags(*flags):
    return torch.stack(flags).any()


# ---------------------------------------------------------------- norms

def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def norm(x, p, kind: str, eps: float):
    """The config's norm: ``layernorm`` reads p["w"] and p["b"],
    ``rmsnorm`` p["w"]."""
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"], eps)
    return rms_norm(x, p["w"], eps)


def gated_rms_norm(x, z, w, eps: float = 1e-6, tp: TPGroup | None = None):
    """Mamba2's output norm: ``rms_norm(x * silu(z))``, the gate taken in
    f32 and cast to x's dtype before the product.  ``tp``: x, z and w hold
    this rank's slice of ``d_inner`` (its heads); the mean of squares is
    over the whole width, the f32 sum of squares of each rank's slice
    summed over the model axis (one collective) and divided by the full
    width.  Each rank's slice alone reads the sum, so in training its
    gradient passes ``copy_to_model``: every rank's ``x`` and ``z`` get
    the whole width's share of ``d var``."""
    gate = torch.nn.functional.silu(z.to(F32)).to(x.dtype)
    h = x * gate
    if tp is None or tp.size == 1:
        return rms_norm(h, w, eps)
    hf = h.to(F32)
    ss = copy_to_model(all_reduce_sum(
        (hf * hf).sum(dim=-1, keepdim=True), tp), tp)
    var = ss / (h.shape[-1] * tp.size)
    return (hf * torch.rsqrt(var + eps)).to(h.dtype) * w.to(h.dtype)


# ---------------------------------------------------------------- rope

def rope_tables(positions, head_dim: int, theta: float, pct: float = 1.0):
    """positions: (..., L) int -> (cos, sin, rot): cos/sin of shape
    (..., L, rot/2), where ``rot`` (the rotated leading dims of each head,
    even) is ``head_dim * pct`` rounded down to even."""
    rot = int(head_dim * pct) // 2 * 2
    dev = positions.device
    freqs = 1.0 / (torch.tensor(theta, dtype=F32, device=dev) ** (
        torch.arange(0, rot, 2, dtype=F32, device=dev) / rot))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, cos, sin, rot: int):
    """x: (B, L, H, D); split-half rotation of the first ``rot`` dims,
    the other D - rot dims pass through unrotated."""
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < x.shape[-1] else out


# ---------------------------------------------------------------- attention

def chunked_attention(q, k, v, *, causal: bool, q_offset=0, q_chunk: int = 512,
                      k_chunk: int = 1024, scale: float | None = None,
                      lengths=None, spans=None):
    """Memory-bounded attention with online softmax over query and key
    chunks (the reference's flash-style XLA path, as Python loops).
    q: (B, Lq, H, Dk); k: (B, Lk, KV, Dk); v: (B, Lk, KV, Dv); ``lengths``
    (B,) masks keys at positions >= lengths[b].  ``q_offset``: logical
    position of query 0, a scalar or a (B,) vector when each row starts at
    its own position (a prefix's suffix, a prompt chunk: row b's query t
    sits at ``q_offset[b] + t`` for the causal mask; keys are addressed
    from logical 0).  Masked keys get exactly zero weight.

    ``spans`` (the serving prefill paths): per row, on the host, its
    (``q_offset``, ``lengths``) pair, which then replace those two.  Each
    row runs alone through chunks of exactly ``q_chunk`` queries and
    ``k_chunk`` keys, the keys' chunks aligned to logical 0, so every
    product has one shape whatever the batch, the padding or the chunking
    around a row.  A query's output then depends only on its own row's
    keys and position: a prompt prefilled whole, as a suffix behind a
    shared prefix, or in chunks gets bit-identical KV and logits.  Key
    chunks that every query of a query chunk masks are skipped (an exact
    no-op), and a row with no query of its own (a padding row: keys end
    at its offset) is zeros.  Returns (B, Lq, H, Dv).

    Runs inside a ``flops[softmax]`` coverage scope: the score/PV products
    are outside the matmul-ABFT surface by design (the fused flash-ABFT
    kernels replace them with ``flash_attention=True``), and the audit
    allowlists them.  The row-wise path records its logical products, the
    reference's count, not its padded chunks."""
    with coverage_scope("softmax"):
        if spans is not None:
            B, Lq, H, Dk = q.shape
            Lk, Dv = v.shape[1], v.shape[3]
            with logical_scope("rowwise_attention",
                               ((B * Lq * H, Dk, Lk), (B * Lq * H, Lk, Dv))):
                return _rowwise_attention(q, k, v, spans, causal=causal,
                                          q_chunk=q_chunk, k_chunk=k_chunk,
                                          scale=scale)
        return _chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  q_chunk=q_chunk, k_chunk=k_chunk,
                                  scale=scale, lengths=lengths)


def _chunked_attention(q, k, v, *, causal, q_offset, q_chunk, k_chunk,
                       scale, lengths):
    """``chunked_attention`` without ``spans``: every row at once."""
    B, Lq, H, Dk = q.shape
    Lk, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else Dk ** -0.5
    qc, kc = min(q_chunk, Lq), min(k_chunk, Lk)
    nq, nk = -(-Lq // qc), -(-Lk // kc)
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, nq * qc - Lq))
    kp = pad(k, (0, 0, 0, 0, 0, nk * kc - Lk))
    vp = pad(v, (0, 0, 0, 0, 0, nk * kc - Lk))
    dev = q.device
    off = torch.as_tensor(q_offset, device=dev).long()
    off = off.reshape(-1, 1) if off.dim() else off.reshape(1, 1)  # (B|1, 1)
    outs = []
    for qi in range(nq):
        qg = qp[:, qi * qc:(qi + 1) * qc].reshape(B, qc, KV, G, Dk).to(F32)
        q_pos = off + qi * qc + torch.arange(qc, device=dev)   # (B|1, qc)
        m = torch.full((B, qc, KV, G), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, qc, KV, G), dtype=F32, device=dev)
        acc = torch.zeros((B, qc, KV, G, Dv), dtype=F32, device=dev)
        for ki in range(nk):
            kblk = kp[:, ki * kc:(ki + 1) * kc].to(F32)
            vblk = vp[:, ki * kc:(ki + 1) * kc].to(F32)
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bskd->bqkgs", qg, kblk) * scale
            mask = (k_pos[None, None, :] < Lk).expand(q_pos.shape[0], qc, kc)
            if causal:
                mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
            mask = mask[:, :, None, None, :]
            if lengths is not None:
                row_ok = k_pos[None, :] < lengths.to(dev)[:, None]
                mask = mask & row_ok[:, None, None, None, :]
            m, l, acc = _online_softmax_step(s, mask, vblk, m, l, acc)
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.reshape(B, qc, H, Dv).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Lq]


def _online_softmax_step(s, mask, vblk, m, l, acc) -> tuple:
    """Fold one key chunk's scores ``s`` (masked keys to NEG_INF, so they
    weigh exactly 0) into the running max ``m``, sum ``l`` and output
    ``acc``."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bqkgs,bskv->bqkgv", p, vblk)
    return m_new, l, acc


def _rowwise_attention(q, k, v, spans, *, causal, q_chunk, k_chunk,
                       scale):
    """``chunked_attention(spans=...)``: one row at a time, fixed chunk
    shapes (see there)."""
    B, Lq, H, Dk = q.shape
    Lk, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // KV
    scale = scale if scale is not None else Dk ** -0.5
    qc, kc = q_chunk, k_chunk
    nq, nk = -(-Lq // qc), -(-Lk // kc)
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, nq * qc - Lq))
    kp = pad(k, (0, 0, 0, 0, 0, nk * kc - Lk))
    vp = pad(v, (0, 0, 0, 0, 0, nk * kc - Lk))
    dev = q.device
    ar_q = torch.arange(qc, device=dev)
    ar_k = torch.arange(kc, device=dev)
    rows = []
    for b, (off, n_valid) in enumerate(spans):
        n_valid = min(int(n_valid), Lk)
        if n_valid <= off:
            rows.append(torch.zeros((1, Lq, H, Dv), dtype=q.dtype,
                                    device=dev))
            continue
        outs = []
        for qi in range(nq):
            qg = qp[b:b + 1, qi * qc:(qi + 1) * qc].reshape(
                1, qc, KV, G, Dk).to(F32)
            q0 = int(off) + qi * qc
            q_pos = q0 + ar_q
            last = min(n_valid, q0 + qc) if causal else n_valid
            m = torch.full((1, qc, KV, G), NEG_INF, dtype=F32, device=dev)
            l = torch.zeros((1, qc, KV, G), dtype=F32, device=dev)
            acc = torch.zeros((1, qc, KV, G, Dv), dtype=F32, device=dev)
            for ki in range(max(1, -(-last // kc))):
                kblk = kp[b:b + 1, ki * kc:(ki + 1) * kc].to(F32)
                vblk = vp[b:b + 1, ki * kc:(ki + 1) * kc].to(F32)
                k_pos = ki * kc + ar_k
                s = torch.einsum("bqkgd,bskd->bqkgs", qg, kblk) * scale
                mask = (k_pos < n_valid)[None, :].expand(qc, kc)
                if causal:
                    mask = mask & (q_pos[:, None] >= k_pos[None, :])
                m, l, acc = _online_softmax_step(
                    s, mask[None, :, None, None, :], vblk, m, l, acc)
            out = acc / l.clamp_min(1e-30)[..., None]
            outs.append(out.reshape(1, qc, H, Dv).to(q.dtype))
        rows.append(torch.cat(outs, dim=1)[:, :Lq])
    return torch.cat(rows, dim=0)


def decode_attention(q, k_cache, v_cache, length, scale=None,
                     return_lse: bool = False):
    """Single-token attention against a (B, S, KV, D) cache.
    q: (B, 1, H, Dk); ``length``: (B,) valid positions.  Returns
    (B, 1, H, Dv), and with ``return_lse`` also the (B, KV, G) f32
    log-sum-exp of each head's scaled scores over its valid keys (a
    sequence shard's partial: a row with no valid key gives -inf and a
    zero output).  Runs inside a ``flops[softmax]`` coverage scope (see
    ``chunked_attention``): ``flash_decode`` is the fused-ABFT
    replacement."""
    with coverage_scope("softmax"):
        return _decode_core(q, k_cache.to(F32), v_cache.to(F32),
                            v_cache.dtype, length.to(q.device), scale,
                            return_lse)


def _decode_core(q, kf, vf, v_dtype, length, scale, return_lse=False):
    """``decode_attention`` on caches already widened to f32 (``v_dtype``:
    the cache's own type, which the probabilities round through)."""
    B, _, H, Dk = q.shape
    S, KV, Dv = kf.shape[1], kf.shape[2], vf.shape[3]
    G = H // KV
    scale = scale if scale is not None else Dk ** -0.5
    qg = q.reshape(B, KV, G, Dk).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < length.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskv->bkgv", p.to(v_dtype).to(F32), vf)
    out = out.reshape(B, 1, H, Dv).to(q.dtype)
    if not return_lse:
        return out
    some = (length.reshape(-1) > 0)
    lse = torch.where(some[:, None, None], torch.logsumexp(s, dim=-1),
                      torch.full((), float("-inf"), device=q.device))
    out = torch.where(some[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=q.device))
    return out, lse


def verify_attention(q, k_cache, v_cache, length, scale=None):
    """Speculative-verify attention: T consecutive queries a row against a
    (B, S, KV, D) cache.  q: (B, T, H, Dk); row b's query t sits at
    logical position ``length[b] - 1 + t`` and attends ``length[b] + t``
    positions (``length`` is what ``decode_attention`` gets for the first
    query).  Returns (B, T, H, Dv).

    Each query runs through ``decode_attention``'s own ops at its shapes,
    one step t at a time (the caches widened once), so row t is bit for
    bit what decode computes at that position on any device: a batched
    product over T * G query rows would let the library pick another
    kernel, and another summation order, than decode's G rows.  T = 1 is
    ``decode_attention`` exactly.  A ``flops[softmax]`` region, as
    decode's."""
    with coverage_scope("softmax"):
        kf, vf = k_cache.to(F32), v_cache.to(F32)
        length = length.to(q.device)
        return torch.cat([
            _decode_core(q[:, t:t + 1].contiguous(), kf, vf, v_cache.dtype,
                         length + t, scale) for t in range(q.shape[1])],
            dim=1)


def per_step(fn, x, *args, **kw):
    """``fn`` applied to each step ``x[:, t:t+1]`` of a (B, T, ...)
    tensor, made contiguous as decode's own (B, 1, ...) input is, and the
    results concatenated along dim 1.  A verify step runs its d_model
    norms this way: the library sizes a row reduction's thread block by
    the row count, so on the card B rows and B * T rows sum a row of 2048
    or 5120 in different orders when B < 16.  The q/k norms over the head
    dim (128) give decode's sums batched, and stay batched."""
    if x.shape[1] == 1:
        return fn(x, *args, **kw)
    return torch.cat([fn(x[:, t:t + 1].contiguous(), *args, **kw)
                      for t in range(x.shape[1])], dim=1)


# ---------------------------------------------------------------- mlp

def mlp(x, p, ctx: LayerCtx, act: str = "silu",
        tags: tuple = ("mlp.up", "mlp.down"), path: str = "ffn"):
    """SwiGLU (``silu``) or plain GELU MLP; its GEMMs are ABFT-protected.
    The GELU branch (whisper) is ``up`` with its bias ``up_b``, GELU in
    f32 cast back to x's dtype, then ``down`` with ``down_b``; its GELU is
    the tanh approximation, ``jax.nn.gelu``'s default.  ``path``: where
    ``p`` sits below its layer (``"ffn"``, or ``"ffn/shared"`` for an MoE
    layer's shared experts), which ``tp_par`` reads."""
    up_tag, down_tag = tags
    col = tp_par(ctx, f"{path}/up", "col")
    row = tp_par(ctx, f"{path}/down", "row")
    if act == "silu":
        up, f1 = dense(x, p["up"], ctx, "mlp_up", tag=up_tag, par=col)
        gate, f2 = dense(x, p["gate"], ctx, "mlp_up", tag=up_tag, par=col)
        h = torch.nn.functional.silu(gate.to(F32)).to(x.dtype) * up
        flags = [f1, f2]
    else:
        h, f1 = dense(x, p["up"], ctx, "mlp_up", b=p.get("up_b"),
                      tag=up_tag, par=col)
        h = gelu(h.to(F32)).to(x.dtype)
        flags = [f1]
    out, f3 = dense(h, p["down"], ctx, "mlp_down", b=p.get("down_b"),
                    tag=down_tag, par=row)
    return out, or_flags(*flags, f3)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation (the exact erf
    form differs by up to about 1e-3)."""
    return torch.nn.functional.gelu(x, approximate="tanh")
