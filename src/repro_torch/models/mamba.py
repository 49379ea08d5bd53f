"""Mamba2 mixer: the SSD (state-space duality) block, chunked (port of
``repro.models.mamba``).

The SSD algorithm (Dao & Gu, arXiv:2405.21060) splits the selective scan
into intra-chunk products (quadratic within a chunk) and a sequential
recurrence over chunks.  The four input projections and the output
projection are ABFT-protected GEMMs (sites ``ssm_in`` and ``ssm_out``);
the scan, the depthwise causal conv and the decode step's state update are
data-data products outside ABFT, plain PyTorch here as they are plain XLA
in the reference (its ``coverage_scope("ssm_scan")``).

The reference's three-operand einsums are written as one elementwise step
followed by one batched contraction each, so the contraction order, and
with it the size of every intermediate, is fixed: at jamba's widths the
worst order torch could pick would materialise a (B, c, Q, S, H, P)
product of gigabytes.

Under tensor parallelism (``LayerCtx.tp``) the rank runs its heads:
``in_z``, ``in_x`` and ``in_dt`` column-parallel, ``in_bc`` (one group's
B and C) replicated (in training B and C pass ``copy_to_model`` before
the scan, which reads them with the rank's heads only), the conv, the
SSD scan and the decode recurrence on the rank's channels and heads
alone, the gated norm's mean of squares
over the whole ``d_inner`` (``layers.gated_rms_norm(tp=)``) and
``out_proj`` row-parallel.  Head and channel counts are read off the
shard's leaves (``A_log``, ``in_x``), never ``cfg.ssm_heads``/
``cfg.d_inner``; the cache's ``conv_x`` and ``ssm`` leaves hold the
rank's channels and heads (``sharding.cache_specs``).  Over the data axis
a slot-sharded state holds the rank's slots: a prefill run whole on
every data rank writes the rows the rank holds, a split decode steps
them alone.

Decode carries a constant-size state a slot: the conv windows ``conv_x``
(B, W-1, d_inner) and ``conv_bc`` (B, W-1, 2N) in the cache dtype and the
SSD state ``ssm`` (B, H, P, N) in f32.  Prefill overwrites its slots' state
without reading it, in place; ``mamba_decode`` reads the state and returns
the next one in new tensors, leaving the cache as it was, so the serving
engine commits it only once the step's flag reads back clean and a retry
starts from the pre-step state, as the reference's functional cache does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.analysis.markers import coverage_scope
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import copy_to_model
from repro_torch.models.layers import (
    LayerCtx,
    dense,
    gated_rms_norm,
    or_flags,
    tp_par,
)

F32 = torch.float32
# leaves kept in f32 whatever the model's dtype, as the reference keeps them
F32_LEAVES = ("A_log", "D", "dt_bias")


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def init_mamba(cfg: ModelConfig, w, vec) -> dict:
    """The mixer's params from the model's leaf makers (``w(*shape,
    scale=)`` a seeded weight, ``vec(n, fill, dtype=)`` a constant vector),
    stored split as the reference's: projections ``in_z``/``in_x`` (D,
    d_inner), ``in_bc`` (D, 2N), ``in_dt`` (D, H) and ``out_proj`` (d_inner,
    D) at N(0, 0.02); conv weights (W, C) at N(0, 0.5) with zero biases;
    ``A_log`` 0 (A = -1), ``D`` 1 and ``dt_bias`` -4 in f32; a unit
    ``out_norm``."""
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv_width
    return {
        "in_z": w(cfg.d_model, d_in), "in_x": w(cfg.d_model, d_in),
        "in_bc": w(cfg.d_model, 2 * n), "in_dt": w(cfg.d_model, h),
        "conv_x_w": w(W, d_in, scale=0.5), "conv_x_b": vec(d_in, 0.0),
        "conv_bc_w": w(W, 2 * n, scale=0.5), "conv_bc_b": vec(2 * n, 0.0),
        "A_log": vec(h, 0.0, dtype=F32), "D": vec(h, 1.0, dtype=F32),
        "dt_bias": vec(h, -4.0, dtype=F32),
        "out_norm": vec(d_in, 1.0), "out_proj": w(d_in, cfg.d_model),
    }


def _project_in(x, p, cfg: ModelConfig, ctx: LayerCtx):
    """The four input projections; returns (z, xs, Bm, Cm, dt, flag)."""
    n = cfg.ssm_state
    z, f1 = dense(x, p["in_z"], ctx, "ssm_in", tag="ssm.in_z",
                  par=tp_par(ctx, "mixer/in_z", "col"))
    xs, f2 = dense(x, p["in_x"], ctx, "ssm_in", tag="ssm.in_x",
                   par=tp_par(ctx, "mixer/in_x", "col"))
    bc, f3 = dense(x, p["in_bc"], ctx, "ssm_in", tag="ssm.in_bc")
    dt, f4 = dense(x, p["in_dt"], ctx, "ssm_in", tag="ssm.in_dt",
                   par=tp_par(ctx, "mixer/in_dt", "col"))
    return z, xs, bc[..., :n], bc[..., n:], dt, or_flags(f1, f2, f3, f4)


def _causal_conv(u, w, b):
    """Depthwise causal conv of width W, summed in f32 tap by tap in the
    reference's order.  u: (B, L, C); w: (W, C)."""
    W, L = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros(u.shape, dtype=F32, device=u.device)
    for i in range(W):
        out = out + pad[:, i:i + L].to(F32) * w[i].to(F32)
    return F.silu(out + b.to(F32)).to(u.dtype)


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.  xh: (B, L, H, P); dt: (B, L, H) (after
    softplus); A: (H,) negative; Bm/Cm: (B, L, N) (one group).  Returns y
    (B, L, H, P) f32 and the final state (B, H, P, N) f32.  L is padded to
    a multiple of the chunk Q = min(chunk, L); padded steps have dt = 0,
    so they neither decay nor feed the state.  Its products are
    weight-free data-data contractions outside the matmul-ABFT surface:
    a ``flops[ssm_scan]`` region, a known gap of the coverage audit."""
    with coverage_scope("ssm_scan"):
        return _ssd_scan(xh, dt, A, Bm, Cm, chunk)


def _ssd_scan(xh, dt, A, Bm, Cm, chunk: int):
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = -L % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // Q
    xc = xh.reshape(Bsz, nc, Q, H, P).to(F32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(F32)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(F32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(F32)

    cs = torch.cumsum(dtc * A, dim=2)                  # (B, c, Q, H)
    cs_end = cs[:, :, -1:, :]                          # (B, c, 1, H)
    # intra-chunk: L_mat[q, s] = exp(cs_q - cs_s) for q >= s
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, c, Q, S, H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    L_mat = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=F32, device=xh.device))
    scores = Cc @ Bc.transpose(-1, -2)                 # (B, c, Q, S)
    xdt = xc * dtc[..., None]                          # (B, c, S, H, P)
    # y_diag[q, h, p] = sum_s scores[q, s] L_mat[q, s, h] xdt[s, h, p]
    m = (scores[..., None] * L_mat).permute(0, 1, 4, 2, 3)   # (B,c,H,Q,S)
    y_diag = (m @ xdt.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # each chunk's contribution to the state, and its decay
    decay_out = torch.exp(cs_end - cs)                 # (B, c, S, H)
    xw = (xdt * decay_out[..., None]).permute(0, 1, 3, 4, 2)  # (B,c,H,P,S)
    states = xw @ Bc[:, :, None]                       # (B, c, H, P, N)
    chunk_decay = torch.exp(cs_end[:, :, 0, :])        # (B, c, H)

    # inter-chunk recurrence, one chunk at a time
    S = torch.zeros((Bsz, H, P, N), dtype=F32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + states[:, c]
    S_prevs = torch.stack(prevs, dim=1)                # (B, c, H, P, N)

    # y_off[q, h, p] = exp(cs[q, h]) sum_n Cc[q, n] S_prev[h, p, n]
    y_off = (Cc[:, :, None] @ S_prevs.transpose(-1, -2))     # (B,c,H,Q,P)
    y_off = y_off.permute(0, 1, 3, 2, 4) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)[:, :L]
    return y, S


def _mix_out(y, xh, z, x, p, cfg: ModelConfig, ctx: LayerCtx):
    """Skip term ``D * x``, the gated norm and the output projection."""
    y = y + p["D"][:, None] * xh.to(F32)
    y = y.reshape(*x.shape[:-1], p["out_norm"].shape[0]).to(x.dtype)
    row = tp_par(ctx, "mixer/out_proj", "row")
    y = gated_rms_norm(y, z, p["out_norm"], cfg.norm_eps,
                       tp=ctx.tp if row is not None else None)
    return dense(y, p["out_proj"], ctx, "ssm_out", tag="ssm.out", par=row)


def _heads_tp(ctx: LayerCtx):
    """The model-axis group where the rank holds a shard of the SSD heads
    (the rules split ``in_x``), else None."""
    return ctx.tp if tp_par(ctx, "mixer/in_x", "col") is not None else None


def _ssm_inputs(xs, bc_in, dt, p, cfg: ModelConfig, valid=None, tp=None):
    """The conv'd x, B and C, softplus(dt + bias) (zeroed where ``valid``
    is False) and A, for the scan.  B and C are replicated and read by
    the rank's heads alone: in training they reach the scan through
    ``copy_to_model`` (``tp``), so ``in_bc``, ``conv_bc_*`` and the
    residual stream get whole gradients."""
    n = cfg.ssm_state
    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc = copy_to_model(_causal_conv(bc_in, p["conv_bc_w"], p["conv_bc_b"]),
                       tp)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    if valid is not None:
        dt = dt * valid.to(F32)[..., None]
    A = -torch.exp(p["A_log"])
    Bsz, L = xs.shape[:2]
    xh = xs.reshape(Bsz, L, p["A_log"].shape[0], -1)
    return xh, bc[..., :n], bc[..., n:], dt, A


def mamba_forward(x, p, cfg: ModelConfig, ctx: LayerCtx):
    """Full-sequence mixer (training and scoring).  x: (B, L, D) ->
    (out (B, L, D), flag)."""
    z, xs, Bm, Cm, dt, f1 = _project_in(x, p, cfg, ctx)
    xh, Bm, Cm, dt, A = _ssm_inputs(xs, torch.cat([Bm, Cm], dim=-1), dt, p,
                                    cfg, tp=_heads_tp(ctx))
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    out, f2 = _mix_out(y, xh, z, x, p, cfg, ctx)
    return out, or_flags(f1, f2)


def mamba_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, cache, slots=None,
                  lengths=None):
    """Prefill: the full-sequence mixer, and each row's final conv windows
    and SSD state written into the cache in place (rows ``slots``, or rows
    [0, B) without them).  With ``lengths`` (the engine's ragged admission
    batch, padded to a common L) the positions past a row's length are
    zeroed in the conv inputs and get dt = 0, so the state stops at the
    row's last token; the conv windows are gathered per row at its true
    end.  Nothing is read back to the host.  The paged engine runs the same
    path: the state is one constant-size entry a slot, with nothing to
    page.  Returns (out, flag)."""
    Bsz, L, _ = x.shape
    W = cfg.ssm_conv_width
    z, xs, Bm, Cm, dt, f1 = _project_in(x, p, cfg, ctx)
    bc_in = torch.cat([Bm, Cm], dim=-1)
    valid = None
    if lengths is not None:
        lens = lengths.to(x.device).long()
        valid = torch.arange(L, device=x.device)[None, :] < lens[:, None]
        xs = xs * valid[..., None].to(xs.dtype)
        bc_in = bc_in * valid[..., None].to(bc_in.dtype)
    # the conv windows: the last W-1 raw inputs of each row
    pad_xs = F.pad(xs, (0, 0, W - 1, 0))
    pad_bc = F.pad(bc_in, (0, 0, W - 1, 0))
    if lengths is None:
        conv_x, conv_bc = pad_xs[:, L:], pad_bc[:, L:]
    else:
        idx = lens[:, None] + torch.arange(W - 1, device=x.device)
        conv_x = torch.gather(
            pad_xs, 1, idx[..., None].expand(-1, -1, pad_xs.shape[-1]))
        conv_bc = torch.gather(
            pad_bc, 1, idx[..., None].expand(-1, -1, pad_bc.shape[-1]))
    xh, Bm2, Cm2, dt2, A = _ssm_inputs(xs, bc_in, dt, p, cfg, valid,
                                       _heads_tp(ctx))
    y, S = _ssd_chunked(xh, dt2, A, Bm2, Cm2, cfg.ssm_chunk)
    out, f2 = _mix_out(y, xh, z, x, p, cfg, ctx)
    rows = (torch.arange(Bsz, device=cache["ssm"].device) if slots is None
            else slots.to(cache["ssm"].device).long())
    keep = slice(None)
    sp = ctx.cache_split
    if sp is not None and sp.kind == "slot" and ctx.rows is None:
        # a slot-sharded state: the rank writes the rows it holds
        keep = sp.owns(rows)
        rows = rows[keep] - sp.lo
    for key, new in (("conv_x", conv_x), ("conv_bc", conv_bc), ("ssm", S)):
        cache[key][rows] = new[keep].to(cache[key].dtype)
    return out, or_flags(f1, f2)


def _conv_step(state, new, w, b):
    """One rolling depthwise conv step.  state: (B, W-1, C); new: (B, C).
    Returns (silu(conv) f32 (B, C), the next window f32 (B, W-1, C)).  A
    ``flops[ssm_scan]`` region, as the reference's (whose einsum is a
    contraction; here it is elementwise, with no FLOP-carrying op)."""
    with coverage_scope("ssm_scan"):
        window = torch.cat([state.to(F32), new[:, None, :].to(F32)], dim=1)
        out = (window * w.to(F32)).sum(dim=1)
        return F.silu(out + b.to(F32)), window[:, 1:, :]


def mamba_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, cache):
    """One recurrent step for every slot.  x: (B, 1, D).  Reads the
    cache's state and returns (out, flag, next state): the next state in
    new tensors (the cache's dtypes), the cache left as it was.  The dense
    and the paged engines run it alike."""
    Bsz = x.shape[0]
    H, N = p["A_log"].shape[0], cfg.ssm_state
    z, xs, Bm, Cm, dt, f1 = _project_in(x, p, cfg, ctx)
    xs2, conv_x = _conv_step(cache["conv_x"], xs[:, 0], p["conv_x_w"],
                             p["conv_x_b"])
    bc2, conv_bc = _conv_step(cache["conv_bc"],
                              torch.cat([Bm[:, 0], Cm[:, 0]], dim=-1),
                              p["conv_bc_w"], p["conv_bc_b"])
    Bm2, Cm2 = bc2[:, :N], bc2[:, N:]
    dt2 = F.softplus(dt[:, 0].to(F32) + p["dt_bias"])       # (B, H)
    dA = torch.exp(dt2 * -torch.exp(p["A_log"]))
    xh = xs2.reshape(Bsz, H, -1)
    # S' = S dA + (dt x) outer B;  y = S' C: the decode recurrence, a
    # ``flops[ssm_scan]`` region
    with coverage_scope("ssm_scan"):
        upd = (dt2[:, :, None] * xh)[..., None] * Bm2[:, None, None, :]
        S = cache["ssm"].to(F32) * dA[:, :, None, None] + upd
        y = (S @ Cm2[:, None, :, None])[..., 0]            # (B, H, P)
    out, f2 = _mix_out(y, xh, z, x, p, cfg, ctx)
    state = {"conv_x": conv_x.to(cache["conv_x"].dtype),
             "conv_bc": conv_bc.to(cache["conv_bc"].dtype),
             "ssm": S.to(cache["ssm"].dtype)}
    return out, or_flags(f1, f2), state


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """One slot's state a row: the conv windows in ``dtype``, the SSD
    state in f32."""
    W = cfg.ssm_conv_width
    return {
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, W - 1, 2 * cfg.ssm_state),
                               dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=F32, device=device),
    }
