"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
capacity-bounded sort-based dispatch into an (E, C, D) buffer, the expert
GEMMs batched over the expert axis, the weighted combine, and shared
experts through the dense ``mlp``.

Each expert's GEMM is its own "linear layer" in the paper's sense, with
its own arithmetic intensity: the scheme is resolved per expert (m = C)
and a block scheme runs all E experts' GEMMs as one K1 launch
(``layers.batched_dense``), where the reference vmaps its Pallas kernel.
Tokens over an expert's capacity are dropped (switch-style) and keep only
their residual path.

The dispatch runs per data-parallel group, as the reference's: G =
``ctx.moe_groups`` groups of the call's tokens in order, or the hints'
``dp_size`` where the context sets none (one group without hints, or
where G does not divide the token count), each routed
into its own (E, C, D) buffer with the capacity of its own T / G tokens,
so which tokens an expert drops depends on the grouping.  A data rank's
split decode or verify holds one of the reference's groups, its own
slots, and runs with ``moe_groups = 1``; a prefill run whole on every
data rank keeps G = ``dp_size``.  The router, its
softmax and the load-balance loss read every token alike.  Every shape is
static and nothing waits on the device: no
``.item()``, no boolean-mask indexing.  Two orders are pinned where the
reference's JAX ops pin them and PyTorch's do not:

- top-k takes the lower expert index on ties (``jax.lax.top_k``), by a
  stable descending sort;
- the combine sums each token's K contributions in one fixed order, its
  experts' ascending ids (the order of the reference's scatter-add over
  the expert-sorted assignments), with no atomics: on the card an
  ``index_add_`` would sum in another order from run to run, so a
  recomputed step, or the paged twin of a dense run, could round
  differently.

Under tensor parallelism (``LayerCtx.tp``) the router, its softmax and
the dispatch stay replicated: every rank routes every token alike and
builds the same (E, C, D) buffer, so no all-to-all is needed.  The mode
is the hints' ``moe_mode`` (``distributed.mesh.make_hints``, from the
sharding rules):

- ``"ep"`` (the experts divide the model axis): the rank holds experts
  [r E/k, (r+1) E/k) whole and runs K1 batched over their rows of the
  buffer; its combine takes only the slots of its own experts (the others
  selected away by ``torch.where``, not weighed by 0: a faulted row times
  0 need not be 0), in the same ascending-id order, into a (T, D) f32
  partial summed over the ranks and rounded once.  At top-2 routing a
  token's partials hold at most two non-zero terms, so the sum is exact
  and the routed experts' output equals the unsharded one bit for bit.
- ``"tp"`` (otherwise): every expert's F is sliced, ``w_up``/``w_gate``
  column-parallel and ``w_down`` row-parallel (``batched_dense(par=)``),
  the (E, C, D) f32 partials summed and rounded once before the combine,
  as the reference rounds ``out_buf`` before it combines.

Shared experts go through ``mlp`` with the rules' ``par``.

Training: with ``LayerCtx.aux_over_data`` (each data rank runs its own
rows) the load-balance loss's means ``me`` and ``ce`` are averaged over
the data ranks (one f32 sum) before their product, so it is the global
batch's, as the reference's.  Under expert parallelism a rank's combine
reads only its own experts' slots, so the gradient it returns to the
dispatched tokens and to the combine weights covers those experts alone:
both pass through ``copy_to_model`` (the gradient summed over the model
axis), and the replicated router's gradient comes out whole and equal on
every rank.

A speculative verify call (``ABFTConfig.decode_rows`` set) routes all its
B x T rows at once, as the reference's, so its capacity is the window's.
Its GEMMs sum each row in the decode step's order: the router and the
shared experts take the (B, T, D) operand (``dense``'s row pinning) and
the expert GEMMs the K split of the decode step's capacity, so a row
whose experts dropped nothing in either call gets decode's bits.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_reduce_sum, copy_to_model
from repro_torch.models.layers import (
    LayerCtx,
    batched_dense,
    dense,
    mlp,
    or_flags,
    raw,
    tp_par,
)

F32 = torch.float32


def init_moe(cfg: ModelConfig, w) -> dict:
    """The MoE FFN's params; ``w(*shape)`` draws one weight (the model's
    init law).  Leaves as the reference's: ``router`` (D, E), ``w_up`` and
    ``w_gate`` (E, D, F), ``w_down`` (E, F, D) and, with shared experts,
    ``shared`` {``up``, ``gate``: (D, Fs), ``down``: (Fs, D)} with Fs =
    ``moe_d_ff * n_shared_experts``."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": w(D, E), "w_up": w(E, D, Fd), "w_gate": w(E, D, Fd),
         "w_down": w(E, Fd, D)}
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"up": w(D, Fs), "gate": w(D, Fs), "down": w(Fs, D)}
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows an expert takes in a call of ``n_tokens`` tokens: the switch
    capacity ``ceil(T K / E * capacity_factor)``, rounded up to a multiple
    of 8 and at least 8, at most T (copy of the reference's)."""
    c = int(math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                      * cfg.capacity_factor))
    c = max(8, -(-c // 8) * 8)
    return min(c, n_tokens)


def top_k(probs, k: int) -> tuple:
    """(values, indices) of the k largest entries along the last dim,
    largest first and the lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(x, p, cfg: ModelConfig, ctx: LayerCtx):
    """x: (B, L, D) -> (y (B, L, D), flag, aux_loss)."""
    Bsz, L, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = Bsz * L
    G = ctx.moe_groups
    if G is None:
        G = ctx.hints.dp_size if ctx.hints is not None else 1
    if G <= 0 or T % G:
        G = 1
    C = capacity(cfg, T // G)
    xf = x.reshape(T, D)
    # a verify call's operands keep their (B, T) rows (module docstring)
    pin = ctx.abft.decode_rows
    xr = x if pin is not None else xf
    split = (capacity(cfg, pin // G) if pin is not None and pin % G == 0
             else None)

    # --- routing: the router GEMM is protected, its output and softmax f32
    logits, f_router = dense(xr, p["router"], ctx, "router", out_dtype=F32,
                             tag="moe.router")
    probs = torch.softmax(logits.reshape(T, E).to(F32), dim=-1)  # (T, E)
    topk_w, topk_i = top_k(probs, K)
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    # switch-style load balance over the call's tokens
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(topk_i, E).to(F32).sum(1).mean(0)
    bg = ctx.batch
    if ctx.aux_over_data and bg is not None and bg.size > 1:
        # every batch rank routes as many tokens: the global means are
        # the ranks' means averaged
        mc = all_reduce_sum(torch.stack([me, ce]), bg) / bg.size
        me, ce = mc[0], mc[1]
    loss = E * torch.sum(me * ce) / K
    # each token's experts in ascending id: the combine's summation order;
    # the dispatch does not depend on the order within a token
    topk_i, perm = torch.sort(topk_i, dim=-1)
    topk_w = torch.gather(topk_w, -1, perm)
    xd = xf
    if expert_shard(p, cfg, ctx)[0] == "ep":
        xd, topk_w = copy_to_model(xf, ctx.tp), copy_to_model(topk_w, ctx.tp)

    Tl = T // G
    parts = [_experts(xd[g * Tl:(g + 1) * Tl], topk_i[g * Tl:(g + 1) * Tl],
                      topk_w[g * Tl:(g + 1) * Tl], p, cfg, ctx, C, split)
             for g in range(G)]
    y = parts[0][0] if G == 1 else torch.cat([y for y, _ in parts])
    flag = or_flags(f_router, *(f for _, f in parts))

    # --- shared experts (dense path, always on)
    if cfg.n_shared_experts:
        ys, fs = mlp(xr, p["shared"], ctx, act="silu",
                     tags=("moe.shared_up", "moe.shared_down"),
                     path="ffn/shared")
        y = y + ys.reshape(T, D)
        flag = or_flags(flag, fs)
    return y.reshape(Bsz, L, D), flag, loss


def expert_shard(p, cfg: ModelConfig, ctx: LayerCtx) -> tuple:
    """This rank's part of the routed experts: (mode, lo) with mode None
    (every expert whole: unsharded, or replicated by the rules), "ep"
    (experts [lo, lo + E_local) whole) or "tp" (every expert, F sliced)."""
    if tp_par(ctx, "ffn/w_up", "col") is None:
        return None, 0
    mode = ctx.hints.moe_mode if ctx.hints is not None else "ep"
    El = raw(p, "w_up").shape[0]
    if mode == "ep":
        if El * ctx.tp.size != cfg.n_experts:
            raise ValueError(f"expert-parallel MoE: {El} experts a rank x "
                             f"{ctx.tp.size} ranks != {cfg.n_experts}")
        return "ep", ctx.tp.rank * El
    if mode != "tp" or El != cfg.n_experts:
        raise ValueError(f"MoE mode {mode!r} with {El} of "
                         f"{cfg.n_experts} experts on a rank")
    return "tp", 0


def _experts(xf, topk_i, topk_w, p, cfg: ModelConfig, ctx: LayerCtx,
             C: int, split):
    """One dispatch group's routed experts: its T tokens xf (T, D) with
    their top-k experts and weights through capacity-C buffers, the
    expert GEMMs and the combine (the rank's part of them under tensor
    parallelism: ``expert_shard``, the module docstring).  Returns
    (y (T, D), flag)."""
    T, D = xf.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    dev = xf.device
    mode, lo = expert_shard(p, cfg, ctx)
    # --- sort-based dispatch into (E * C + 1, D); row E * C takes drops
    flat_e = topk_i.reshape(-1)                                # (T K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ar = torch.arange(T * K, device=dev)
    pos_in_e = ar - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))
    buf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=dev)
    buf[slot] = xf[order // K]
    buf = buf[:-1].reshape(E, C, D)
    El = raw(p, "w_up").shape[0]
    if mode == "ep":
        buf = buf[lo:lo + El]

    # --- expert GEMMs (SwiGLU), all (local) experts in one protected call
    col, row = ("col", "row") if mode == "tp" else (None, None)
    up, f1 = batched_dense(buf, p["w_up"], ctx, "expert_up",
                           tag="moe.expert_up", split_rows=split, par=col)
    gate, f2 = batched_dense(buf, p["w_gate"], ctx, "expert_up",
                             tag="moe.expert_up", split_rows=split, par=col)
    h = torch.nn.functional.silu(gate.to(F32)).to(xf.dtype) * up
    out_buf, f3 = batched_dense(h, p["w_down"], ctx, "expert_down",
                                tag="moe.expert_down", split_rows=split,
                                par=row)

    # --- combine: each (token, k) reads its slot back (a dropped one reads
    # a real row and weighs it 0, as the reference), summed in k order
    inv = torch.empty_like(order).scatter_(0, order, ar)
    slot_tk = slot[inv].reshape(T, K)
    keep_tk = keep[inv].reshape(T, K).to(F32)
    local = slot_tk - lo * C
    rows = out_buf.reshape(El * C, D)[local.clamp(0, El * C - 1)]
    contrib = rows.to(F32) * (topk_w * keep_tk)[..., None]    # (T, K, D)
    if mode == "ep":
        # the rank's own experts' slots; the rest (and drops) select 0
        own = (local >= 0) & (local < El * C)
        contrib = torch.where(own[..., None], contrib,
                              torch.zeros((), dtype=F32, device=dev))
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    if mode == "ep":
        y = all_reduce_sum(y, ctx.tp)
    return y.to(xf.dtype), or_flags(f1, f2, f3)
