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

The reference's dispatch runs per data-parallel group; the port has no
sharding hints, so there is one group (G = 1), as the reference without
hints.  Every shape is static and nothing waits on the device: no
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
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    LayerCtx,
    batched_dense,
    dense,
    mlp,
    or_flags,
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
    C = capacity(cfg, T)
    dev = x.device
    xf = x.reshape(T, D)

    # --- routing: the router GEMM is protected, its output and softmax f32
    logits, f_router = dense(xf, p["router"], ctx, "router", out_dtype=F32,
                             tag="moe.router")
    probs = torch.softmax(logits.to(F32), dim=-1)              # (T, E)
    topk_w, topk_i = top_k(probs, K)
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
    # switch-style load balance over the call's tokens
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(topk_i, E).to(F32).sum(1).mean(0)
    loss = E * torch.sum(me * ce) / K
    # each token's experts in ascending id: the combine's summation order;
    # the dispatch does not depend on the order within a token
    topk_i, perm = torch.sort(topk_i, dim=-1)
    topk_w = torch.gather(topk_w, -1, perm)

    # --- sort-based dispatch into (E * C + 1, D); row E * C takes drops
    flat_e = topk_i.reshape(-1)                                # (T K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ar = torch.arange(T * K, device=dev)
    pos_in_e = ar - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[slot] = xf[order // K]
    buf = buf[:-1].reshape(E, C, D)

    # --- expert GEMMs (SwiGLU), all experts in one protected call each
    up, f1 = batched_dense(buf, p["w_up"], ctx, "expert_up",
                           tag="moe.expert_up")
    gate, f2 = batched_dense(buf, p["w_gate"], ctx, "expert_up",
                             tag="moe.expert_up")
    h = torch.nn.functional.silu(gate.to(F32)).to(x.dtype) * up
    out_buf, f3 = batched_dense(h, p["w_down"], ctx, "expert_down",
                                tag="moe.expert_down")

    # --- combine: each (token, k) reads its slot back (a dropped one reads
    # a real row and weighs it 0, as the reference), summed in k order
    inv = torch.empty_like(order).scatter_(0, order, ar)
    slot_tk = slot[inv].reshape(T, K)
    keep_tk = keep[inv].reshape(T, K).to(F32)
    rows = out_buf.reshape(E * C, D)[slot_tk.clamp_max(E * C - 1)]
    contrib = rows.to(F32) * (topk_w * keep_tk)[..., None]    # (T, K, D)
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    y = y.to(x.dtype)
    flag = or_flags(f_router, f1, f2, f3)

    # --- shared experts (dense path, always on)
    if cfg.n_shared_experts:
        ys, fs = mlp(xf, p["shared"], ctx, act="silu",
                     tags=("moe.shared_up", "moe.shared_down"))
        y = y + ys
        flag = or_flags(flag, fs)
    return y.reshape(Bsz, L, D), flag, loss
