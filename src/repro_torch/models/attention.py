"""GQA attention sublayer (port of the GQA half of
``repro.models.attention``).  Projections run through the ABFT-protected
``dense``.  With ``ABFTConfig.flash_attention`` set, full-sequence
attention (``gqa_forward``) runs the fused-ABFT flash attention kernel
(K2) and decode attention the fused-ABFT flash decode kernel (K3); plain
attention outside any kernel otherwise.  Serving prefill attention is the
plain chunked path, as in the reference.

KV caches are updated IN PLACE (the reference returns new immutable
caches).  The serving engine's detect->retry loop stays sound because a
retried call rewrites exactly the cells its faulted attempt wrote: the
same (slot, position) rows of the dense cache, or the same (block,
offset) cells of the pools under unchanged block tables.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    LayerCtx,
    apply_rope,
    chunked_attention,
    decode_attention,
    dense,
    or_flags,
    rope_tables,
)
from repro_torch.serve.paged_cache import (
    paged_gather,
    paged_scatter_decode,
    paged_scatter_prefill,
)


def _qkv(x, p, cfg: ModelConfig, ctx: LayerCtx, positions):
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q, f1 = dense(x, p["wq"], ctx, "qkv", tag="attn.q")
    k, f2 = dense(x, p["wk"], ctx, "qkv", tag="attn.k")
    v, f3 = dense(x, p["wv"], ctx, "qkv", tag="attn.v")
    q = q.reshape(B, L, cfg.n_heads, hd)
    k = k.reshape(B, L, cfg.n_kv_heads, hd)
    v = v.reshape(B, L, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v, or_flags(f1, f2, f3)


def _attend_full(q, k, v, ctx: LayerCtx, causal: bool):
    """Full-sequence attention core: the fused-ABFT flash kernel (K2) when
    the config enables it, else the plain chunked path."""
    if ctx.abft.flash_attention:
        from repro_torch.kernels.flash_ops import flash_attention

        out, chk = flash_attention(q, k, v, causal=causal)
        return out, chk.flag
    return (chunked_attention(q, k, v, causal=causal),
            torch.zeros((), dtype=torch.bool, device=q.device))


def gqa_forward(x, p, cfg: ModelConfig, ctx: LayerCtx, positions,
                causal: bool = True):
    """Full-sequence attention (training / scoring).  x: (B, L, D)."""
    B, L, _ = x.shape
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    out, f_attn = _attend_full(q, k, v, ctx, causal)
    out, f = dense(out.reshape(B, L, -1), p["wo"], ctx, "attn_out",
                   tag="attn.o")
    return out, or_flags(flag, f_attn, f)


def decode_cells(pos) -> tuple:
    """Index of the dense cache cells a decode step writes: row b at its
    cursor ``pos[b]``, every row (inactive ones at their reset cursor)."""
    pos = pos.long()
    return torch.arange(pos.shape[0], device=pos.device), pos


def prefill_cells(slots, L: int) -> tuple:
    """Index of the dense cache cells a prefill writes: rows ``slots`` at
    positions [0, L)."""
    slots = slots.long()
    return slots[:, None], torch.arange(L, device=slots.device)[None, :]


def _row_scatter(cache_leaf, new, pos) -> None:
    """Per-row decode write: ``new[b, 0]`` lands at ``cache_leaf[b, pos[b]]``."""
    cache_leaf[decode_cells(pos.to(cache_leaf.device))] = \
        new[:, 0].to(cache_leaf.dtype)


def _slot_prefill_write(cache_leaf, new, slots, L: int) -> None:
    """Write ``new`` (A, L, ...) into rows ``slots`` at positions [0, L)."""
    cache_leaf[prefill_cells(slots.to(cache_leaf.device), L)] = \
        new.to(cache_leaf.dtype)


def gqa_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions, cache,
                slots=None, lengths=None):
    """Prefill: attend the prompt and fill the cache.  cache k/v:
    (B, S_max, KV, hd).  With ``slots``/``lengths`` (continuous batching)
    x is the padded admission batch, rows scatter into the engine rows
    ``slots`` and attention is masked at each row's length."""
    B, L, _ = x.shape
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    out = chunked_attention(q, k, v, causal=True, lengths=lengths)
    if slots is None:
        cache["k"][:, :L] = k.to(cache["k"].dtype)
        cache["v"][:, :L] = v.to(cache["v"].dtype)
    else:
        _slot_prefill_write(cache["k"], k, slots, L)
        _slot_prefill_write(cache["v"], v, slots, L)
    out, f = dense(out.reshape(B, L, -1), p["wo"], ctx, "attn_out",
                   tag="attn.o")
    return out, or_flags(flag, f)


def gqa_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache):
    """One-token decode.  x: (B, 1, D); pos: (B,) per-slot cursor; each
    row writes its k/v at its own cursor and attends its own prefix."""
    B = x.shape[0]
    q, k, v, flag = _qkv(x, p, cfg, ctx, pos[:, None])
    _row_scatter(cache["k"], k, pos)
    _row_scatter(cache["v"], v, pos)
    if ctx.abft.flash_attention:
        from repro_torch.kernels.flash_ops import flash_decode

        out, chk = flash_decode(q, cache["k"], cache["v"], pos + 1)
        f_attn = chk.flag
    else:
        out = decode_attention(q, cache["k"], cache["v"], pos + 1)
        f_attn = torch.zeros((), dtype=torch.bool, device=x.device)
    out, f = dense(out.reshape(B, 1, -1), p["wo"], ctx, "attn_out",
                   tag="attn.o")
    return out, or_flags(flag, f_attn, f)


def gqa_paged_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions,
                      cache, tables, lengths):
    """Paged prefill: the same ragged attention as the dense path; k/v
    scatter into the pools through ``tables`` (A, W)."""
    B, L, _ = x.shape
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    out = chunked_attention(q, k, v, causal=True, lengths=lengths)
    paged_scatter_prefill(cache["k"], k, tables, lengths)
    paged_scatter_prefill(cache["v"], v, tables, lengths)
    out, f = dense(out.reshape(B, L, -1), p["wo"], ctx, "attn_out",
                   tag="attn.o")
    return out, or_flags(flag, f)


def gqa_paged_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache,
                     tables):
    """Paged one-token decode: scatter at ``tables[b, pos[b] // BS]``,
    then attend through K3 (pools read in place) or gather + plain
    attention."""
    B = x.shape[0]
    q, k, v, flag = _qkv(x, p, cfg, ctx, pos[:, None])
    paged_scatter_decode(cache["k"], k[:, 0], tables, pos)
    paged_scatter_decode(cache["v"], v[:, 0], tables, pos)
    if ctx.abft.flash_attention:
        from repro_torch.kernels.flash_ops import flash_decode_paged

        out, chk = flash_decode_paged(q, cache["k"], cache["v"], tables,
                                      pos + 1)
        f_attn = chk.flag
    else:
        out = decode_attention(q, paged_gather(cache["k"], tables),
                               paged_gather(cache["v"], tables), pos + 1)
        f_attn = torch.zeros((), dtype=torch.bool, device=x.device)
    out, f = dense(out.reshape(B, 1, -1), p["wo"], ctx, "attn_out",
                   tag="attn.o")
    return out, or_flags(flag, f_attn, f)


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
