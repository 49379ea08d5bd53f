"""Attention sublayers (port of ``repro.models.attention``): GQA, with the
dense family's ``qkv_bias``, ``qk_norm`` and partial rotary, and absorbed
MLA (deepseek-v3), and the cross-attention of the vision model's memory
layers.  Projections run through the ABFT-protected
``dense``.  With ``ABFTConfig.flash_attention`` set, GQA's full-sequence
attention (``gqa_forward``) runs the fused-ABFT flash attention kernel
(K2) and its decode attention the fused-ABFT flash decode kernel (K3);
plain attention outside any kernel otherwise.  Serving prefill attention is the
plain chunked path, as in the reference, run row by row at fixed chunk
shapes (``chunked_attention(spans=...)``) so that a prompt prefilled
whole, as the suffix of a shared prefix or in chunks gets bit-identical KV.

KV caches are updated IN PLACE (the reference returns new immutable
caches).  The serving engine's detect->retry loop stays sound because a
retried call rewrites exactly the cells its faulted attempt wrote: the
same (slot, position) rows of the dense cache, or the same (block,
offset) cells of the pools under unchanged block tables.

Under tensor parallelism (``LayerCtx.tp``) a GQA layer runs this rank's
shard: its q heads, its kv heads and its rows of ``wo``, the head counts
read off the shard's leaves, never ``cfg.n_heads``/``n_kv_heads``; the
output projection is row-parallel (``layers.dense``).  Where the kv heads
do not divide the model axis the rules still split ``wk``/``wv`` by
columns, so one kv head spans ranks: the rank gathers k and v whole
(``collectives.gather_last``), its cache keeps every kv head
(``cache_specs(kv_fallback="replicate")``, the reference's layout for
this case), and its q heads attend the kv heads they read (``_kv_heads``).

TP head padding (``pad_heads_to``/``pad_kv_heads_to``, the reference's):
a GQA layer runs ``eff_counts`` heads, its logical ones zero-padded in the
kv-major (kv, group) layout, the padded heads' ``wo`` rows zero, so the
padded model computes the logical one's output; a padded kv head's keys
and values are 0 and its q heads attend them uniformly, a garbage that
the zero rows of ``wo`` drop.  The caches hold the padded kv heads.

MLA runs the reference's absorbed form: one latent "KV head" of width
``kv_lora_rank + qk_rope_head_dim`` is both the key (all of it) and the
value (its first ``kv_lora_rank``, a view), cached as the one leaf
``latent``; each head's query is ``q_nope @ w_uk`` beside its roped
``q_pe``, and the attended latent goes back through ``w_uv``.  The two
absorbed products and the attention core stay outside ABFT, as the
reference marks them, and never take the flash kernels, whatever the
config says.  They run in f32 (TF32 off on the card) in a fixed order
where a bit identity needs it: the serving prefill runs them at one row
block shape (``ABSORB_ROWS``), a verify step one step at a time at the
decode step's shape, with its latent norms.

Under tensor parallelism MLA follows the same rules: ``wq_b`` is
column-parallel, so a rank holds its q heads' columns and its heads of
``w_uk``/``w_uv`` (the head count read off the shard's leaves), and
``wo`` is row-parallel; ``wq_a``, ``wkv_a`` and their norms are
replicated, so every rank computes the same latent bit for bit and keeps
the whole latent cache (``cache_specs``).

Under data parallelism (``LayerCtx.cache_split``) a dense cache holds
the rank's slots or, with fewer slots than data ranks, the rank's run of
positions (``k``/``v``, MLA's ``latent``).  A whole-batch call (prefill,
a prompt chunk) writes only the cells the rank holds (``put_cells``);
a chunk that reads the slot's earlier cells gathers them from the ranks
that hold them for that call alone (``_slot_rows``).  Over a
sequence-sharded cache a decode step attends each rank's positions (K3,
or the plain path, on the shard, with its log-sum-exp) and merges the
partials in f32 (``collectives.lse_combine``): no rank ever holds the
whole sequence.  Paged pools stay whole on every data rank.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.markers import coverage_scope, logical_scope
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (
    copy_to_model,
    fsdp_gather,
    gather_first,
    gather_last,
    lse_combine,
)
from repro_torch.models.layers import (
    LayerCtx,
    apply_rope,
    chunked_attention,
    decode_attention,
    dense,
    or_flags,
    per_step,
    put_cells,
    rms_norm,
    rope_tables,
    tp_par,
    verify_attention,
)
from repro_torch.serve.paged_cache import (
    index_write,
    paged_gather,
    paged_scatter_decode,
    paged_scatter_prefill,
)

F32 = torch.float32


def _qkv(x, p, cfg: ModelConfig, ctx: LayerCtx, positions):
    """The q/k/v projections of every attention path: protected GEMMs,
    then the ``qkv_bias`` biases, RMSNorm over the head dim (``qk_norm``)
    and rotary embeddings on the first ``rope_pct`` of each head (the
    rest passes through, and reaches the cache unrotated)."""
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q, f1 = dense(x, p["wq"], ctx, "qkv", b=p.get("bq"), tag="attn.q",
                  par=tp_par(ctx, "mixer/wq", "col"))
    k, f2 = dense(x, p["wk"], ctx, "qkv", b=p.get("bk"), tag="attn.k",
                  par=tp_par(ctx, "mixer/wk", "col"))
    v, f3 = dense(x, p["wv"], ctx, "qkv", b=p.get("bv"), tag="attn.v",
                  par=tp_par(ctx, "mixer/wv", "col"))
    if k.shape[-1] % hd:
        # a kv head split over the ranks: make every kv head whole
        k, v = gather_last(k, ctx.tp), gather_last(v, ctx.tp)
    q = q.reshape(B, L, -1, hd)
    k = k.reshape(B, L, -1, hd)
    v = v.reshape(B, L, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta:
        cos, sin, rot = rope_tables(positions, hd, cfg.rope_theta,
                                    cfg.rope_pct)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    return q, k, v, or_flags(f1, f2, f3)


def _kv_heads(q, kv_leaf, cfg: ModelConfig, ctx: LayerCtx):
    """The kv heads (a slice of dim 2 of a (B|NB, S|BS, KV, hd) leaf) this
    rank's q heads read, where its leaf holds more kv heads than its q
    heads group onto (a rank holding every kv head, see the module
    docstring); None where the leaf's heads are exactly its q heads'."""
    Hl, KV = q.shape[2], kv_leaf.shape[2]
    H, KVp = eff_counts(cfg)
    G = H // KVp
    if Hl == G * KV:
        return None
    lo = ctx.tp.rank * Hl // G
    return slice(lo, lo + max(1, Hl // G))


def _sel(t, heads, contiguous: bool = False):
    if heads is None:
        return t
    t = t[:, :, heads]
    return t.contiguous() if contiguous else t


def _out(out, p, ctx: LayerCtx):
    """The attention output (B, L, Hl, hd) through ``wo``, row-parallel
    under tensor parallelism."""
    B, L = out.shape[:2]
    return dense(out.reshape(B, L, -1), p["wo"], ctx, "attn_out",
                 tag="attn.o", par=tp_par(ctx, "mixer/wo", "row"))


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
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    heads = _kv_heads(q, k, cfg, ctx)
    out, f_attn = _attend_full(q, _sel(k, heads, True), _sel(v, heads, True),
                               ctx, causal)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f_attn, f)


def decode_cells(pos) -> tuple:
    """Index of the dense cache cells a decode step writes: row b at its
    cursor ``pos[b]``, every row (inactive ones at their reset cursor)."""
    pos = pos.long()
    return torch.arange(pos.shape[0], device=pos.device), pos


def prefill_cells(slots, L: int, starts=None, lengths=None) -> tuple:
    """Index of the dense cache cells a prefill writes: rows ``slots`` at
    positions [0, L), or — with ``starts`` — row a at positions
    ``starts[a] + t`` for ``t < lengths[a]`` (a suffix or a chunk)."""
    slots = slots.long()
    t = torch.arange(L, device=slots.device)
    if starts is None:
        return slots[:, None], t[None, :]
    keep = t[None, :] < lengths.to(slots.device)[:, None]
    pos = starts.to(slots.device).long()[:, None] + t[None, :]
    return slots[:, None].expand(-1, L)[keep], pos[keep]


def verify_write_index(pos, valid, T: int, depth: int) -> tuple:
    """(cells, src) of a dense verify window of width T: row b's token t
    lands at ``pos[b] + t`` while ``t < valid[b]`` and inside the cache
    ``depth`` (dropped, never clamped: a clamp would write a near-budget
    window back onto committed keys); ``src`` indexes those tokens in the
    window's (B * T) rows.  Built once a verify call (one host read, the
    mask's ``nonzero``) and shared by every layer's write
    (``paged_cache.index_write``)."""
    pos = pos.long()
    t = torch.arange(T, device=pos.device)
    keep = (t[None, :] < valid.to(pos.device)[:, None]) & \
        (pos[:, None] + t[None, :] < depth)
    b, t = keep.nonzero(as_tuple=True)
    return (b, pos[b] + t), b * T + t


def verify_cells(pos, valid, depth: int) -> tuple:
    """Index of the dense cache cells a verify step writes (retries and
    shadow runs)."""
    return verify_write_index(pos, valid, int(valid.max()), depth)[0]


def _row_scatter(cache_leaf, new, pos, ctx: LayerCtx) -> None:
    """Per-row decode write: ``new[b, 0]`` lands at ``cache_leaf[b, pos[b]]``
    (on a sequence-sharded cache, on the rank that holds the position)."""
    put_cells(cache_leaf, decode_cells(pos.to(cache_leaf.device)),
              new[:, 0], ctx)


def _slot_prefill_write(cache_leaf, new, slots, L: int,
                        ctx: LayerCtx) -> None:
    """Write ``new`` (A, L, ...) into rows ``slots`` at positions [0, L)."""
    put_cells(cache_leaf, prefill_cells(slots.to(cache_leaf.device), L),
              new, ctx)


def _slot_prefill_write_at(cache_leaf, new, slots, starts, lengths,
                           ctx: LayerCtx) -> None:
    """Write ``new`` (A, L, ...) into rows ``slots`` at per-row offsets:
    ``new[a, t]`` lands at ``starts[a] + t`` for ``t < lengths[a]``.
    Padding positions (and padding rows, lengths 0) are masked out and
    never written — not even onto row 0's slot, which padding rows alias."""
    dev = cache_leaf.device
    cells = prefill_cells(slots.to(dev), new.shape[1], starts.to(dev),
                          lengths.to(dev))
    keep = (torch.arange(new.shape[1], device=dev)[None, :]
            < lengths.to(dev)[:, None])
    put_cells(cache_leaf, cells, new[keep], ctx)


def _slot_rows(cache_leaf, slots, ctx: LayerCtx):
    """The cache rows of ``slots`` (A, S, ...), every position, for a
    whole-batch call (a prompt chunk attending its slot's earlier cells).
    A split cache's rows come from the ranks that hold them, for this
    call alone: slot-sharded, each rank fills the rows it holds (zeros
    elsewhere) and every row is taken from its owner's part of the
    gather; sequence-sharded, the rows' positions are gathered in rank
    order."""
    sp = ctx.cache_split
    slots = slots.to(cache_leaf.device).long()
    if sp is None or ctx.rows is not None:
        return cache_leaf[slots]
    if sp.kind == "seq":
        return fsdp_gather(cache_leaf[slots], ctx.dp, 1, kind="data_gather")
    own = sp.owns(slots)
    local = cache_leaf[torch.where(own, slots - sp.lo, 0)]
    local = torch.where(own.reshape((-1,) + (1,) * (local.dim() - 1)),
                        local, torch.zeros((), dtype=local.dtype,
                                           device=local.device))
    every = gather_first(local, ctx.batch).reshape(
        (ctx.batch.size,) + tuple(local.shape))
    return every[slots // sp.n, torch.arange(len(slots),
                                             device=slots.device)]


def _seq_len(length, ctx: LayerCtx):
    """A sequence-sharded rank's valid keys of each row: its positions
    below ``length``; None on any other layout."""
    sp = ctx.cache_split
    if sp is None or sp.kind != "seq":
        return None
    return (length - sp.lo).clamp(0, sp.n).to(length.dtype)


def _merge(out, lse, ctx: LayerCtx):
    """A sequence-sharded decode's output: the ranks' partial ``out``
    (B, 1, H, Dv) merged by their ``lse`` (B, KV, G) in f32, cast back."""
    B, _, H, _ = out.shape
    return lse_combine(out, lse.reshape(B, 1, H), ctx.dp).to(out.dtype)


def gqa_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions, cache,
                slots=None, lengths=None, starts=None, spans=None):
    """Prefill: attend the prompt and fill the cache.  cache k/v:
    (B, S_max, KV, hd).  With ``slots``/``lengths`` (continuous batching)
    x is the padded admission batch, rows scatter into the engine rows
    ``slots`` and attention is masked at each row's length.

    ``starts`` (A,) selects the resumable-chunk path: x holds one
    mid-prompt chunk per row starting at logical position ``starts[a]``
    (``positions`` carries the offset, so rotary matches the whole-prompt
    prefill).  The chunk's k/v land behind the resident prefix and the
    chunk attends the slot's cache rows with a per-row causal offset.
    ``spans``: ``chunked_attention``'s (row-wise attention)."""
    L = x.shape[1]
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    if starts is None:
        out = chunked_attention(q, _sel(k, heads), _sel(v, heads),
                                causal=True, lengths=lengths, spans=spans)
        if slots is None:
            slots = torch.arange(x.shape[0], device=x.device)
        _slot_prefill_write(cache["k"], k, slots, L, ctx)
        _slot_prefill_write(cache["v"], v, slots, L, ctx)
    else:
        assert slots is not None, "chunked prefill needs slot targets"
        _slot_prefill_write_at(cache["k"], k, slots, starts, lengths, ctx)
        _slot_prefill_write_at(cache["v"], v, slots, starts, lengths, ctx)
        out = chunked_attention(q, _sel(_slot_rows(cache["k"], slots, ctx),
                                        heads),
                                _sel(_slot_rows(cache["v"], slots, ctx),
                                     heads),
                                causal=True, q_offset=starts,
                                lengths=starts + lengths, spans=spans)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f)


# K3 walks the dense cache in blocks of the paged engine's default block
# size (16 keys): its split partition (``decode_splits``) is then the
# paged pool's at every shape, so dense and paged decode attention sum
# their keys in one order (at 128-key blocks a 512-deep cache caps the
# dense walk at 4 splits where the pool takes 8 over 4 kv heads: TP=2)
DENSE_DECODE_BLOCK = 16


def gqa_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache):
    """One-token decode.  x: (B, 1, D); pos: (B,) per-slot cursor; each
    row writes its k/v at its own cursor and attends its own prefix."""
    q, k, v, flag = _qkv(x, p, cfg, ctx, pos[:, None])
    _row_scatter(cache["k"], k, pos, ctx)
    _row_scatter(cache["v"], v, pos, ctx)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    # a sequence-sharded rank attends its own positions, then merges
    local = _seq_len(pos + 1, ctx)
    length = pos + 1 if local is None else local
    if ctx.abft.flash_attention:
        from repro_torch.kernels.flash_ops import flash_decode

        out, chk, *lse = flash_decode(
            q, _sel(cache["k"], heads, True), _sel(cache["v"], heads, True),
            length, bk=DENSE_DECODE_BLOCK, return_lse=local is not None)
        f_attn = chk.flag
    else:
        out = decode_attention(q, _sel(cache["k"], heads),
                               _sel(cache["v"], heads), length,
                               return_lse=local is not None)
        out, *lse = out if local is not None else (out,)
        f_attn = torch.zeros((), dtype=torch.bool, device=x.device)
    if local is not None:
        out = _merge(out, lse[0], ctx)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f_attn, f)


def gqa_verify(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache, index):
    """Speculative verify: x (B, T, D) holds each row's last committed
    token followed by its draft window; row b writes its first ``valid[b]``
    k/v rows at positions ``pos[b]..`` (``index``: the window's
    ``verify_write_index``) and every query attends its own causal prefix
    (``verify_attention``).  Rows past ``valid`` pad shorter windows:
    their writes drop and their logits are discarded."""
    T = x.shape[1]
    positions = pos.long()[:, None] + torch.arange(T, device=x.device)
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    index_write(cache["k"], k, index)
    index_write(cache["v"], v, index)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    out = verify_attention(q, _sel(cache["k"], heads),
                           _sel(cache["v"], heads), pos + 1)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f)


def gqa_paged_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions,
                      cache, tables, lengths, starts=None, spans=None):
    """Paged prefill: the same ragged attention as the dense path; k/v
    scatter into the pools through ``tables`` (A, W).

    ``starts`` (A,) selects the suffix path (a shared prefix's suffix, or
    a prompt chunk): row a's tokens start at logical position
    ``starts[a]``; their k/v scatter behind the resident prefix, then the
    rows attend the slot's gathered logical KV with a per-row causal
    offset and total-length key masking.  ``spans``: ``gqa_prefill``'s."""
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    if starts is None:
        out = chunked_attention(q, _sel(k, heads), _sel(v, heads),
                                causal=True, lengths=lengths, spans=spans)
        paged_scatter_prefill(cache["k"], k, tables, lengths)
        paged_scatter_prefill(cache["v"], v, tables, lengths)
    else:
        paged_scatter_prefill(cache["k"], k, tables, lengths, starts=starts)
        paged_scatter_prefill(cache["v"], v, tables, lengths, starts=starts)
        out = chunked_attention(
            q, _sel(paged_gather(cache["k"], tables), heads),
            _sel(paged_gather(cache["v"], tables), heads), causal=True,
            q_offset=starts, lengths=starts + lengths, spans=spans)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f)


def gqa_paged_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache,
                     tables):
    """Paged one-token decode: scatter at ``tables[b, pos[b] // BS]``,
    then attend through K3 (pools read in place) or gather + plain
    attention."""
    q, k, v, flag = _qkv(x, p, cfg, ctx, pos[:, None])
    paged_scatter_decode(cache["k"], k[:, 0], tables, pos)
    paged_scatter_decode(cache["v"], v[:, 0], tables, pos)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    if ctx.abft.flash_attention:
        from repro_torch.kernels.flash_ops import flash_decode_paged

        out, chk = flash_decode_paged(q, _sel(cache["k"], heads, True),
                                      _sel(cache["v"], heads, True), tables,
                                      pos + 1)
        f_attn = chk.flag
    else:
        out = decode_attention(
            q, _sel(paged_gather(cache["k"], tables), heads),
            _sel(paged_gather(cache["v"], tables), heads), pos + 1)
        f_attn = torch.zeros((), dtype=torch.bool, device=x.device)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f_attn, f)


def gqa_paged_verify(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache,
                     index, tables):
    """Paged speculative verify: the window's k/v scatter behind the
    committed prefix through the block tables (``index``: the suffix
    scatter's ``prefill_write_index`` with starts at the cursors, rows
    past ``valid`` dropped), then each query attends the gathered logical
    KV as ``gqa_verify``'s do."""
    T = x.shape[1]
    positions = pos.long()[:, None] + torch.arange(T, device=x.device)
    q, k, v, flag = _qkv(x, p, cfg, ctx, positions)
    index_write(cache["k"], k, index)
    index_write(cache["v"], v, index)
    heads = _kv_heads(q, cache["k"], cfg, ctx)
    out = verify_attention(q, _sel(paged_gather(cache["k"], tables), heads),
                           _sel(paged_gather(cache["v"], tables), heads),
                           pos + 1)
    out, f = _out(out, p, ctx)
    return out, or_flags(flag, f)


def eff_counts(cfg: ModelConfig) -> tuple:
    """(H_eff, KV_eff): the head counts after TP padding (the reference's).
    Padding keeps the kv-major (kv, group) head layout, so the padded
    model is the logical one (padded ``wo`` rows are zero)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hp, KVp = max(cfg.pad_heads_to, H), max(cfg.pad_kv_heads_to, KV)
    G, Gp = H // max(KV, 1), Hp // max(KVp, 1)
    if KVp * Gp != Hp or Gp < G:
        raise ValueError(f"invalid head padding H={H}->{Hp}, KV={KV}->{KVp}")
    return Hp, KVp


def _pad_heads(t, dim: int, KV: int, G: int, KVp: int, Gp: int):
    """``t`` with its dim ``dim`` of KV * G * hd columns (or rows) laid out
    again as KVp * Gp * hd, the logical heads at their kv-major places and
    zeros in the padded ones (the reference's ``_pad_heads_in``,
    ``_pad_heads_out``, ``_pad_bias``)."""
    if (KV, G) == (KVp, Gp):
        return t
    shape = t.shape
    hd = shape[dim] // (KV * G)
    t4 = t.reshape(shape[:dim] + (KV, G, hd) + shape[dim + 1:])
    after = len(shape) - dim - 1
    t4 = torch.nn.functional.pad(
        t4, (0, 0) * (after + 1) + (0, Gp - G, 0, KVp - KV))
    return t4.reshape(shape[:dim] + (KVp * Gp * hd,) + shape[dim + 1:])


# a GQA mixer's leaves that head padding lays out again: (dim, whether
# the dim holds the q heads' groups)
_PADDED = {"wq": (1, True), "wk": (1, False), "wv": (1, False),
           "wo": (0, True), "bq": (0, True), "bk": (0, False),
           "bv": (0, False)}


def pad_logical(path: str, t, cfg: ModelConfig):
    """The leaf at ``path`` (``".../mixer/wq"``) of a padded model's
    params, zero-padded (``_pad_heads``) where ``t`` holds the logical
    heads, as ``init_gqa`` pads its draws; ``t`` itself elsewhere (a leaf
    at the padded or a shard's shape, any other leaf)."""
    parts = path.split("/")
    name = parts[-1]
    if name not in _PADDED or len(parts) < 2 or parts[-2] != "mixer":
        return t
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hp, KVp = eff_counts(cfg)
    dim, group = _PADDED[name]
    heads = H if group else KV
    if t.dim() <= dim or (H, KV) == (Hp, KVp) \
            or t.shape[dim] != heads * cfg.resolved_head_dim:
        return t
    g, gp = (H // KV, Hp // KVp) if group else (1, 1)
    return _pad_heads(t, dim, KV, g, KVp, gp)


def init_gqa(cfg: ModelConfig, w, vec) -> dict:
    """GQA params from the model's leaf makers: ``w(*shape)`` a seeded
    weight, ``vec(n, fill)`` a constant vector, each a leaf with
    ``then(fn)``, a post-draw transform (the reference's ``init_gqa``:
    biases start at 0, q/k norm gains at 1).  Under head padding each
    projection and bias is drawn at its logical shape, in the same order,
    then zero-padded (``_pad_heads``): a padded model's logical weights
    are the unpadded model's of the same seed."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hp, KVp = eff_counts(cfg)
    G, Gp = H // KV, Hp // KVp

    def pad(leaf, dim, group):
        if (H, KV) == (Hp, KVp):
            return leaf
        g, gp = (G, Gp) if group else (1, 1)
        return leaf.then(lambda t: _pad_heads(t, dim, KV, g, KVp, gp))

    p = {"wq": pad(w(cfg.d_model, H * hd), 1, True),
         "wk": pad(w(cfg.d_model, KV * hd), 1, False),
         "wv": pad(w(cfg.d_model, KV * hd), 1, False),
         "wo": pad(w(H * hd, cfg.d_model), 0, True)}
    if cfg.qkv_bias:
        p["bq"] = pad(vec(H * hd, 0.0), 0, True)
        p["bk"] = pad(vec(KV * hd, 0.0), 0, False)
        p["bv"] = pad(vec(KV * hd, 0.0), 0, False)
    if cfg.qk_norm:
        p["q_norm"] = vec(hd, 1.0)
        p["k_norm"] = vec(hd, 1.0)
    return p


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """(batch, max_len, KV_eff, hd) ``k`` and ``v``: the padded kv heads."""
    shape = (batch, max_len, eff_counts(cfg)[1], cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


GQA = dict(forward=gqa_forward, prefill=gqa_prefill,
           paged_prefill=gqa_paged_prefill, decode=gqa_decode,
           paged_decode=gqa_paged_decode, verify=gqa_verify,
           paged_verify=gqa_paged_verify)


# ---------------------------------------------------------------- cross

def init_cross(cfg: ModelConfig, w) -> dict:
    """Cross-attention params (the reference's ``init_cross``): queries
    from the decoder's d_model, keys and values from the memory's (the
    vision tokens are projected to d_model first)."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {"wq": w(cfg.d_model, H * hd), "wk": w(cfg.d_model, KV * hd),
            "wv": w(cfg.d_model, KV * hd), "wo": w(H * hd, cfg.d_model)}


def init_cross_cache(cfg: ModelConfig, batch: int, mem_len: int, dtype,
                     device) -> dict:
    """A cross layer's K/V: (batch, mem_len, KV, hd) a slot, written once
    by prefill and read by every decode step; the memory never grows, so
    it stays a slot under paging too."""
    shape = (batch, mem_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_kv(mem, p, cfg: ModelConfig, ctx: LayerCtx):
    """The memory (B, S, D) projected to K and V (B, S, KV, hd) once
    (fault site ``cross_qkv``, tags ``cross.k``/``cross.v``).  Under
    tensor parallelism ``wk``/``wv`` are column-parallel (the memory
    through ``copy_to_model``) and K/V hold the rank's kv heads, or every
    kv head where one spans ranks (gathered whole, as ``_qkv``'s).
    Returns (k, v, flag)."""
    B, S, _ = mem.shape
    hd = cfg.resolved_head_dim
    k, f1 = dense(mem, p["wk"], ctx, "cross_qkv", tag="cross.k",
                  par=tp_par(ctx, "cross/wk", "col"))
    v, f2 = dense(mem, p["wv"], ctx, "cross_qkv", tag="cross.v",
                  par=tp_par(ctx, "cross/wv", "col"))
    if k.shape[-1] % hd:
        k, v = gather_last(k, ctx.tp), gather_last(v, ctx.tp)
    return (k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd),
            or_flags(f1, f2))


def cross_forward(x, k, v, p, cfg: ModelConfig, ctx: LayerCtx):
    """Cross-attention: queries from x (B, L, D) against the memory's K/V,
    every query sees every memory position (plain chunked attention, as
    the reference's XLA path: no kernel).  Under tensor parallelism the
    rank runs its q heads (``wq`` column-parallel), against the kv heads
    they read, and ``wo`` is row-parallel.  Returns (out, flag)."""
    B, L, _ = x.shape
    hd = cfg.resolved_head_dim
    q, f1 = dense(x, p["wq"], ctx, "cross_qkv", tag="cross.q",
                  par=tp_par(ctx, "cross/wq", "col"))
    q = q.reshape(B, L, -1, hd)
    G = cfg.n_heads // cfg.n_kv_heads
    Hl = q.shape[2]
    if Hl != G * k.shape[2]:
        # every kv head on the rank: the ones its q heads group onto
        lo = ctx.tp.rank * Hl // G
        k, v = (t[:, :, lo:lo + max(1, Hl // G)] for t in (k, v))
    out = chunked_attention(q, k, v, causal=False)
    out, f2 = dense(out.reshape(B, L, -1), p["wo"], ctx, "cross_out",
                    tag="cross.o", par=tp_par(ctx, "cross/wo", "row"))
    return out, or_flags(f1, f2)


# ---------------------------------------------------------------- MLA

# the serving prefill's row block for the absorbed products: every call
# runs them on blocks of exactly this many rows, so a prompt row gets the
# same sums prefilled whole, as a suffix or in chunks
ABSORB_ROWS = 256


def _absorb(a, w, dtype, order=None):
    """The absorbed per-head product ``a`` (B, L, H, i) @ ``w`` (H, i, o)
    in f32, rounded to ``dtype`` (the reference's f32 einsum).  ``order``:
    None, one batched product over the B * L rows; ``"rows"`` (the serving
    prefill), blocks of ``ABSORB_ROWS`` rows, the last one zero-padded;
    ``"steps"`` (verify), one product a step ``a[:, t]`` at the decode
    step's (H, B, i) shape."""
    if order == "steps":
        return per_step(_absorb, a, w, dtype)
    B, L, H, i = a.shape
    af = a.to(F32).permute(2, 0, 1, 3).reshape(H, B * L, i)
    wf = w.to(F32)
    if order == "rows":
        n, r = B * L, ABSORB_ROWS
        # the coverage audit counts the logical product, not the padding
        with logical_scope("absorb", ((H * n, i, w.shape[-1]),)):
            af = torch.nn.functional.pad(af, (0, 0, 0, -(-n // r) * r - n))
            y = torch.cat([torch.bmm(af[:, s:s + r], wf)
                           for s in range(0, af.shape[1], r)], dim=1)[:, :n]
    else:
        y = torch.bmm(af, wf)
    return y.reshape(H, B, L, -1).permute(1, 2, 0, 3).to(dtype)


def _latent_norm(t, w, eps: float, order):
    """``rms_norm``; one step at a time under ``order == "steps"``."""
    if order == "steps":
        return per_step(rms_norm, t, w, eps)
    return rms_norm(t, w, eps)


def _mla_q(x, p, cfg: ModelConfig, ctx: LayerCtx, positions, order=None):
    """Absorbed queries (B, L, H, kv_lora + rope), the softmax scale and
    the flag.  The scale is the pre-absorption ``(dn + dr) ** -0.5``.
    ``order``: ``_absorb``'s; ``"steps"`` also runs the ``q_a`` norm one
    step at a time."""
    B, L, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qa, f1 = dense(x, p["wq_a"], ctx, "q_a", tag="mla.q_a")
    qa = _latent_norm(qa, p["q_a_norm"], cfg.norm_eps, order)
    q, f2 = dense(qa, p["wq_b"], ctx, "qkv", tag="mla.q_b",
                  par=tp_par(ctx, "mixer/wq_b", "col"))
    # the rank's heads (all of them unsharded): wq_b's columns, w_uk's rows
    q = q.reshape(B, L, -1, dn + dr)
    cos, sin, rot = rope_tables(positions, dr, cfg.rope_theta)
    q_pe = apply_rope(q[..., dn:], cos, sin, rot)
    # a weight-bearing product outside the matmul-ABFT surface: a known
    # gap of the coverage audit, as the reference marks it
    with coverage_scope("mla"):
        q_abs = _absorb(q[..., :dn], p["w_uk"], x.dtype, order)
    return (torch.cat([q_abs, q_pe], dim=-1), (dn + dr) ** -0.5,
            or_flags(f1, f2))


def _mla_latent(x, p, cfg: ModelConfig, ctx: LayerCtx, positions,
                order=None):
    """The latent rows (B, L, kv_lora + rope): the normed ``c_kv`` and
    ``k_pe`` roped as one head; ``"steps"`` runs the norm a step at a
    time."""
    c, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kv, f = dense(x, p["wkv_a"], ctx, "kv_a", tag="mla.kv_a")
    c_kv = _latent_norm(kv[..., :c].contiguous(), p["kv_a_norm"],
                        cfg.norm_eps, order)
    cos, sin, rot = rope_tables(positions, dr, cfg.rope_theta)
    k_pe = apply_rope(kv[:, :, None, c:], cos, sin, rot)[:, :, 0]
    return torch.cat([c_kv, k_pe], dim=-1), f


def _mla_attend(q_full, scale, latent, p, cfg: ModelConfig, ctx: LayerCtx,
                decode_len=None, lengths=None, q_offset=0, verify_len=None,
                spans=None, order=None):
    """Attention over ``latent`` (B, S, kv_lora + rope) as MQA: the keys
    are all of it, the values its first ``kv_lora_rank`` (a view, no
    copy); then the values' un-absorption through ``w_uv`` and ``wo``.
    ``verify_len``, ``decode_len`` or neither pick verify, decode or
    chunked attention (``spans``: row-wise), never a flash kernel.  A
    decode over a sequence-sharded latent attends the rank's positions
    and merges the ranks' partials (``_merge``) before ``w_uv``.  The
    latent is replicated and read by the rank's heads alone: in training
    it passes ``copy_to_model``, so ``wkv_a``, ``kv_a_norm`` and the
    residual stream get whole gradients."""
    B, L = q_full.shape[:2]
    if tp_par(ctx, "mixer/wq_b", "col") is not None:
        latent = copy_to_model(latent, ctx.tp)
    kv = latent[:, :, None, :]
    vv = latent[:, :, None, :cfg.kv_lora_rank]
    # the attention core and the values' un-absorption: no fused ABFT
    # kernel, a known gap of the coverage audit (``flops[mla]``)
    with coverage_scope("mla"):
        local = (_seq_len(decode_len, ctx) if decode_len is not None
                 else None)
        if verify_len is not None:
            o = verify_attention(q_full, kv, vv, verify_len, scale=scale)
        elif local is not None:
            o, lse = decode_attention(q_full, kv, vv, local, scale=scale,
                                      return_lse=True)
            o = _merge(o, lse, ctx)
        elif decode_len is not None:
            o = decode_attention(q_full, kv, vv, decode_len, scale=scale)
        else:
            o = chunked_attention(q_full, kv, vv, causal=True, scale=scale,
                                  lengths=lengths, q_offset=q_offset,
                                  spans=spans)
        out = _absorb(o, p["w_uv"], q_full.dtype, order)
    return dense(out.reshape(B, L, -1), p["wo"], ctx, "attn_out",
                 tag="mla.out", par=tp_par(ctx, "mixer/wo", "row"))


def mla_forward(x, p, cfg: ModelConfig, ctx: LayerCtx, positions):
    """Full-sequence causal MLA (training / scoring)."""
    q, scale, f1 = _mla_q(x, p, cfg, ctx, positions)
    latent, f2 = _mla_latent(x, p, cfg, ctx, positions)
    out, f3 = _mla_attend(q, scale, latent, p, cfg, ctx)
    return out, or_flags(f1, f2, f3)


def mla_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions, cache,
                slots=None, lengths=None, starts=None, spans=None):
    """``gqa_prefill`` for MLA: the latent rows land in ``cache["latent"]``
    (B, S_max, kv_lora + rope); ``starts`` attends the slots' cache rows.
    With ``spans`` (the serving prefill) the absorbed products run at
    ``ABSORB_ROWS``-row blocks."""
    order = "rows" if spans is not None else None
    q, scale, f1 = _mla_q(x, p, cfg, ctx, positions, order)
    latent, f2 = _mla_latent(x, p, cfg, ctx, positions)
    leaf = cache["latent"]
    if starts is None:
        out, f3 = _mla_attend(q, scale, latent, p, cfg, ctx,
                              lengths=lengths, spans=spans, order=order)
        if slots is None:
            slots = torch.arange(x.shape[0], device=x.device)
        _slot_prefill_write(leaf, latent, slots, x.shape[1], ctx)
    else:
        assert slots is not None, "chunked prefill needs slot targets"
        _slot_prefill_write_at(leaf, latent, slots, starts, lengths, ctx)
        out, f3 = _mla_attend(q, scale, _slot_rows(leaf, slots, ctx),
                              p, cfg, ctx, lengths=starts + lengths,
                              q_offset=starts, spans=spans, order=order)
    return out, or_flags(f1, f2, f3)


def mla_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache):
    """One-token MLA decode: each row writes its latent at its cursor and
    attends its own prefix."""
    q, scale, f1 = _mla_q(x, p, cfg, ctx, pos[:, None])
    latent, f2 = _mla_latent(x, p, cfg, ctx, pos[:, None])
    _row_scatter(cache["latent"], latent, pos, ctx)
    out, f3 = _mla_attend(q, scale, cache["latent"], p, cfg, ctx,
                          decode_len=pos + 1)
    return out, or_flags(f1, f2, f3)


def mla_verify(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache, index):
    """Speculative verify (``gqa_verify``'s contract): the window's
    latents land through ``index``; the latent norms and the absorbed
    products run one step at a time at the decode step's shapes."""
    positions = pos.long()[:, None] + torch.arange(x.shape[1],
                                                   device=x.device)
    q, scale, f1 = _mla_q(x, p, cfg, ctx, positions, "steps")
    latent, f2 = _mla_latent(x, p, cfg, ctx, positions, "steps")
    index_write(cache["latent"], latent, index)
    out, f3 = _mla_attend(q, scale, cache["latent"], p, cfg, ctx,
                          verify_len=pos + 1, order="steps")
    return out, or_flags(f1, f2, f3)


def mla_paged_prefill(x, p, cfg: ModelConfig, ctx: LayerCtx, positions,
                      cache, tables, lengths, starts=None, spans=None):
    """``gqa_paged_prefill`` for MLA: latent rows scatter into the
    (NB, BS, kv_lora + rope) pool through ``tables``."""
    order = "rows" if spans is not None else None
    q, scale, f1 = _mla_q(x, p, cfg, ctx, positions, order)
    latent, f2 = _mla_latent(x, p, cfg, ctx, positions)
    pool = cache["latent"]
    if starts is None:
        out, f3 = _mla_attend(q, scale, latent, p, cfg, ctx,
                              lengths=lengths, spans=spans, order=order)
        paged_scatter_prefill(pool, latent, tables, lengths)
    else:
        paged_scatter_prefill(pool, latent, tables, lengths, starts=starts)
        out, f3 = _mla_attend(q, scale, paged_gather(pool, tables), p, cfg,
                              ctx, lengths=starts + lengths,
                              q_offset=starts, spans=spans, order=order)
    return out, or_flags(f1, f2, f3)


def mla_paged_decode(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache,
                     tables):
    """Paged MLA decode: scatter at the cursor's block, attend the
    gathered latents."""
    q, scale, f1 = _mla_q(x, p, cfg, ctx, pos[:, None])
    latent, f2 = _mla_latent(x, p, cfg, ctx, pos[:, None])
    paged_scatter_decode(cache["latent"], latent[:, 0], tables, pos)
    out, f3 = _mla_attend(q, scale, paged_gather(cache["latent"], tables),
                          p, cfg, ctx, decode_len=pos + 1)
    return out, or_flags(f1, f2, f3)


def mla_paged_verify(x, p, cfg: ModelConfig, ctx: LayerCtx, pos, cache,
                     index, tables):
    """Paged speculative verify: ``mla_verify`` on the gathered latents."""
    positions = pos.long()[:, None] + torch.arange(x.shape[1],
                                                   device=x.device)
    q, scale, f1 = _mla_q(x, p, cfg, ctx, positions, "steps")
    latent, f2 = _mla_latent(x, p, cfg, ctx, positions, "steps")
    index_write(cache["latent"], latent, index)
    out, f3 = _mla_attend(q, scale, paged_gather(cache["latent"], tables),
                          p, cfg, ctx, verify_len=pos + 1, order="steps")
    return out, or_flags(f1, f2, f3)


MLA = dict(forward=mla_forward, prefill=mla_prefill,
           paged_prefill=mla_paged_prefill, decode=mla_decode,
           paged_decode=mla_paged_decode, verify=mla_verify,
           paged_verify=mla_paged_verify)


def init_mla(cfg: ModelConfig, w, vec) -> dict:
    """MLA params (the reference's ``init_mla`` leaves): the q and kv
    down-projections and their norms, ``wq_b``, the head-major
    up-projections ``w_uk`` (H, dn, c) and ``w_uv`` (H, c, dv), ``wo``."""
    H, d = cfg.n_heads, cfg.d_model
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    c = cfg.kv_lora_rank
    return {"wq_a": w(d, cfg.q_lora_rank),
            "q_a_norm": vec(cfg.q_lora_rank, 1.0),
            "wq_b": w(cfg.q_lora_rank, H * (dn + dr)),
            "wkv_a": w(d, c + dr), "kv_a_norm": vec(c, 1.0),
            "w_uk": w(H, dn, c), "w_uv": w(H, c, dv), "wo": w(H * dv, d)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    shape = (batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return {"latent": torch.zeros(shape, dtype=dtype, device=device)}
