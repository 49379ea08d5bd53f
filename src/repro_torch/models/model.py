"""Model assembly for GQA decoder stacks with dense or MoE FFNs (port of
the ``attn:dense:0`` and ``attn:moe:0`` part of ``repro.models.model``:
llama3.2-1b, the dense family qwen3-14b, stablelm-1.6b and qwen1.5-32b,
and qwen2-moe-a2.7b; mixed dense + MoE stacks such as
``first_dense_layers=1``).

The reference scans stacked per-segment params (``seg_plan``); the port
keeps one dict of tensors per layer and runs the stack as a Python loop.
``params_from_reference`` turns the reference's ``Model.init_params``
tree (converted to numpy) into the port's layout, segment by segment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    LayerCtx,
    dense,
    mlp,
    norm,
    or_flags,
    per_step,
)

F32 = torch.float32


def layer_tags(cfg: ModelConfig) -> list:
    """Per-layer "mixer:ffn:cross" tags (copy of the reference's)."""
    tags = []
    for i in range(cfg.n_layers):
        mixer = cfg.layer_kind(i)
        if mixer == "attn" and cfg.attention == "mla":
            mixer = "mla"
        ffn = cfg.ffn_kind(i) if (cfg.d_ff or cfg.n_experts) else "none"
        cross = (
            "1"
            if cfg.cross_attn_every
            and i % cfg.cross_attn_every == cfg.cross_attn_every - 2
            else "0"
        )
        tags.append(f"{mixer}:{ffn}:{cross}")
    return tags


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of layers: ``repeats`` copies of the tags in ``unit``."""

    unit: tuple
    repeats: int


def seg_plan(cfg: ModelConfig) -> list:
    """The reference's segment plan (copy): (a) the smallest period of
    the tags, (b) contiguous uniform runs (at most four), (c) one
    unrolled segment."""
    tags = layer_tags(cfg)
    n = len(tags)
    if n == 0:
        return []
    for p in range(1, min(12, n) + 1):
        if n % p == 0 and all(tags[i] == tags[i % p] for i in range(n)):
            return [Segment(unit=tuple(tags[:p]), repeats=n // p)]
    segs = []
    start = 0
    for i in range(1, n + 1):
        if i == n or tags[i] != tags[start]:
            segs.append(Segment(unit=(tags[start],), repeats=i - start))
            start = i
    if len(segs) <= 4:
        return segs
    return [Segment(unit=tuple(tags), repeats=1)]


def check_supported(cfg: ModelConfig) -> None:
    """The port runs GQA decoders with SwiGLU FFNs, dense or MoE (routed
    experts with optional shared ones) in any mix: RMSNorm or LayerNorm,
    with or without q/k norm, QKV biases and partial rotary
    (llama3.2-1b, qwen3-14b, stablelm-1.6b, qwen1.5-32b,
    qwen2-moe-a2.7b); anything else (MLA, SSM, encoder-decoder,
    cross-attention, MTP, TP head padding) is not ported."""
    ok = (cfg.attention == "gqa" and cfg.act == "silu"
          and cfg.norm in ("rmsnorm", "layernorm")
          and not cfg.pad_heads_to and not cfg.pad_kv_heads_to
          and not cfg.is_encoder_decoder and not cfg.mtp_depth
          and all(t in ("attn:dense:0", "attn:moe:0")
                  for t in layer_tags(cfg)))
    if not ok:
        raise NotImplementedError(
            f"architecture {cfg.name!r} is not ported: the PyTorch port "
            f"serves and trains GQA decoders with dense or MoE FFNs "
            f"(llama3.2-1b, qwen3-14b, stablelm-1.6b, qwen1.5-32b, "
            f"qwen2-moe-a2.7b)")


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(cfg: ModelConfig, np_params, *, device="cpu",
                          dtype=None) -> dict:
    """The reference's ``Model.init_params`` tree (leaves converted to
    numpy) -> the port's params.  ``segments[i]`` follows ``seg_plan``'s
    segment i; each of its ``pos{q}`` subtrees carries a leading
    ``repeats`` axis, and layer ``off + r * P + q`` is slice r of
    ``pos{q}`` (MoE leaves included: ``router``, ``w_up``, ``w_gate``,
    ``w_down``, ``shared``)."""
    check_supported(cfg)

    def conv(tree, r=None):
        if isinstance(tree, dict):
            return {k: conv(v, r) for k, v in tree.items()}
        return _to_torch(tree if r is None else np.asarray(tree)[r],
                         device, dtype)

    plan = seg_plan(cfg)
    if len(plan) != len(np_params["segments"]):
        raise ValueError(f"{len(np_params['segments'])} segments in the "
                         f"tree, {len(plan)} in {cfg.name!r}'s plan")
    layers = []
    for seg, sp in zip(plan, np_params["segments"]):
        reps = np.asarray(sp["pos0"]["mixer_norm"]["w"]).shape[0]
        if len(sp) != len(seg.unit) or reps != seg.repeats:
            raise ValueError(f"segment of {len(sp)} x {reps} layers where "
                             f"the plan has {len(seg.unit)} x "
                             f"{seg.repeats}")
        for r in range(seg.repeats):
            for q in range(len(seg.unit)):
                layers.append(conv(sp[f"pos{q}"], r))
    out = {"embed": conv(np_params["embed"]),
           "final_norm": conv(np_params["final_norm"]), "layers": layers}
    if "lm_head" in np_params:
        out["lm_head"] = conv(np_params["lm_head"])
    return out


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    flag: torch.Tensor
    aux_loss: torch.Tensor
    mtp_logits: object = None


class Model:
    """Eager model wrapper for one GQA architecture (dense or MoE FFNs)."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    # -------------------------------------------------- init
    def init_params(self, seed: int = 0, dtype=torch.bfloat16,
                    device="cpu") -> dict:
        """Seeded N(0, 0.02) weights (the reference's init law; a torch
        generator, so not the reference's numbers), unit norm and q/k
        norm gains, zero LayerNorm shifts and QKV biases; a dense or an
        MoE FFN a layer as ``layer_tags`` says."""
        cfg = self.cfg
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def w(*shape):
            return (0.02 * torch.randn(shape, generator=gen, dtype=F32,
                                       device=device)).to(dtype)

        def vec(n, fill):
            return torch.full((n,), fill, dtype=dtype, device=device)

        def norm_p():
            p = {"w": vec(cfg.d_model, 1.0)}
            if cfg.norm == "layernorm":
                p["b"] = vec(cfg.d_model, 0.0)
            return p

        params = {"embed": w(cfg.vocab_size, cfg.d_model),
                  "final_norm": norm_p(), "layers": []}
        for tag in layer_tags(cfg):
            ffn = (moe_mod.init_moe(cfg, w) if tag == "attn:moe:0" else
                   {"up": w(cfg.d_model, cfg.d_ff),
                    "gate": w(cfg.d_model, cfg.d_ff),
                    "down": w(cfg.d_ff, cfg.d_model)})
            params["layers"].append({
                "mixer_norm": norm_p(),
                "mixer": attn.init_gqa(cfg, w, vec),
                "ffn_norm": norm_p(),
                "ffn": ffn,
            })
        if not cfg.tie_embeddings:
            params["lm_head"] = w(cfg.d_model, cfg.vocab_size)
        return params

    # -------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cpu") -> list:
        return [attn.init_gqa_cache(self.cfg, batch, max_len, dtype, device)
                for _ in range(self.cfg.n_layers)]

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device="cpu") -> list:
        from repro_torch.serve.paged_cache import init_paged_gqa_cache

        return [init_paged_gqa_cache(self.cfg, num_blocks, block_size, dtype,
                                     device)
                for _ in range(self.cfg.n_layers)]

    # -------------------------------------------------- layers
    def apply_layer(self, x, lp, ctx: LayerCtx, positions, mode: str, cache,
                    pos=None, slots=None, lengths=None, tables=None,
                    prefix_lens=None, spans=None, window=None):
        """One decoder layer (mode: full | prefill | decode | verify).
        ``full`` is causal attention over the whole sequence with no cache
        (the training/scoring forward).  ``prefix_lens`` (prefill): the
        logical start of each row's tokens (a suffix or a chunk);
        ``spans``: each row's (start, end) on the host for row-wise
        attention.  ``verify``: T tokens a row from cursor ``pos``, written
        to the cache through ``window`` (the call's write index); its
        d_model norms run one step at a time at decode's shapes
        (``per_step``).  An MoE FFN (its params hold a ``router``) routes
        the call's tokens, padding rows included, as the reference's.
        Returns (x, flag, aux): aux the MoE FFN's load-balance loss,
        None for a dense FFN (only ``forward`` reads it)."""
        cfg = self.cfg
        nrm = functools.partial(per_step, norm) if mode == "verify" else norm
        h = nrm(x, lp["mixer_norm"], cfg.norm, cfg.norm_eps)
        if mode == "full":
            a, f = attn.gqa_forward(h, lp["mixer"], cfg, ctx, positions)
        elif mode == "prefill":
            if tables is not None:
                a, f = attn.gqa_paged_prefill(h, lp["mixer"], cfg, ctx,
                                              positions, cache, tables,
                                              lengths, starts=prefix_lens,
                                              spans=spans)
            else:
                a, f = attn.gqa_prefill(h, lp["mixer"], cfg, ctx, positions,
                                        cache, slots=slots, lengths=lengths,
                                        starts=prefix_lens, spans=spans)
        elif mode == "verify":
            if tables is not None:
                a, f = attn.gqa_paged_verify(h, lp["mixer"], cfg, ctx, pos,
                                             cache, window, tables)
            else:
                a, f = attn.gqa_verify(h, lp["mixer"], cfg, ctx, pos, cache,
                                       window)
        elif tables is not None:
            a, f = attn.gqa_paged_decode(h, lp["mixer"], cfg, ctx, pos,
                                         cache, tables)
        else:
            a, f = attn.gqa_decode(h, lp["mixer"], cfg, ctx, pos, cache)
        x = x + a
        h = nrm(x, lp["ffn_norm"], cfg.norm, cfg.norm_eps)
        aux = None
        if "router" in lp["ffn"]:
            if mode == "verify":
                raise NotImplementedError(
                    "speculative verify on MoE layers is not ported")
            o, f2, aux = moe_mod.moe_forward(h, lp["ffn"], cfg, ctx)
        else:
            o, f2 = mlp(h, lp["ffn"], ctx, act=cfg.act)
        return x + o, or_flags(f, f2), aux

    def run_stack(self, x, params, ctx: LayerCtx, positions, mode: str,
                  caches, pos=None, slots=None, lengths=None, tables=None,
                  remat: bool = False, prefix_lens=None, spans=None,
                  window=None):
        """The layer loop.  ``caches`` is None in mode ``full``.  ``remat``
        recomputes each layer in the backward pass instead of keeping its
        activations (the reference's ``jax.checkpoint`` per layer); it
        changes no number and applies only while autograd records.
        Returns (x, flag, aux): aux the MoE layers' load-balance losses
        summed (0 without any)."""
        layers = params["layers"]
        caches = caches if caches is not None else [None] * len(layers)
        remat = remat and torch.is_grad_enabled()
        flags, auxes = [], []
        for i, (lp, cache) in enumerate(zip(layers, caches)):
            kw = dict(pos=pos, slots=slots, lengths=lengths, tables=tables,
                      prefix_lens=prefix_lens, spans=spans, window=window)
            args = (x, lp, ctx.with_layer(i), positions, mode, cache)
            if remat:
                x, f, a = checkpoint(self.apply_layer, *args,
                                     use_reentrant=False, **kw)
            else:
                x, f, a = self.apply_layer(*args, **kw)
            flags.append(f)
            if a is not None:
                auxes.append(a)
        aux = (torch.stack(auxes).sum() if auxes
               else torch.zeros((), dtype=F32, device=x.device))
        return x, torch.stack(flags).any(), aux

    def _head(self, params, x, ctx):
        w = (params["embed"].t().to(x.dtype) if self.cfg.tie_embeddings
             else params["lm_head"])
        return dense(x, w, ctx, "lm_head", out_dtype=F32)

    # -------------------------------------------------- forward (train)
    def forward(self, params, batch, ctx: LayerCtx,
                device=None) -> ForwardOut:
        """Full-sequence causal forward (training and scoring).  batch:
        {"tokens": (B, L)}; returns ForwardOut with f32 logits (B, L, V)
        and the OR of every GEMM's and attention's flag.  Runs on
        ``device`` (CUDA unless the caller passes ``"cpu"``), where the
        params must already live.  Encoder memory and vision inputs are not
        ported."""
        from repro_torch.serve.executor import resolve_device

        dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"forward runs on {dev}")
        extra = set(batch) - {"tokens", "labels"}
        if extra:
            raise NotImplementedError(
                f"batch inputs {sorted(extra)} (encoder memory / vision) "
                f"are not ported")
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(dev).long()
        B, L = tokens.shape
        x = params["embed"][tokens]
        positions = torch.arange(L, device=dev).expand(B, L)
        x, flag, aux = self.run_stack(x, params, ctx, positions, "full",
                                      None, remat=True)
        x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits, f_head = self._head(params, x, ctx)
        return ForwardOut(logits=logits, flag=or_flags(flag, f_head),
                          aux_loss=aux)

    # -------------------------------------------------- sharing / chunking
    @property
    def supports_prefix_sharing(self) -> bool:
        """A token's cached KV is a pure function of the token prefix in
        an attention-only decoder without per-request memory — every
        stack the port runs (``check_supported``) — with one caveat the
        reference shares: an MoE layer's capacity, and so which tokens
        its experts drop, depends on every token in the call, so a shared
        or chunked MoE stream follows the reference's, not the plain
        run's."""
        cfg = self.cfg
        return not (cfg.is_encoder_decoder or cfg.vision_dim
                    or cfg.cross_attn_every)

    @property
    def supports_chunked_prefill(self) -> bool:
        """A prompt resumes mid-sequence from resident KV: the same
        condition as prefix sharing."""
        return self.supports_prefix_sharing

    def copy_paged_blocks(self, cache, src, dst) -> list:
        """``pool[dst[i]] <- pool[src[i]]`` on every layer's k and v pool,
        in place — the COW payload move."""
        dev = cache[0]["k"].device
        src = torch.as_tensor(src, dtype=torch.long, device=dev)
        dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
        for layer in cache:
            for leaf in layer.values():
                leaf[dst] = leaf[src]
        return cache

    # -------------------------------------------------- prefill / decode
    def prefill(self, params, tokens, cache, ctx: LayerCtx, slots=None,
                lengths=None, block_tables=None, prefix_lens=None):
        """Prefill ``cache`` from tokens (B, L).  With ``slots``/``lengths``
        the cache is engine-deep and rows are ragged prompts padded to L;
        logits come from each row's last valid token.  ``block_tables``
        (B, W) selects the paged pools.  ``prefix_lens`` (B,): tokens hold
        only each row's tail (the suffix of a shared prefix, or one
        chunk), whose first token sits at logical position
        ``prefix_lens[b]``; rotary, causal masks and cache targets follow
        the logical positions.  With ``lengths``, attention runs row by row
        (``chunked_attention(spans=...)``) on each row's span, read to the
        host once here.  Returns (logits (B, 1, V) f32, cache, flag); the
        cache is updated in place."""
        cfg = self.cfg
        B, L = tokens.shape
        x = params["embed"][tokens]
        positions = torch.arange(L, device=tokens.device).expand(B, L)
        if prefix_lens is not None:
            positions = prefix_lens.to(tokens.device).long()[:, None] \
                + positions
        spans = None
        if lengths is not None:
            lens = lengths.tolist()
            offs = prefix_lens.tolist() if prefix_lens is not None \
                else [0] * B
            spans = [(o, o + n) for o, n in zip(offs, lens)]
        x, flag, _ = self.run_stack(x, params, ctx, positions, "prefill",
                                    cache, slots=slots, lengths=lengths,
                                    tables=block_tables,
                                    prefix_lens=prefix_lens, spans=spans)
        x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        if lengths is not None:
            idx = (lengths.to(x.device).long() - 1).clamp_min(0)
            last = x[torch.arange(B, device=x.device), idx][:, None]
        else:
            last = x[:, -1:, :]
        logits, f_head = self._head(params, last, ctx)
        return logits, cache, or_flags(flag, f_head)

    def decode(self, params, token, cache, pos, ctx: LayerCtx,
               block_tables=None):
        """token: (B, 1); pos: (B,) per-slot cursor.  Each row writes its
        KV at its own cursor and attends its own prefix.  Returns
        (logits (B, 1, V) f32, cache, flag)."""
        cfg = self.cfg
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=token.device).expand(B).contiguous()
        x = params["embed"][token]
        x, flag, _ = self.run_stack(x, params, ctx, None, "decode", cache,
                                    pos=pos, tables=block_tables)
        x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits, f_head = self._head(params, x, ctx)
        return logits, cache, or_flags(flag, f_head)

    def verify(self, params, tokens, cache, pos, ctx: LayerCtx, valid,
               block_tables=None):
        """Speculative verify: score T = K+1 positions a slot in one call.
        tokens: (B, T), row b its last committed token and its (padded)
        draft window; pos: (B,) cursors; ``valid`` (B,): the usable window
        a row (K_b + 1); rows past it write no cache cell and their logits
        are discarded.  Token t of row b sits at ``pos[b] + t``, its k/v
        land there and logits[b, t] predicts position ``pos[b] + t + 1``.
        Every row is computed in the decode step's order (d_model norms
        and attention one step at a time, K1 pinned to the B-row GEMM and
        the plain product run step by step through
        ``ABFTConfig.decode_rows``, which the runner sets), so row t's
        logits are bit for bit decode's at that position.  Returns (logits
        (B, T, V) f32, cache, flag)."""
        from repro_torch.serve.paged_cache import prefill_write_index

        cfg = self.cfg
        B, T = tokens.shape
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=tokens.device).expand(B).contiguous()
        pool = cache[0]["k"]
        # every layer writes the same cells: one index a call
        window = (attn.verify_write_index(pos, valid, T, pool.shape[1])
                  if block_tables is None else
                  prefill_write_index(pool, block_tables, valid, T, pos))
        x = params["embed"][tokens]
        x, flag, _ = self.run_stack(x, params, ctx, None, "verify", cache,
                                    pos=pos, tables=block_tables,
                                    window=window)
        x = per_step(norm, x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits, f_head = self._head(params, x, ctx)
        return logits, cache, or_flags(flag, f_head)

    def protection_plan(self, hw, policy=None, *, phase: str = "serve",
                        n_tokens: int = 1, dtype_bytes: int = 2):
        from repro_torch.core.policy import ProtectionPlan

        return ProtectionPlan.for_model(self.cfg, hw=hw, policy=policy,
                                        phase=phase, n_tokens=n_tokens,
                                        dtype_bytes=dtype_bytes)
