"""Model assembly for decoder stacks of GQA, MLA and Mamba2 mixers with
dense, MoE or no FFNs, and GQA layers with cross-attention to a
per-request memory (port of ``repro.models.model``: llama3.2-1b, the
dense family qwen3-14b, stablelm-1.6b and qwen1.5-32b, qwen2-moe-a2.7b,
deepseek-v3-671b with its multi-token prediction head, the SSM stack
mamba2-1.3b and the hybrid jamba-v0.1-52b; mixed dense + MoE stacks such
as ``first_dense_layers=3``; the encoder-decoder whisper-tiny, whose
memory is its encoder's output, and llama-3.2-vision-11b, whose memory is
its projected image tokens, read by a cross layer every 5th layer).

The memory is an input beside the tokens (``Model.forward``'s batch,
``Model.prefill``'s ``inputs``): ``audio`` log-mel frames through the
conv stem or ``enc_input`` frames for whisper, ``images`` patch
embeddings for the vision model.  As in the reference, whisper's decoder
never reads its encoder's output (no layer of it has cross-attention:
only the encoder's ABFT flag reaches the result), and a cross layer's
``cross_gate`` starts at 0, so its images reach the logits only once the
gate is trained away from 0.

The reference scans stacked per-segment params (``seg_plan``); the port
keeps one dict of tensors per layer and runs the stack as a Python loop.
``params_from_reference`` turns the reference's ``Model.init_params``
tree (converted to numpy) into the port's layout, segment by segment.

Tensor parallelism: ``Model.shard_params`` slices a full tree into one
rank's shard by ``distributed.sharding.param_specs``, and
``Model.init_params(mesh=)`` draws the same shard leaf by leaf without
ever holding the whole tree.  The embedding is
vocab-sharded (``embed: P("model", d)``): a lookup is a masked local
lookup, zero where another rank owns the token, summed over the model
axis (exact: x + 0 = x); the head is column-parallel over the vocab, its
f32 logits gathered whole for the sampler (``embed_tokens``, ``_head``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.analysis.markers import coverage_scope, layer_scope
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_reduce_sum, gather_last
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    LayerCtx,
    dense,
    fsdp_leaf,
    fsdp_view,
    gelu,
    mlp,
    norm,
    or_flags,
    per_step,
    tp_par,
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


TAGS = ("attn:dense:0", "attn:moe:0", "mla:dense:0", "mla:moe:0",
        "mamba:none:0", "mamba:dense:0", "mamba:moe:0", "attn:dense:1")
# a cross layer's gate: an f32 scalar whatever the model's dtype
F32_LEAVES = mb.F32_LEAVES + ("cross_gate",)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs GQA, MLA or Mamba2 decoders with SwiGLU FFNs, dense,
    MoE (routed experts with optional shared ones) or none, in any mix:
    RMSNorm or LayerNorm, with or without q/k norm, QKV biases and partial
    rotary, and at most one multi-token prediction head (llama3.2-1b,
    qwen3-14b, stablelm-1.6b, qwen1.5-32b, qwen2-moe-a2.7b,
    deepseek-v3-671b, mamba2-1.3b, jamba-v0.1-52b); MLA needs its latent
    ranks and head dims, Mamba2 its state and head dims.  A GQA stack may
    have dense GELU FFNs with biases, an encoder and its memory
    (whisper-tiny) or cross-attention layers over projected vision tokens
    (llama-3.2-vision-11b).  A GQA stack may pad its heads for TP
    (``pad_heads_to``/``pad_kv_heads_to``, ``attention.eff_counts``).  MTP
    deeper than 1 is not ported."""
    mla_dims = (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                cfg.qk_rope_head_dim, cfg.v_head_dim)
    memory = cfg.is_encoder_decoder or cfg.vision_dim or cfg.cross_attn_every
    ok = (cfg.attention in ("gqa", "mla")
          and (cfg.act == "silu" or cfg.act == "gelu" and not cfg.n_experts)
          and (cfg.attention == "gqa" or all(d > 0 for d in mla_dims))
          and (cfg.attention == "gqa" or not memory)
          and (not cfg.cross_attn_every or cfg.vision_dim
               or cfg.is_encoder_decoder)
          and cfg.norm in ("rmsnorm", "layernorm")
          and cfg.mtp_depth <= 1
          and all(t in TAGS for t in layer_tags(cfg))
          and (cfg.ssm_state > 0 and cfg.ssm_head_dim > 0
               and cfg.d_inner % cfg.ssm_head_dim == 0
               or not any(t.startswith("mamba") for t in layer_tags(cfg))))
    if not ok:
        raise NotImplementedError(
            f"architecture {cfg.name!r} is not ported: the PyTorch port "
            f"runs GQA, MLA and Mamba2 decoders with dense, MoE or no FFNs "
            f"and GQA stacks with encoder or vision memory (llama3.2-1b, "
            f"qwen3-14b, stablelm-1.6b, qwen1.5-32b, qwen2-moe-a2.7b, "
            f"deepseek-v3-671b, mamba2-1.3b, jamba-v0.1-52b, whisper-tiny, "
            f"llama-3.2-vision-11b)")


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _layer_kind(lp) -> str:
    """The "mixer:ffn:cross" tag a layer's params make: a Mamba2 mixer
    holds ``A_log``, an MLA one ``wkv_a``; an MoE FFN holds a ``router``; a
    layer without an FFN has no ``ffn``; a cross layer holds ``cross``."""
    mx = lp["mixer"]
    mixer = "mamba" if "A_log" in mx else "mla" if "wkv_a" in mx else "attn"
    ffn = ("none" if "ffn" not in lp
           else "moe" if "router" in lp["ffn"] else "dense")
    return f"{mixer}:{ffn}:{int('cross' in lp)}"


def _enc_plan(cfg: ModelConfig) -> list:
    """The reference's encoder plan: ``n_enc_layers`` GQA layers with
    dense FFNs, no cross-attention."""
    return ([Segment(unit=("attn:dense:0",), repeats=cfg.n_enc_layers)]
            if cfg.is_encoder_decoder else [])


def params_from_reference(cfg: ModelConfig, np_params, *, device="cpu",
                          dtype=None) -> dict:
    """The reference's ``Model.init_params`` tree (leaves converted to
    numpy) -> the port's params.  ``segments[i]`` follows ``seg_plan``'s
    segment i; each of its ``pos{q}`` subtrees carries a leading
    ``repeats`` axis, and layer ``off + r * P + q`` is slice r of
    ``pos{q}`` (MoE leaves included: ``router``, ``w_up``, ``w_gate``,
    ``w_down``, ``shared``; a cross layer's ``cross``, ``cross_norm`` and
    ``cross_gate``).  The MTP head's ``mtp`` subtree (``proj``,
    ``layer``, ``norm``), the conv stem's ``conv_stem`` and the
    ``vision_proj`` weight have no repeats axis and cross over whole; the
    ``encoder``'s segments follow the encoder plan, as the decoder's do
    ``seg_plan``, beside its ``final_norm``.  A Mamba2 mixer's ``A_log``,
    ``D`` and ``dt_bias`` and a cross layer's ``cross_gate`` stay f32
    whatever ``dtype``, as the reference keeps them; each segment position
    must hold the mixer, the FFN and the cross-attention its tag names."""
    check_supported(cfg)

    def conv(tree, r=None, key=None):
        if isinstance(tree, dict):
            return {k: conv(v, r, k) for k, v in tree.items()}
        return _to_torch(tree if r is None else np.asarray(tree)[r],
                         device, None if key in F32_LEAVES else dtype)

    def layers(plan, segments):
        if len(plan) != len(segments):
            raise ValueError(f"{len(segments)} segments in the tree, "
                             f"{len(plan)} in {cfg.name!r}'s plan")
        out = []
        for seg, sp in zip(plan, segments):
            reps = np.asarray(sp["pos0"]["mixer_norm"]["w"]).shape[0]
            if len(sp) != len(seg.unit) or reps != seg.repeats:
                raise ValueError(f"segment of {len(sp)} x {reps} layers "
                                 f"where the plan has {len(seg.unit)} x "
                                 f"{seg.repeats}")
            for q, tag in enumerate(seg.unit):
                kind = _layer_kind(sp[f"pos{q}"])
                if kind != tag:
                    raise ValueError(f"segment position {q} holds a {kind} "
                                     f"layer where the plan has {tag}")
            for r in range(seg.repeats):
                for q in range(len(seg.unit)):
                    out.append(conv(sp[f"pos{q}"], r))
        return out

    out = {"embed": conv(np_params["embed"]),
           "final_norm": conv(np_params["final_norm"]),
           "layers": layers(seg_plan(cfg), np_params["segments"])}
    for key in ("lm_head", "mtp", "conv_stem", "vision_proj"):
        if key in np_params:
            out[key] = conv(np_params[key])
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = {"layers": layers(_enc_plan(cfg), enc["segments"]),
                          "final_norm": conv(enc["final_norm"])}
    return out


def sinusoid_pos(positions, d_model: int):
    """Whisper's sinusoidal position encoding (the reference's): positions
    (B, L) -> (B, L, d_model) f32, ``d_model / 2`` frequencies
    ``exp(-ln(1e4) i / max(d_model / 2 - 1, 1))``, sines then cosines."""
    half = d_model // 2
    dev = positions.device
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, dtype=F32,
                                              device=dev))
                      * torch.arange(half, dtype=F32, device=dev)
                      / max(half - 1, 1))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _conv_same(x, w, stride: int):
    """``lax.conv_general_dilated(..., padding="SAME")`` of x (B, C, T)
    with a WIO weight (W, C, O): a cross-correlation, as ``F.conv1d`` is,
    padded as XLA pads SAME, the extra cell (if the total is odd) at the
    end: a width-3 window at stride 2 pads (0, 1) on an even T and (1, 1)
    on an odd one (``padding="same"`` refuses a stride).  Returns
    (B, O, ceil(T / stride))."""
    T, width = x.shape[-1], w.shape[0]
    total = max((-(-T // stride) - 1) * stride + width - T, 0)
    x = torch.nn.functional.pad(x, (total // 2, total - total // 2))
    return torch.nn.functional.conv1d(x, w.permute(2, 1, 0), stride=stride)


def cell_leaves(layer: dict) -> list:
    """A layer cache's leaves a serving call writes at its cells (GQA's
    ``k`` and ``v``, MLA's ``latent``) or a slot's recurrent state, in
    their order: every leaf but a cross layer's ``cross`` K/V, which is
    written once a request by its prefill and read by decode."""
    return [t for k, t in layer.items() if k != "cross"]


def _cut(t, index):
    """``t[index]`` in storage of its own: a slice along the leading dim is
    a contiguous view that would keep the whole leaf alive; an index that
    takes all of ``t`` gives ``t``."""
    part = t[index]
    if part.numel() == t.numel():
        return t
    return part.clone(memory_format=torch.contiguous_format)


# a weight of more elements is drawn in slices of its leading axis of at
# most this many (its f32 draw never needs 4 bytes an element beside the
# model)
DRAW_SLICE = 1 << 30


class _Leaf:
    """One leaf of ``Model._param_tree``: a weight drawn N(0, ``scale``)
    in f32 and cast to the init dtype, or (``scale`` None) a constant
    ``fill``; ``dtype`` None is the init dtype.  ``then(fn)``: the same
    draw followed by ``fn`` (TP head padding), ``shape`` the result's."""

    __slots__ = ("shape", "scale", "fill", "dtype", "draw", "post")

    def __init__(self, shape, scale=None, fill=0.0, dtype=None):
        self.shape = self.draw = tuple(shape)
        self.scale, self.fill, self.dtype = scale, fill, dtype
        self.post = None

    def then(self, fn) -> "_Leaf":
        out = _Leaf(self.draw, self.scale, self.fill, self.dtype)
        out.post = fn
        out.shape = tuple(fn(torch.empty(self.draw, device="meta")).shape)
        return out

    def make(self, gen, dtype, device, index=()):
        """The leaf, or only its part ``index`` (a tuple of slices, one a
        leading dim: a rank's shard) in storage of its own; either way
        ``gen`` advances as for the whole leaf, so the leaves after it
        draw the same numbers.  The part of a weight drawn in slices
        (above ``DRAW_SLICE`` elements) is copied out slice by slice, its
        other dims cut from each slice: the whole leaf is never resident,
        whichever of its dims the shard splits.  A padded leaf (``then``)
        is drawn whole and cut."""
        dtype = self.dtype or dtype
        index = tuple(index)
        if self.post is not None:
            return _cut(self.post(self._make(gen, dtype, device, ())),
                        index)
        return self._make(gen, dtype, device, index)

    def _make(self, gen, dtype, device, index):
        shape = self.draw
        full = tuple(index) + (slice(None),) * (len(shape) - len(index))
        part = tuple(len(range(*sl.indices(n))) for sl, n in zip(full, shape))
        if self.scale is None:
            return torch.full(part, self.fill, dtype=dtype, device=device)
        if math.prod(shape) <= DRAW_SLICE:
            t = torch.randn(shape, generator=gen, dtype=F32, device=device)
            return _cut(t.mul_(self.scale).to(dtype), full)
        lo, hi, _ = full[0].indices(shape[0])
        rest = (slice(None),) + full[1:]
        out = torch.empty(part, dtype=dtype, device=device)
        step = max(1, DRAW_SLICE // math.prod(shape[1:]))
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            chunk = torch.randn((n,) + shape[1:], generator=gen, dtype=F32,
                                device=device).mul_(self.scale)
            a, b = max(i, lo), min(i + n, hi)
            if a < b:
                out[a - lo:b - lo] = chunk[a - i:b - i][rest]
        return out


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    flag: torch.Tensor
    aux_loss: torch.Tensor
    mtp_logits: object = None


class Model:
    """Eager model wrapper for one architecture of ``check_supported``."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        if cfg.pad_heads_to or cfg.pad_kv_heads_to:
            attn.eff_counts(cfg)        # a valid TP head padding, or raise
        self.cfg = cfg
        tags = layer_tags(cfg)
        # per layer: whether its cache is a Mamba2 layer's per-slot state,
        # whether it has cross-attention (and a cross K/V a slot)
        self.state_layers = tuple(t.startswith("mamba") for t in tags)
        self.cross_layers = tuple(t.endswith(":1") for t in tags)

    @property
    def memory_inputs(self) -> tuple:
        """The batch inputs ``_memory`` reads, besides the tokens:
        whisper's ``audio`` (log-mel frames, through the conv stem) or
        ``enc_input`` (frames at d_model), the vision model's ``images``
        (patch embeddings at ``vision_dim``); none elsewhere."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            return ("audio", "enc_input") if cfg.n_mels else ("enc_input",)
        return ("images",) if cfg.vision_dim else ()

    def for_mesh(self, mesh) -> "Model":
        """This model as ``mesh`` lays it out: ``self``, or a model of
        ``executor.layout_config``'s config (GQA heads padded where the
        rules would split one).  Its params are the logical model's,
        zero-padded (``shard_params`` pads a logical tree)."""
        from repro_torch.serve.executor import layout_config

        cfg = layout_config(self.cfg, mesh)
        return self if cfg is self.cfg else Model(cfg)

    # -------------------------------------------------- init
    def init_params(self, seed: int = 0, dtype=torch.bfloat16,
                    device="cpu", mesh=None) -> dict:
        """Seeded N(0, 0.02) weights (the reference's init law; a torch
        generator, so not the reference's numbers), unit norm, q/k norm
        and latent norm gains, zero LayerNorm shifts and QKV biases; a
        GQA, MLA or Mamba2 mixer and a dense, an MoE or no FFN a layer as
        ``layer_tags`` says (``mamba.init_mamba``'s laws for that mixer);
        with ``mtp_depth`` the MTP head (``proj`` (2 d, d), a layer of the
        last layer's kind, an RMSNorm gain).  A ``gelu`` FFN has ``up``
        and ``down`` with zero biases ``up_b`` and ``down_b``; a cross
        layer has ``cross`` (``attention.init_cross``), ``cross_norm`` and
        an f32 ``cross_gate`` of 0 (the reference's: its cross-attention
        adds nothing until the gate moves).  whisper gets its ``encoder``
        (``n_enc_layers`` layers and a LayerNorm) and, with ``n_mels``,
        its ``conv_stem`` (WIO weights (3, n_mels, d) and (3, d, d), zero
        biases); the vision model its ``vision_proj`` (vision_dim, d).  A
        weight of more than ``DRAW_SLICE`` elements (deepseek-v3's expert
        stacks) is drawn in slices of its leading axis, so its f32 draw
        never needs 4 bytes an element beside the model.

        ``mesh`` (a port ``Mesh``): this process's shard only, equal bit
        for bit to ``shard_params(init_params(seed), mesh)``.  Each leaf
        is drawn on ``device`` in the same order from the same generator:
        a leaf of at most ``DRAW_SLICE`` elements is drawn whole, its
        rank's part copied out (``_cut``) and the rest freed before the
        next leaf; a larger one (deepseek-v3's expert stacks) is drawn one
        slice of its leading axis at a time, the rank's part of each slice
        kept, whichever dims the shard splits (under FSDP the data axis
        splits a dim other than the first: ``embed`` (vocab, d) over
        ``("model", "data")``, the experts' D).  So no more than one
        leaf's f32 draw of ``DRAW_SLICE`` elements is ever resident beside
        the shard (``draw_transient``).  The shard is of ``for_mesh``'s
        model: heads padded where the mesh needs it."""
        from repro_torch.distributed.sharding import (
            map_with_path,
            param_specs,
            shard_slices,
        )

        if mesh is not None:
            laid = self.for_mesh(mesh)
            if laid is not self:
                return laid.init_params(seed, dtype, device, mesh=mesh)
        tree = self._param_tree()
        gen = torch.Generator(device=device).manual_seed(int(seed))
        if mesh is not None:
            specs, coords = {}, mesh.coords()
            map_with_path(lambda ps, sp: specs.__setitem__(ps, sp),
                          param_specs(self.cfg, tree, mesh))

        cuda = torch.device(device).type == "cuda"

        def make(ps, leaf):
            if mesh is None:
                return leaf.make(gen, dtype, device)
            t = leaf.make(gen, dtype, device,
                          shard_slices(specs[ps], leaf.shape, mesh, coords))
            if cuda:
                # hand the leaf's transients back to the card at once: the
                # other ranks sharing it draw beside this one, and a later
                # small allocation carved from a cached transient would pin
                # it for good
                torch.cuda.empty_cache()
            return t

        return map_with_path(make, tree)

    def draw_transient(self) -> tuple:
        """(bytes, path) of the largest transient ``init_params`` holds
        beside the shard it keeps, whatever the mesh: a leaf of at most
        ``DRAW_SLICE`` elements drawn whole in f32 beside its cast copy
        (6 bytes an element at bf16; a padded leaf's, before padding), or
        one f32 slice of a larger leaf's leading axis."""
        from repro_torch.distributed.sharding import map_with_path

        out = []

        def one(ps, leaf):
            if leaf.scale is None:
                return
            n = math.prod(leaf.draw)
            if n > DRAW_SLICE:
                row = math.prod(leaf.draw[1:])
                out.append((max(1, DRAW_SLICE // row) * row * 4, ps))
            else:
                out.append((n * 6, ps))

        map_with_path(one, self._param_tree())
        return max(out)

    def param_shapes(self, dtype=torch.bfloat16) -> dict:
        """``init_params``' tree as tensors on the meta device (shapes and
        dtypes, no data)."""
        from repro_torch.distributed.sharding import map_with_path

        return map_with_path(
            lambda _, leaf: torch.empty(leaf.shape, dtype=leaf.dtype or dtype,
                                        device="meta"), self._param_tree())

    def _param_tree(self) -> dict:
        """``init_params``' tree with a ``_Leaf`` (what to draw or fill) at
        each leaf, in the order the weights are drawn: a tree walk meets
        the weights in the order of the calls that built it."""
        cfg = self.cfg

        def w(*shape, scale=0.02):
            return _Leaf(shape, scale=scale)

        def vec(n, fill, dtype=None):
            return _Leaf((n,), fill=fill, dtype=dtype)

        def norm_p():
            p = {"w": vec(cfg.d_model, 1.0)}
            if cfg.norm == "layernorm":
                p["b"] = vec(cfg.d_model, 0.0)
            return p

        def ffn_dense():
            if cfg.act == "gelu":
                return {"up": w(cfg.d_model, cfg.d_ff),
                        "down": w(cfg.d_ff, cfg.d_model),
                        "up_b": vec(cfg.d_ff, 0.0),
                        "down_b": vec(cfg.d_model, 0.0)}
            return {"up": w(cfg.d_model, cfg.d_ff),
                    "gate": w(cfg.d_model, cfg.d_ff),
                    "down": w(cfg.d_ff, cfg.d_model)}

        def layer(tag):
            mixer, ffn, cross = tag.split(":")
            init = {"mla": attn.init_mla, "mamba": mb.init_mamba}.get(
                mixer, attn.init_gqa)
            lp = {"mixer_norm": norm_p(), "mixer": init(cfg, w, vec)}
            if cross == "1":
                lp["cross"] = attn.init_cross(cfg, w)
                lp["cross_norm"] = norm_p()
                lp["cross_gate"] = _Leaf((), fill=0.0, dtype=F32)
            if ffn != "none":
                lp["ffn_norm"] = norm_p()
                lp["ffn"] = (moe_mod.init_moe(cfg, w) if ffn == "moe"
                             else ffn_dense())
            return lp

        tags = layer_tags(cfg)
        params = {"embed": w(cfg.vocab_size, cfg.d_model),
                  "final_norm": norm_p(),
                  "layers": [layer(tag) for tag in tags]}
        if not cfg.tie_embeddings:
            params["lm_head"] = w(cfg.d_model, cfg.vocab_size)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "layers": [layer("attn:dense:0")
                           for _ in range(cfg.n_enc_layers)],
                "final_norm": {"w": vec(cfg.d_model, 1.0),
                               "b": vec(cfg.d_model, 0.0)}}
            if cfg.n_mels:
                params["conv_stem"] = {
                    "w1": w(3, cfg.n_mels, cfg.d_model),
                    "b1": vec(cfg.d_model, 0.0),
                    "w2": w(3, cfg.d_model, cfg.d_model),
                    "b2": vec(cfg.d_model, 0.0)}
        if cfg.vision_dim:
            params["vision_proj"] = w(cfg.vision_dim, cfg.d_model)
        if cfg.mtp_depth:
            params["mtp"] = {"proj": w(2 * cfg.d_model, cfg.d_model),
                             "layer": layer(tags[-1]),
                             "norm": {"w": vec(cfg.d_model, 1.0)}}
        return params

    # -------------------------------------------------- cache
    def _with_cross(self, layers: list, slots, dtype, device,
                    mem_len) -> list:
        """A cross layer's dict gains ``cross``: its K/V (slots, mem_len,
        KV, hd) (``attention.init_cross_cache``); ``mem_len`` defaults to
        ``enc_seq_len`` (whisper) or ``n_image_tokens`` (vision)."""
        cfg = self.cfg
        mem_len = mem_len or (cfg.enc_seq_len if cfg.is_encoder_decoder
                              else cfg.n_image_tokens)
        for layer, cross in zip(layers, self.cross_layers):
            if cross:
                layer["cross"] = attn.init_cross_cache(cfg, slots, mem_len,
                                                       dtype, device)
        return layers

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cpu", mem_len: int | None = None) -> list:
        """One dict a layer: GQA's ``k`` and ``v`` (B, S, KV, D), MLA's
        ``latent`` (B, S, kv_lora + rope), or a Mamba2 layer's per-slot
        state (``mamba.init_mamba_cache``); a cross layer's also holds
        ``cross`` (``_with_cross``)."""
        make = (attn.init_mla_cache if self.cfg.attention == "mla"
                else attn.init_gqa_cache)
        return self._with_cross(
            [mb.init_mamba_cache(self.cfg, batch, dtype, device)
             if st else make(self.cfg, batch, max_len, dtype, device)
             for st in self.state_layers], batch, dtype, device, mem_len)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device="cpu",
                         slots: int | None = None,
                         mem_len: int | None = None) -> list:
        """Attention layers get (num_blocks, block_size, ...) pools; a
        Mamba2 layer keeps its constant-size state a slot
        (``paged_cache.init_paged_mamba_cache``) and a cross layer its
        cross K/V, so a stack with either needs ``slots``."""
        from repro_torch.serve import paged_cache

        cfg = self.cfg
        if slots is None and any(self.state_layers + self.cross_layers):
            raise ValueError(f"{cfg.name}: a paged cache with Mamba2 or "
                             f"cross layers needs the slot count")
        make = (paged_cache.init_paged_mla_cache if cfg.attention == "mla"
                else paged_cache.init_paged_gqa_cache)
        return self._with_cross(
            [paged_cache.init_paged_mamba_cache(cfg, slots, dtype, device)
             if st else make(cfg, num_blocks, block_size, dtype, device)
             for st in self.state_layers], slots, dtype, device, mem_len)

    def kv_leaf(self, cache):
        """The first attention layer's first cache leaf, None in a stack
        without attention.  Every attention leaf of every layer (GQA's
        ``k`` and ``v``, MLA's ``latent``) leads with the same two dims,
        (slots, depth) or (blocks, block size), which is what the cell
        indices and the verify window are built from; a Mamba2 layer's
        leaves lead with the slot alone, and so does a cross K/V, which
        this never returns."""
        for layer, st in zip(cache, self.state_layers):
            if not st:
                return cell_leaves(layer)[0]
        return None

    # -------------------------------------------------- layers
    def apply_layer(self, x, lp, ctx: LayerCtx, positions, mode: str, cache,
                    pos=None, slots=None, lengths=None, tables=None,
                    prefix_lens=None, spans=None, window=None, mem=None,
                    causal: bool = True, defer: bool = False):
        """One decoder layer (mode: full | prefill | decode | verify), its
        mixer GQA, MLA or Mamba2 as its params say (``_mamba``).
        ``full`` is causal attention over the whole sequence with no cache
        (the training/scoring forward).  ``prefix_lens`` (prefill): the
        logical start of each row's tokens (a suffix or a chunk);
        ``spans``: each row's (start, end) on the host for row-wise
        attention.  ``verify``: T tokens a row from cursor ``pos``, written
        to the cache through ``window`` (the call's write index); its
        d_model norms run one step at a time at decode's shapes
        (``per_step``).  An MoE FFN (its params hold a ``router``) routes
        all the call's tokens, padding rows and a verify window's rows
        included, as the reference's; a layer without ``ffn`` has none.
        ``causal=False`` (whisper's encoder, mode ``full``) lets every
        position attend every other.  A cross layer (its params hold
        ``cross``) then attends the memory ``mem`` (``_cross``).
        Returns (x, flag, aux, cache): aux the MoE FFN's load-balance
        loss, None otherwise (only ``forward`` reads it); cache the
        layer's cache after the call: the same dict, written in place,
        except after a Mamba2 decode step, whose next state comes back in
        a new dict (None in mode ``full``).  ``defer`` (mode ``full``):
        (x, flag, aux, cache, tail), the layer's last projection left out
        where it is a dense FFN's ``down`` or, in a Mamba2 layer with
        neither FFN nor cross layer, the SSD ``out_proj``: ``tail`` its
        ``Tail`` (None elsewhere), the layer's output ``x + tail.run(
        tail.inp)[0]`` (``run_stack``'s remat)."""
        cfg = self.cfg
        lp = fsdp_view(lp, ctx)
        nrm = functools.partial(per_step, norm) if mode == "verify" else norm
        h = nrm(x, lp["mixer_norm"], cfg.norm, cfg.norm_eps)
        tail = None
        if "A_log" in lp["mixer"]:
            if defer and mode == "full" and "ffn" not in lp \
                    and "cross" not in lp:
                tail, f = mb.mamba_forward(h, lp["mixer"], cfg, ctx,
                                           defer=True)
                return x, f, None, cache, tail
            a, f, cache = self._mamba(h, lp["mixer"], ctx, mode, cache,
                                      slots, lengths, prefix_lens)
        else:
            mix = attn.MLA if cfg.attention == "mla" else attn.GQA
            if mode == "full":
                # only whisper's encoder (GQA) lifts the causal mask
                extra = {} if causal else {"causal": False}
                a, f = mix["forward"](h, lp["mixer"], cfg, ctx, positions,
                                      **extra)
            elif mode == "prefill":
                if tables is not None:
                    a, f = mix["paged_prefill"](h, lp["mixer"], cfg, ctx,
                                                positions, cache, tables,
                                                lengths, starts=prefix_lens,
                                                spans=spans)
                else:
                    a, f = mix["prefill"](h, lp["mixer"], cfg, ctx,
                                          positions, cache, slots=slots,
                                          lengths=lengths,
                                          starts=prefix_lens, spans=spans)
            elif mode == "verify":
                if tables is not None:
                    a, f = mix["paged_verify"](h, lp["mixer"], cfg, ctx, pos,
                                               cache, window, tables)
                else:
                    a, f = mix["verify"](h, lp["mixer"], cfg, ctx, pos,
                                         cache, window)
            elif tables is not None:
                a, f = mix["paged_decode"](h, lp["mixer"], cfg, ctx, pos,
                                           cache, tables)
            else:
                a, f = mix["decode"](h, lp["mixer"], cfg, ctx, pos, cache)
        x = x + a
        if "cross" in lp:
            x, f3 = self._cross(x, lp, ctx, mode, cache, mem, slots)
            f = or_flags(f, f3)
        aux = None
        if "ffn" in lp:
            h = nrm(x, lp["ffn_norm"], cfg.norm, cfg.norm_eps)
            if "router" in lp["ffn"]:
                o, f2, aux = moe_mod.moe_forward(h, lp["ffn"], cfg, ctx)
            elif defer:
                tail, f2 = mlp(h, lp["ffn"], ctx, act=cfg.act, defer=True)
            else:
                o, f2 = mlp(h, lp["ffn"], ctx, act=cfg.act)
            if tail is None:
                x = x + o
            f = or_flags(f, f2)
        if defer:
            return x, f, aux, cache, tail
        return x, f, aux, cache

    def _cross(self, x, lp, ctx: LayerCtx, mode: str, cache, mem, slots):
        """A cross layer's sublayer: ``x + tanh(cross_gate) * attention``
        of the normed x over the memory's K/V.  Modes ``full`` and
        ``prefill`` project ``mem`` (``attention.cross_kv``); ``prefill``
        also writes the K/V, cast to the cache's dtype, into the layer's
        ``cross`` rows ``slots`` (every row without), in place; ``decode``
        reads them and raises no K/V flag (``verify`` refuses cross
        stacks).  Returns (x, flag)."""
        cfg = self.cfg
        h = norm(x, lp["cross_norm"], cfg.norm, cfg.norm_eps)
        if mode == "decode":
            ck, cv = cache["cross"]["k"], cache["cross"]["v"]
            fkv = torch.zeros((), dtype=torch.bool, device=x.device)
        else:
            ck, cv, fkv = attn.cross_kv(mem, lp["cross"], cfg, ctx)
            if mode == "prefill":
                cc = cache["cross"]
                rows = (slice(None) if slots is None
                        else slots.to(cc["k"].device).long())
                cc["k"][rows] = ck.to(cc["k"].dtype)
                cc["v"][rows] = cv.to(cc["v"].dtype)
        a, f = attn.cross_forward(h, ck, cv, lp["cross"], cfg, ctx)
        x = x + torch.tanh(lp["cross_gate"]).to(x.dtype) * a
        return x, or_flags(fkv, f)

    def _mamba(self, h, p, ctx: LayerCtx, mode: str, cache, slots, lengths,
               prefix_lens):
        """A Mamba2 mixer in ``mode``: (out, flag, cache after the call).
        Its state lives a slot, so the paged engine's block tables do not
        reach it.  Speculative verify and a mid-prompt resume (prefix
        sharing, chunked prefill) raise the reference's refusals: the
        recurrence cannot roll back to the last accepted token, nor resume
        from cached KV."""
        cfg = self.cfg
        if mode == "verify":
            raise ValueError("speculative verify cannot roll the SSM "
                             "recurrence state back to the last accepted "
                             "position")
        if prefix_lens is not None:
            raise ValueError("prefix sharing / chunked prefill cannot resume "
                             "the SSM recurrence state mid-prompt")
        if mode == "full":
            a, f = mb.mamba_forward(h, p, cfg, ctx)
            return a, f, None
        if mode == "prefill":
            a, f = mb.mamba_prefill(h, p, cfg, ctx, cache, slots=slots,
                                    lengths=lengths)
            return a, f, cache
        return mb.mamba_decode(h, p, cfg, ctx, cache)

    def run_stack(self, x, params, ctx: LayerCtx, positions, mode: str,
                  caches, pos=None, slots=None, lengths=None, tables=None,
                  remat: bool = False, prefix_lens=None, spans=None,
                  window=None, mem=None, causal: bool = True):
        """The layer loop over ``params["layers"]`` (the decoder's, or the
        encoder's: ``params["encoder"]``), numbered from 0 either way, as
        the reference numbers them.  ``mem``: the cross layers' memory;
        ``causal``: ``apply_layer``'s.  ``caches`` is None in mode
        ``full``.  ``remat``
        recomputes each layer in the backward pass instead of keeping its
        activations (the reference's ``jax.checkpoint`` per layer); it
        changes no number and applies only while autograd records.  The
        recomputed region ends at the input of the layer's last projection
        (``apply_layer``'s ``defer``), which runs outside it: the backward
        reads that GEMM's input, never its output, so XLA's dead-code
        elimination drops its recompute in the reference, and here it is
        never recomputed.  On a sharded rank (``ctx.tp``, ``ctx.dp`` or
        ``ctx.bp``) the recompute runs the whole region (no early stop),
        so every rank re-issues the layer's collectives in the same
        order, whatever a fault added to one rank's graph.
        Returns (x, flag, aux, caches): aux the MoE layers' load-balance
        losses summed (0 without any); caches a new list of each layer's
        cache after the call (``apply_layer``), None in mode ``full``."""
        layers = params["layers"]
        full = caches is None
        caches = [None] * len(layers) if full else caches
        remat = remat and torch.is_grad_enabled()
        sharded = any(g is not None and g.size > 1
                      for g in (ctx.tp, ctx.dp, ctx.bp))
        flags, auxes, out = [], [], []
        for i, (lp, cache) in enumerate(zip(layers, caches)):
            kw = dict(pos=pos, slots=slots, lengths=lengths, tables=tables,
                      prefix_lens=prefix_lens, spans=spans, window=window,
                      mem=mem, causal=causal)
            args = (x, lp, ctx.with_layer(i), positions, mode, cache)
            with layer_scope(ctx.site_prefix, i):
                if remat:
                    with set_checkpoint_early_stop(not sharded):
                        x, f, a, c, tail = checkpoint(
                            self.apply_layer, *args, use_reentrant=False,
                            defer=True, **kw)
                    if tail is not None:
                        o, f2 = tail.run(tail.inp)
                        x = x + o
                        f = or_flags(f, f2)
                else:
                    x, f, a, c = self.apply_layer(*args, **kw)
            flags.append(f)
            out.append(c)
            if a is not None:
                auxes.append(a)
        aux = (torch.stack(auxes).sum() if auxes
               else torch.zeros((), dtype=F32, device=x.device))
        return x, torch.stack(flags).any(), aux, None if full else out

    def vocab_sharded(self, ctx) -> bool:
        """Whether the head's logits under ``ctx`` are this rank's vocab
        slice (rank r's the r-th of ``tp.size`` equal slices): a context
        that asks for them (``LayerCtx.vocab_parallel``) on a rank whose
        head the rules split over ``model``."""
        name = "embed" if self.cfg.tie_embeddings else "lm_head"
        return ctx.vocab_parallel and tp_par(ctx, name, "col") is not None

    def _head(self, params, x, ctx):
        """f32 logits (..., V) and the head's flag; column-parallel over
        the vocab under tensor parallelism, the logits gathered whole
        (this rank's slice where ``vocab_sharded``); an FSDP head gathered
        over the data axis before its GEMM."""
        tied = self.cfg.tie_embeddings
        name = "embed" if tied else "lm_head"
        w = fsdp_leaf(params[name], ctx, name)
        w = w.t().to(x.dtype) if tied else w
        par = tp_par(ctx, name, "col")
        logits, flag = dense(x, w, ctx, "lm_head", out_dtype=F32, par=par)
        if par is not None and not ctx.vocab_parallel:
            logits = gather_last(logits, ctx.tp)
        return logits, flag

    def embed_tokens(self, params, tokens, ctx: LayerCtx):
        """The embedding rows of ``tokens``.  On a vocab-sharded rank a
        token another rank owns reads zeros, and the rows are summed over
        the model axis in f32, exact, then cast back.  An FSDP embedding is
        gathered over the data axis first (a split call's data ranks look
        up different tokens)."""
        emb = fsdp_leaf(params["embed"], ctx, "embed")
        if ctx.tp is None or not ctx.tp.splits("embed"):
            return emb[tokens]
        n = emb.shape[0]
        local = tokens - ctx.tp.rank * n
        own = (local >= 0) & (local < n)
        x = emb[local.clamp(0, n - 1)].to(F32)
        x = torch.where(own[..., None], x, torch.zeros_like(x))
        return all_reduce_sum(x, ctx.tp).to(emb.dtype)

    def shard_params(self, params, mesh) -> dict:
        """One rank's shard of a params tree: every leaf sliced by
        ``param_specs`` (of ``init_params``' full shapes) at this process's
        mesh position, in storage of its own (``_cut``).  A leaf already
        at its shard's shape (a tree from ``init_params(mesh=)``) is kept
        as it is; under head padding a leaf at the logical model's shape
        is zero-padded first (``attention.pad_logical``); any other shape
        raises ``ValueError``."""
        from repro_torch.distributed.sharding import (
            map_with_path,
            param_specs,
            shard_shape,
            shard_slices,
        )

        tree = self._param_tree()
        coords = mesh.coords()
        flat, full = {}, {}
        map_with_path(lambda ps, s: flat.__setitem__(ps, s),
                      param_specs(self.cfg, tree, mesh))
        map_with_path(lambda ps, leaf: full.__setitem__(ps, leaf.shape),
                      tree)
        padded = self.cfg.eff_heads != self.cfg.n_heads \
            or self.cfg.eff_kv_heads != self.cfg.n_kv_heads

        def one(ps, t):
            if padded:
                t = attn.pad_logical(ps, t, self.cfg)
            shape = tuple(t.shape)
            if shape == full[ps]:
                return _cut(t, shard_slices(flat[ps], shape, mesh, coords))
            if shape == shard_shape(flat[ps], full[ps], mesh):
                return t
            raise ValueError(f"param {ps}: shape {shape} is neither the "
                             f"full {full[ps]} nor this rank's shard")

        return map_with_path(one, params)

    # -------------------------------------------------- memory
    def _conv_stem(self, params, audio):
        """Whisper's audio frontend (the reference's): log-mel frames
        (B, T, n_mels) through two width-3 convs, stride 1 then 2, each
        followed by its bias and the tanh GELU, in the weights' dtype ->
        (B, ceil(T / 2), d_model).  Outside ABFT, as in the reference (a
        library convolution; its TF32 must be off on the card:
        ``executor.strict_f32``): a ``flops[conv_stem]`` region, a known
        gap of the coverage audit."""
        with coverage_scope("conv_stem"):
            cs = params["conv_stem"]
            h = audio.to(cs["w1"].dtype).transpose(1, 2)
            h = gelu(_conv_same(h, cs["w1"], 1) + cs["b1"][:, None])
            h = gelu(_conv_same(h, cs["w2"], 2) + cs["b2"][:, None])
            return h.transpose(1, 2)

    def _memory(self, params, inputs, ctx: LayerCtx, dev):
        """The per-request memory and its flag (the reference's).  whisper:
        ``audio`` through the conv stem (``enc_input`` frames without one,
        or without audio), plus sinusoid positions, through the encoder's
        layers with no causal mask under ``site_prefix="enc."``, then its
        LayerNorm.  Vision: ``images`` through ``vision_proj`` (fault site
        ``cross_qkv``, tag ``vision.proj``, no layer index: a fault aimed
        at any layer's ``cross_qkv`` fires there too).  (None, False)
        elsewhere.  Inputs are cast to the weights' dtype; a missing one
        raises ``KeyError``, as the reference's does."""
        cfg = self.cfg
        dtype = params["embed"].dtype

        def get(name):
            if name not in inputs:
                raise KeyError(f"{cfg.name} reads its memory from "
                               f"{' or '.join(map(repr, self.memory_inputs))}"
                               f" beside the tokens; {name!r} is missing")
            return torch.as_tensor(inputs[name]).to(device=dev, dtype=dtype)

        if cfg.is_encoder_decoder:
            frames = (self._conv_stem(params, get("audio"))
                      if "audio" in inputs and "conv_stem" in params
                      else get("enc_input"))
            B, S, _ = frames.shape
            pos = torch.arange(S, device=dev).expand(B, S)
            h = frames + sinusoid_pos(pos, cfg.d_model).to(frames.dtype)
            enc = params["encoder"]
            h, flag, _, _ = self.run_stack(
                h, enc, dataclasses.replace(ctx, site_prefix="enc."), pos,
                "full", None, causal=False)
            return norm(h, enc["final_norm"], "layernorm", cfg.norm_eps), flag
        if cfg.vision_dim:
            return dense(get("images"), params["vision_proj"], ctx,
                         "cross_qkv", tag="vision.proj")
        return None, torch.zeros((), dtype=torch.bool, device=dev)

    # -------------------------------------------------- forward (train)
    def forward(self, params, batch, ctx: LayerCtx,
                device=None) -> ForwardOut:
        """Full-sequence causal forward (training and scoring).  batch:
        {"tokens": (B, L)} (``labels`` may ride along, unread) and the
        model's ``memory_inputs`` (``_memory``); returns ForwardOut with
        f32 logits (B, L, V), the OR of every GEMM's and attention's flag
        (the memory's included), the MoE layers' aux loss and, with an MTP
        head in the params, its f32 ``mtp_logits`` (B, L, V) (``_mtp``).
        whisper's decoder adds sinusoid positions to its embeddings.  Runs
        on ``device`` (CUDA unless the caller passes ``"cpu"``), where the
        params must already live.  An input the model does not read raises
        ``ValueError``."""
        from repro_torch.serve.executor import resolve_device

        dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"forward runs on {dev}")
        extra = set(batch) - {"tokens", "labels", *self.memory_inputs}
        if extra:
            raise ValueError(f"batch inputs {sorted(extra)} are not inputs "
                             f"of {self.cfg.name}")
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(dev).long()
        B, L = tokens.shape
        mem, mem_flag = self._memory(params, batch, ctx, dev)
        x = self.embed_tokens(params, tokens, ctx)
        positions = torch.arange(L, device=dev).expand(B, L)
        if cfg.is_encoder_decoder:
            x = x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)
        x, flag, aux, _ = self.run_stack(x, params, ctx, positions, "full",
                                         None, remat=True, mem=mem)
        x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits, f_head = self._head(params, x, ctx)
        flag = or_flags(flag, f_head, mem_flag)
        mtp_logits = None
        if cfg.mtp_depth and "mtp" in params:
            mtp_logits, f_mtp = self._mtp(params, x, tokens, ctx, positions)
            flag = or_flags(flag, f_mtp)
        return ForwardOut(logits=logits, flag=flag, aux_loss=aux,
                          mtp_logits=mtp_logits)

    def _mtp(self, params, h, tokens, ctx, positions):
        """The multi-token prediction head (depth 1), as the reference's:
        the final hidden state, RMS-normed, beside the embedding of the
        next token (``roll`` wraps: the last position sees token 0), through
        ``proj`` (fault site ``mlp_up``), one layer of the last layer's
        kind and the head.  The layer runs with the top-level ctx (no layer
        index), so a fault at a site fires there whatever its layer, and
        its MoE aux loss is discarded."""
        mp = params["mtp"]
        emb_next = self.embed_tokens(params, torch.roll(tokens, -1, 1), ctx)
        comb = torch.cat([norm(h, mp["norm"], "rmsnorm", self.cfg.norm_eps),
                          emb_next], dim=-1)
        hm, f1 = dense(comb, mp["proj"], ctx, "mlp_up", tag="mtp.proj")
        hm, f2, _, _ = self.apply_layer(hm, mp["layer"], ctx, positions,
                                        "full", None)
        logits, f3 = self._head(params, hm, ctx)
        return logits, or_flags(f1, f2, f3)

    # -------------------------------------------------- sharing / chunking
    @property
    def supports_prefix_sharing(self) -> bool:
        """A token's cached KV is a pure function of the token prefix in
        an attention-only decoder without per-request memory, with one
        caveat the reference shares: an MoE layer's capacity, and so which
        tokens its experts drop, depends on every token in the call, so a
        shared or chunked MoE stream follows the reference's, not the
        plain run's.  A Mamba2 layer carries recurrent state outside the
        block pool, so a stack with one shares nothing."""
        cfg = self.cfg
        return not (cfg.is_encoder_decoder or cfg.vision_dim
                    or cfg.cross_attn_every or any(self.state_layers))

    @property
    def supports_chunked_prefill(self) -> bool:
        """A prompt resumes mid-sequence from resident KV: the same
        condition as prefix sharing."""
        return self.supports_prefix_sharing

    def copy_paged_blocks(self, cache, src, dst) -> list:
        """``pool[dst[i]] <- pool[src[i]]`` on every attention layer's
        pools (k and v, or the latent), in place — the COW payload move.
        Per-slot state and cross K/V are never touched."""
        dev = self.kv_leaf(cache).device
        src = torch.as_tensor(src, dtype=torch.long, device=dev)
        dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
        for layer, st in zip(cache, self.state_layers):
            for leaf in ([] if st else cell_leaves(layer)):
                leaf[dst] = leaf[src]
        return cache

    # -------------------------------------------------- prefill / decode
    def prefill(self, params, tokens, cache, ctx: LayerCtx, slots=None,
                lengths=None, block_tables=None, prefix_lens=None,
                inputs=None):
        """Prefill ``cache`` from tokens (B, L).  With ``slots``/``lengths``
        the cache is engine-deep and rows are ragged prompts padded to L;
        logits come from each row's last valid token.  ``block_tables``
        (B, W) selects the paged pools.  ``prefix_lens`` (B,): tokens hold
        only each row's tail (the suffix of a shared prefix, or one
        chunk), whose first token sits at logical position
        ``prefix_lens[b]``; rotary, causal masks and cache targets follow
        the logical positions.  With ``lengths``, attention runs row by row
        (``chunked_attention(spans=...)``) on each row's span, read to the
        host once here.  ``inputs``: the rows' memory inputs, a dict of the
        reference's batch keys (``memory_inputs``; the memory of row b is
        written to slot ``slots[b]`` of each cross layer, and whisper's
        positions get their sinusoids).  Returns (logits (B, 1, V) f32,
        cache, flag, the memory's included); the cache is updated in
        place."""
        cfg = self.cfg
        B, L = tokens.shape
        mem, mem_flag = self._memory(params, inputs or {}, ctx,
                                     tokens.device)
        x = self.embed_tokens(params, tokens, ctx)
        positions = torch.arange(L, device=tokens.device).expand(B, L)
        if prefix_lens is not None:
            positions = prefix_lens.to(tokens.device).long()[:, None] \
                + positions
        if cfg.is_encoder_decoder:
            x = x + sinusoid_pos(positions, cfg.d_model).to(x.dtype)
        spans = None
        if lengths is not None:
            lens = lengths.tolist()
            offs = prefix_lens.tolist() if prefix_lens is not None \
                else [0] * B
            spans = [(o, o + n) for o, n in zip(offs, lens)]
        x, flag, _, _ = self.run_stack(x, params, ctx, positions, "prefill",
                                       cache, slots=slots, lengths=lengths,
                                       tables=block_tables,
                                       prefix_lens=prefix_lens, spans=spans,
                                       mem=mem)
        x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        if lengths is not None:
            idx = (lengths.to(x.device).long() - 1).clamp_min(0)
            last = x[torch.arange(B, device=x.device), idx][:, None]
        else:
            last = x[:, -1:, :]
        logits, f_head = self._head(params, last, ctx)
        return logits, cache, or_flags(flag, f_head, mem_flag)

    def decode(self, params, token, cache, pos, ctx: LayerCtx,
               block_tables=None):
        """token: (B, 1); pos: (B,) per-slot cursor.  Each row writes its
        KV at its own cursor and attends its own prefix.  Returns
        (logits (B, 1, V) f32, cache, flag): the attention layers' dicts
        of ``cache`` written in place, a Mamba2 layer's next state in a new
        dict, ``cache`` itself left as it was (``mamba.mamba_decode``);
        the returned list is what the step commits.  A cross layer reads
        the K/V its slot's prefill wrote; whisper adds the sinusoid of
        ``pos``."""
        cfg = self.cfg
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=token.device).expand(B).contiguous()
        x = self.embed_tokens(params, token, ctx)
        if cfg.is_encoder_decoder:
            x = x + sinusoid_pos(pos.long()[:, None], cfg.d_model).to(
                x.dtype)
        x, flag, _, cache = self.run_stack(x, params, ctx, None, "decode",
                                           cache, pos=pos,
                                           tables=block_tables)
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
        and attention one step at a time, and MLA's latent norms and
        absorbed products; K1 pinned to the B-row GEMM and the plain
        product run step by step through ``ABFTConfig.decode_rows``, which
        the runner sets), so row t's logits are bit for bit decode's at
        that position.  An MoE layer routes the call's B x T rows at once,
        as the reference's: its capacity is the window's, so a row equals
        decode's only where no expert overflowed in either call.  A stack
        with a Mamba2 layer raises ``ValueError``, one with cross layers
        ``NotImplementedError`` (the reference's verify calls ``cross_kv``
        without a memory).  whisper verifies as the reference does:
        without the sinusoid positions its prefill and decode add.
        Returns (logits (B, T, V) f32, cache, flag)."""
        from repro_torch.serve.paged_cache import prefill_write_index

        cfg = self.cfg
        B, T = tokens.shape
        pos = torch.as_tensor(pos, dtype=torch.int32,
                              device=tokens.device).expand(B).contiguous()
        if any(self.cross_layers):
            raise NotImplementedError(
                f"speculative verify on {cfg.name}'s cross-attention "
                f"layers: the reference's verify projects no memory")
        if any(self.state_layers):
            raise ValueError("speculative verify cannot roll the SSM "
                             "recurrence state back to the last accepted "
                             "position")
        pool = self.kv_leaf(cache)
        # every layer writes the same cells: one index a call
        window = (attn.verify_write_index(pos, valid, T, pool.shape[1])
                  if block_tables is None else
                  prefill_write_index(pool, block_tables, valid, T, pos))
        x = self.embed_tokens(params, tokens, ctx)
        x, flag, _, _ = self.run_stack(x, params, ctx, None, "verify",
                                       cache, pos=pos, tables=block_tables,
                                       window=window)
        x = per_step(norm, x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits, f_head = self._head(params, x, ctx)
        return logits, cache, or_flags(flag, f_head)

    def audit_coverage(self, phase: str = "mixed", **kw):
        """Protection-coverage audit (``repro_torch.analysis``): run this
        model's prefill and decode (and the engine's chunk and verify
        steps) under the op walker and classify every FLOP-carrying op as
        protected / allowlisted / known-unprotected / UNPROTECTED, with
        the plan crosscheck.  Returns an ``AuditReport``."""
        from repro_torch.analysis.audit import audit_model

        return audit_model(self, phase=phase, **kw)

    def protection_plan(self, hw, policy=None, *, phase: str = "serve",
                        n_tokens: int = 1, dtype_bytes: int = 2,
                        model_parallel: int = 1):
        """The ProtectionPlan of this model; ``model_parallel=k`` compiles
        one shard's post-sharding GEMM shapes."""
        from repro_torch.core.policy import ProtectionPlan

        return ProtectionPlan.for_model(self.cfg, hw=hw, policy=policy,
                                        phase=phase, n_tokens=n_tokens,
                                        dtype_bytes=dtype_bytes,
                                        model_parallel=model_parallel)
