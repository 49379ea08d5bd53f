"""Analytic accounting: parameter counts, per-layer GEMM dims, model FLOPs
(copy of ``repro.models.counting``; host logic for every config, whether
or not the port serves it).

Used by (i) the roofline's MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE),
(ii) the paper-figure benchmarks (aggregate/per-layer arithmetic intensity),
and (iii) the intensity-guided selection report.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.intensity import GemmDims
from repro_torch.models.model import layer_tags

# Which GEMM dim tensor parallelism shards at each plan site, mirroring
# the parameter PartitionSpecs of the reference's
# ``repro.distributed.sharding._param_rule`` (not ported yet):
# "n" = column-parallel (output dim over 'model': wq/wk/wv, up/gate,
# lm_head, ...), "k" = row-parallel (contraction dim over 'model': wo,
# down, ssm out_proj, ...).  Sites absent here are replicated (mla.q_a /
# kv_a low-rank projections, ssm.in_bc, moe.router, vision.proj) and
# keep their full dims on every shard.
_TP_SHARD_DIM = {
    "attn.q": "n", "attn.k": "n", "attn.v": "n", "attn.o": "k",
    "mla.q_b": "n", "mla.out": "k",
    "ssm.in_z": "n", "ssm.in_x": "n", "ssm.in_dt": "n", "ssm.out": "k",
    "mlp.up": "n", "mlp.down": "k",
    "moe.shared_up": "n", "moe.shared_down": "k",
    "cross.q": "n", "cross.k": "n", "cross.v": "n", "cross.o": "k",
    "enc.attn.q": "n", "enc.attn.k": "n", "enc.attn.v": "n",
    "enc.attn.o": "k",
    "enc.mlp.up": "n", "enc.mlp.down": "k",
    "lm_head": "n",
}


def shard_gemms(sites: dict, cfg: ModelConfig, model_parallel: int) -> dict:
    """Per-DEVICE GEMM dims under ``model_parallel``-way tensor/expert
    parallelism — the post-sharding shapes a ProtectionPlan must be
    compiled from, because TP shrinks each device's (m,k,n) and with it
    the arithmetic intensity the scheme selection keys on (the paper's
    selection boundary moves with mesh width).

    Mirrors ``repro.distributed.sharding`` exactly: a dim is divided only
    when the axis divides it (``sanitize_spec`` drops the sharding
    otherwise, so the per-device GEMM stays full); experts shard over
    the model axis when the expert count divides it (EP — per-device
    *count* shrinks, per-expert dims do not), falling back to TP on the
    expert FFN dim when it does not (qwen2-moe's 60 experts)."""
    tp = int(model_parallel)
    if tp <= 1:
        return sites
    ep_fits = cfg.n_experts % tp == 0 if cfg.n_experts else True
    out = {}
    for name, (d, count) in sites.items():
        dim = _TP_SHARD_DIM.get(name)
        if name in ("moe.expert_up", "moe.expert_down"):
            if ep_fits:
                count = max(1, count // tp)
            else:
                dim = "n" if name.endswith("up") else "k"
        if dim == "n" and d.n % tp == 0 and d.n >= tp:
            d = dataclasses.replace(d, n=d.n // tp)
        elif dim == "k" and d.k % tp == 0 and d.k >= tp:
            d = dataclasses.replace(d, k=d.k // tp)
        out[name] = (d, count)
    return out


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla":
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return (
            cfg.d_model * cfg.q_lora_rank
            + cfg.q_lora_rank * cfg.n_heads * (dn + dr)
            + cfg.d_model * (cfg.kv_lora_rank + dr)
            + cfg.n_heads * dn * cfg.kv_lora_rank
            + cfg.n_heads * cfg.kv_lora_rank * dv
            + cfg.n_heads * dv * cfg.d_model
        )
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _mamba_params(cfg: ModelConfig) -> int:
    d_in, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * d_in + 2 * n + h
    return (
        cfg.d_model * proj_out
        + cfg.ssm_conv_width * (d_in + 2 * n)
        + 3 * h            # A_log, D, dt_bias
        + d_in             # out_norm
        + d_in * cfg.d_model
    )


def _dense_ffn_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.act == "silu" else 2
    return mult * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig) -> tuple:
    """(total, active) params of one MoE FFN."""
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    router = cfg.d_model * cfg.n_experts
    shared = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_shared_experts
    total = cfg.n_experts * per_expert + router + shared
    active = cfg.experts_per_token * per_expert + router + shared
    return total, active


def _cross_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    return (
        cfg.d_model * cfg.n_heads * hd
        + 2 * cfg.d_model * cfg.n_kv_heads * hd
        + cfg.n_heads * hd * cfg.d_model
    )


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab_size * cfg.d_model            # embedding
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size       # head
    for tag in layer_tags(cfg):
        mixer, ffn, cross = tag.split(":")
        if mixer in ("attn", "mla"):
            total += _attn_params(cfg)
        else:
            total += _mamba_params(cfg)
        if cross == "1":
            total += _cross_params(cfg)
        if ffn == "dense":
            total += _dense_ffn_params(cfg)
        elif ffn == "moe":
            t, a = _moe_params(cfg)
            total += a if active_only else t
    if cfg.is_encoder_decoder:
        total += cfg.n_enc_layers * (
            _attn_params(cfg) + _dense_ffn_params(cfg))
        if cfg.n_mels:
            # conv stem: two width-3 1-D convs + biases
            total += (3 * cfg.n_mels * cfg.d_model + cfg.d_model
                      + 3 * cfg.d_model * cfg.d_model + cfg.d_model)
    if cfg.vision_dim:
        total += cfg.vision_dim * cfg.d_model
    return total


def model_flops(cfg: ModelConfig, n_tokens: int, training: bool) -> float:
    """MODEL_FLOPS = 6*N*D (training) or 2*N*D (inference), with N the
    *active* parameter count (MoE counts only routed-in experts)."""
    n_active = count_params(cfg, active_only=True)
    mult = 6.0 if training else 2.0
    return mult * n_active * n_tokens


def layer_gemms(
    cfg: ModelConfig, n_tokens: int, phase: str = "prefill",
    dtype_bytes: int = 2, model_parallel: int = 1,
) -> dict:
    """Per-GEMM-site dims for one representative layer of each kind plus the
    head, scaled by site multiplicity.  ``n_tokens`` is the GEMM M dim
    (batch*seq for full passes; batch for decode).  ``model_parallel > 1``
    returns each DEVICE's post-sharding dims (``shard_gemms``)."""
    hd = cfg.resolved_head_dim
    sites: dict = {}
    m = n_tokens

    def g(k, n):
        return GemmDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes)

    tags = layer_tags(cfg)
    n_attn = sum(1 for t in tags if t.split(":")[0] in ("attn", "mla"))
    n_mamba = sum(1 for t in tags if t.split(":")[0] == "mamba")
    n_dense_ffn = sum(1 for t in tags if t.split(":")[1] == "dense")
    n_moe = sum(1 for t in tags if t.split(":")[1] == "moe")
    n_cross = sum(1 for t in tags if t.split(":")[2] == "1")

    if n_attn:
        if cfg.attention == "mla":
            dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            sites["mla.q_a"] = (g(cfg.d_model, cfg.q_lora_rank), n_attn)
            sites["mla.q_b"] = (
                g(cfg.q_lora_rank, cfg.n_heads * (dn + dr)), n_attn)
            sites["mla.kv_a"] = (
                g(cfg.d_model, cfg.kv_lora_rank + dr), n_attn)
            sites["mla.out"] = (
                g(cfg.n_heads * cfg.v_head_dim, cfg.d_model), n_attn)
        else:
            sites["attn.q"] = (g(cfg.d_model, cfg.n_heads * hd), n_attn)
            sites["attn.k"] = (g(cfg.d_model, cfg.n_kv_heads * hd), n_attn)
            sites["attn.v"] = (g(cfg.d_model, cfg.n_kv_heads * hd), n_attn)
            sites["attn.o"] = (g(cfg.n_heads * hd, cfg.d_model), n_attn)
    if n_mamba:
        d_in = cfg.d_inner
        # the in-projection is stored split (z / x / BC / dt; see
        # models/mamba.py) so each split GEMM is its own plan site with
        # its own arithmetic intensity
        sites["ssm.in_z"] = (g(cfg.d_model, d_in), n_mamba)
        sites["ssm.in_x"] = (g(cfg.d_model, d_in), n_mamba)
        sites["ssm.in_bc"] = (g(cfg.d_model, 2 * cfg.ssm_state), n_mamba)
        sites["ssm.in_dt"] = (g(cfg.d_model, cfg.ssm_heads), n_mamba)
        sites["ssm.out"] = (g(d_in, cfg.d_model), n_mamba)
    if n_dense_ffn:
        mult = 2 if cfg.act == "silu" else 1
        sites["mlp.up"] = (g(cfg.d_model, cfg.d_ff), n_dense_ffn * mult)
        sites["mlp.down"] = (g(cfg.d_ff, cfg.d_model), n_dense_ffn)
    if n_moe:
        sites["moe.router"] = (g(cfg.d_model, cfg.n_experts), n_moe)
        # per-expert GEMM: tokens-per-expert is the M dim
        m_e = max(1, m * cfg.experts_per_token // cfg.n_experts)
        ge = GemmDims(m=m_e, k=cfg.d_model, n=cfg.moe_d_ff,
                      dtype_bytes=dtype_bytes)
        gd = GemmDims(m=m_e, k=cfg.moe_d_ff, n=cfg.d_model,
                      dtype_bytes=dtype_bytes)
        sites["moe.expert_up"] = (ge, n_moe * 2 * cfg.n_experts)
        sites["moe.expert_down"] = (gd, n_moe * cfg.n_experts)
        if cfg.n_shared_experts:
            fs = cfg.moe_d_ff * cfg.n_shared_experts
            sites["moe.shared_up"] = (g(cfg.d_model, fs), n_moe * 2)
            sites["moe.shared_down"] = (
                GemmDims(m=m, k=fs, n=cfg.d_model, dtype_bytes=dtype_bytes),
                n_moe)
    if n_cross:
        sites["cross.q"] = (g(cfg.d_model, cfg.n_heads * hd), n_cross)
        sites["cross.k"] = (g(cfg.d_model, cfg.n_kv_heads * hd), n_cross)
        sites["cross.v"] = (g(cfg.d_model, cfg.n_kv_heads * hd), n_cross)
        sites["cross.o"] = (g(cfg.n_heads * hd, cfg.d_model), n_cross)
    if cfg.is_encoder_decoder and cfg.n_enc_layers:
        ne = cfg.n_enc_layers
        mult = 2 if cfg.act == "silu" else 1
        sites["enc.attn.q"] = (g(cfg.d_model, cfg.n_heads * hd), ne)
        sites["enc.attn.k"] = (g(cfg.d_model, cfg.n_kv_heads * hd), ne)
        sites["enc.attn.v"] = (g(cfg.d_model, cfg.n_kv_heads * hd), ne)
        sites["enc.attn.o"] = (g(cfg.n_heads * hd, cfg.d_model), ne)
        sites["enc.mlp.up"] = (g(cfg.d_model, cfg.d_ff), ne * mult)
        sites["enc.mlp.down"] = (g(cfg.d_ff, cfg.d_model), ne)
    if cfg.vision_dim:
        sites["vision.proj"] = (g(cfg.vision_dim, cfg.d_model), 1)
    sites["lm_head"] = (g(cfg.d_model, cfg.vocab_size), 1)
    return shard_gemms(sites, cfg, model_parallel)


def layer_specs(
    cfg: ModelConfig, n_tokens: int, phase: str = "prefill",
    dtype_bytes: int = 2, model_parallel: int = 1,
) -> list:
    """Plan-ready layer descriptors (``policy.LayerSpec``) for one
    representative layer of each kind plus the head.

    The ``first`` flag — global ABFT's unfused activation-checksum read
    (schemes.cost_global) — is placed EXPLICITLY on the mixer projection
    of the model's actual first layer (``layer_tags(cfg)[0]``), not on
    whichever site happens to enumerate first in the dict.  A jamba-style
    hybrid whose stack opens with a mamba block therefore flags
    ``ssm.in_z``, never ``attn.q``."""
    from repro_torch.core.policy import LayerSpec

    sites = layer_gemms(cfg, n_tokens, phase, dtype_bytes,
                        model_parallel=model_parallel)
    first_mixer = layer_tags(cfg)[0].split(":")[0]
    first_site = {
        "attn": "attn.q", "mla": "mla.q_a", "mamba": "ssm.in_z",
    }.get(first_mixer)
    return [
        LayerSpec(name=name, dims=dims, count=count,
                  first=(name == first_site))
        for name, (dims, count) in sites.items()
    ]


def aggregate_ai(cfg: ModelConfig, n_tokens: int, phase: str = "prefill"):
    """Aggregate arithmetic intensity over all linear layers (paper §3.2)."""
    sites = layer_gemms(cfg, n_tokens, phase)
    flops = sum(d.flops * c for d, c in sites.values())
    bytes_ = sum(d.bytes_total * c for d, c in sites.values())
    return flops / max(bytes_, 1.0)
