"""Shared NN building blocks (port of ``repro.models.layers``).  Every GEMM
routes through ``protected_matmul``.  Norms, rotary embeddings and the
attention used outside the fused kernels are plain PyTorch, as the
reference computes them in XLA outside any kernel.  Params are plain
dicts of tensors; flags are 0-d bool tensors on the compute device, read
on the host once per engine step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import (
    ABFTConfig,
    protected_matmul,
    protected_matmul_batched,
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
class LayerCtx:
    """Per-forward context: the ABFT config, the fault target and the
    current layer index (set by the stack loop)."""

    abft: ABFTConfig = ABFTConfig()
    fault: ModelFault | None = None
    layer_idx: int | None = None

    def with_layer(self, idx: int) -> "LayerCtx":
        return dataclasses.replace(self, layer_idx=idx)


def _site_fault(ctx: LayerCtx, site: str) -> FaultSpec | None:
    """The context's fault if it targets this site of this layer."""
    f = ctx.fault
    if f is not None and f.spec.enabled and f.site == SITES[site] and (
            ctx.layer_idx is None or f.layer == ctx.layer_idx):
        return f.spec
    return None


def dense(x, w, ctx: LayerCtx, site: str, b=None, out_dtype=None,
          tag: str | None = None):
    """ABFT-protected ``x @ w (+ b)``.  Returns (y, flag)."""
    y, chk = protected_matmul(x, w, ctx.abft, out_dtype=out_dtype or x.dtype,
                              fault=_site_fault(ctx, site), site=tag or site)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, chk.flag


def batched_dense(x_e, w_e, ctx: LayerCtx, site: str,
                  tag: str | None = None):
    """Per-expert protected GEMMs x_e (E, C, D) @ w_e (E, D, F) in one
    call (the reference's ``moe._batched_dense``, a ``jax.vmap`` of
    ``dense``): the scheme of one expert's GEMM, the site's fault in
    every expert.  Returns (y (E, C, F), flag: any expert's)."""
    return protected_matmul_batched(x_e, w_e, ctx.abft,
                                    fault=_site_fault(ctx, site),
                                    site=tag or site)


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
    at its offset) is zeros.  Returns (B, Lq, H, Dv)."""
    if spans is not None:
        return _rowwise_attention(q, k, v, spans, causal=causal,
                                  q_chunk=q_chunk, k_chunk=k_chunk,
                                  scale=scale)
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


def decode_attention(q, k_cache, v_cache, length, scale=None):
    """Single-token attention against a (B, S, KV, D) cache.
    q: (B, 1, H, Dk); ``length``: (B,) valid positions.  Returns
    (B, 1, H, Dv)."""
    return _decode_core(q, k_cache.to(F32), v_cache.to(F32), v_cache.dtype,
                        length.to(q.device), scale)


def _decode_core(q, kf, vf, v_dtype, length, scale):
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
    return out.reshape(B, 1, H, Dv).to(q.dtype)


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
    ``decode_attention`` exactly."""
    kf, vf = k_cache.to(F32), v_cache.to(F32)
    length = length.to(q.device)
    return torch.cat([
        _decode_core(q[:, t:t + 1].contiguous(), kf, vf, v_cache.dtype,
                     length + t, scale) for t in range(q.shape[1])], dim=1)


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
        tags: tuple = ("mlp.up", "mlp.down")):
    """SwiGLU MLP; its three GEMMs are ABFT-protected."""
    if act != "silu":
        raise NotImplementedError(f"mlp act {act!r} is not ported")
    up_tag, down_tag = tags
    up, f1 = dense(x, p["up"], ctx, "mlp_up", tag=up_tag)
    gate, f2 = dense(x, p["gate"], ctx, "mlp_up", tag=up_tag)
    h = torch.nn.functional.silu(gate.to(F32)).to(x.dtype) * up
    out, f3 = dense(h, p["down"], ctx, "mlp_down", tag=down_tag)
    return out, or_flags(f1, f2, f3)
