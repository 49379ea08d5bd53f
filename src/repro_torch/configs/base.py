"""Model configuration schema + registry (copy of ``repro.configs.base``).

One ``ModelConfig`` describes any architecture in the pool: dense decoder
LMs, MoE, hybrid SSM+attention, pure SSM, encoder-decoder, and VLM
backbones.  Every architecture registers itself via ``register``; the
launcher resolves ``--arch <id>`` through ``get_config``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    source: str = ""                # provenance note ([hf:...]/[arXiv:...])

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu (plain MLP)
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 10000.0
    rope_pct: float = 1.0           # stablelm-2: partial rotary (25%)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    moe_every: int = 1              # every k-th layer is MoE (jamba: 2)
    first_dense_layers: int = 0     # deepseek-v3: 3
    capacity_factor: float = 1.25

    # attention flavor
    attention: str = "gqa"          # gqa | mla
    q_lora_rank: int = 0            # MLA
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0              # deepseek multi-token prediction heads

    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    attn_every: int = 0             # jamba: 1 attention layer per 8
    attn_offset: int = 0            # index within the period that is attn

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500         # whisper audio frames after conv stem
    n_mels: int = 0                 # log-mel bins feeding the conv stem
                                    # (0: stem disabled, enc_input stub)

    # VLM (llama-3.2-vision): cross-attention every k-th layer
    cross_attn_every: int = 0
    vision_dim: int = 0
    n_image_tokens: int = 1601      # 448/14 patches + cls, per tile

    # numerics
    dtype: str = "bfloat16"

    # TP head padding (perf feature, EXPERIMENTS.md §Perf): pad attention
    # heads with zero-weighted extras so head counts divide the model axis
    # — mathematically exact (padded wo rows are zero), eliminates
    # per-layer head-dim resharding when n_heads % tp != 0.
    pad_heads_to: int = 0
    pad_kv_heads_to: int = 0

    @property
    def eff_heads(self) -> int:
        return max(self.pad_heads_to, self.n_heads)

    @property
    def eff_kv_heads(self) -> int:
        kv = max(self.pad_kv_heads_to, self.n_kv_heads)
        # GQA requires eff_heads % eff_kv_heads == 0
        return kv

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, idx: int) -> str:
        """Static per-layer structure: 'attn' | 'mamba' for hybrid stacks,
        and 'dense' | 'moe' for the FFN slot."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid" and self.attn_every:
            return (
                "attn" if idx % self.attn_every == self.attn_offset
                else "mamba"
            )
        return "attn"

    def ffn_kind(self, idx: int) -> str:
        if not self.n_experts:
            return "dense"
        if idx < self.first_dense_layers:
            return "dense"
        if (idx - self.first_dense_layers) % max(self.moe_every, 1) == 0 \
                or self.moe_every == 1:
            return "moe"
        return "dense"

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and reporting)."""
        from repro_torch.models.counting import count_params

        return count_params(self)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)

    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    defaults = dict(
        n_layers=min(cfg.n_layers, 2 * max(cfg.moe_every, 1)
                     * max(cfg.attn_every, 1) if cfg.attn_every else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        vocab_size=256,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq_len=16 if cfg.is_encoder_decoder else cfg.enc_seq_len,
        n_mels=8 if cfg.n_mels else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_head_dim=16 if cfg.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if cfg.qk_rope_head_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        vision_dim=32 if cfg.vision_dim else 0,
        n_image_tokens=8 if cfg.vision_dim else cfg.n_image_tokens,
        first_dense_layers=min(cfg.first_dense_layers, 1),
    )
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
