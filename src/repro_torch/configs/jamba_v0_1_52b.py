"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer.  [arXiv:2403.19887; hf]
(copy of ``repro.configs.jamba_v0_1_52b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("jamba-v0.1-52b")
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        norm="rmsnorm",
        # MoE: 16 experts, top-2, every other layer
        n_experts=16,
        experts_per_token=2,
        moe_d_ff=14336,
        moe_every=2,
        # hybrid: 1 attention layer per 8 (offset 4 within each block)
        attn_every=8,
        attn_offset=4,
        # mamba sublayers (mamba-1-style params modeled with the SSD block)
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        rope_theta=10000.0,
    )
