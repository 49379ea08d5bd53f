"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
(copy of ``repro.configs.qwen2_moe_a2_7b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=5632,               # shared-expert path width (4x1408)
        vocab_size=151936,
        norm="rmsnorm",
        n_experts=60,
        n_shared_experts=4,
        experts_per_token=4,
        moe_d_ff=1408,
        moe_every=1,
        rope_theta=1_000_000.0,
    )
