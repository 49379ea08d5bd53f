"""StableLM-2-1.6B — dense, MHA (kv=32), LayerNorm, partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]
(copy of ``repro.configs.stablelm_1_6b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("stablelm-1.6b")
def stablelm_1_6b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        norm="layernorm",
        norm_eps=1e-5,
        rope_pct=0.25,
        rope_theta=10000.0,
    )
