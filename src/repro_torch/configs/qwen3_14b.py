"""Qwen3-14B — dense, GQA kv=8, qk_norm.  [hf:Qwen/Qwen3-14B; hf]
(copy of ``repro.configs.qwen3_14b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen3-14b")
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        source="hf:Qwen/Qwen3-14B",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        norm="rmsnorm",
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )
