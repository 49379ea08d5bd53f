"""Llama-3.2-1B — small llama3, GQA kv=8.  [hf:meta-llama/Llama-3.2-1B;
unverified]  (copy of ``repro.configs.llama3_2_1b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("llama3.2-1b")
def llama3_2_1b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        norm="rmsnorm",
        rope_theta=500_000.0,
        tie_embeddings=True,
    )
