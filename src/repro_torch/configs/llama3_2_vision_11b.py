"""Llama-3.2-11B-Vision — text backbone with cross-attention image layers
every 5th layer; vision frontend is a stub (input_specs provides patch
embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(copy of ``repro.configs.llama3_2_vision_11b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-11b")
def llama3_2_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        norm="rmsnorm",
        rope_theta=500_000.0,
        cross_attn_every=5,
        vision_dim=1280,
        n_image_tokens=1601,
    )
