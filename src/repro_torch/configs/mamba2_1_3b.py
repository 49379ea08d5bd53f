"""Mamba2-1.3B — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]
(copy of ``repro.configs.mamba2_1_3b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("mamba2-1.3b")
def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,                # attention-free, no MLP blocks
        vocab_size=50280,
        norm="rmsnorm",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        ssm_conv_width=4,
        tie_embeddings=True,
    )
