"""Qwen1.5-32B — dense, MHA kv=40, QKV bias.  [hf:Qwen/Qwen1.5-32B; hf]
(copy of ``repro.configs.qwen1_5_32b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-32b")
def qwen1_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        source="hf:Qwen/Qwen1.5-32B",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        norm="rmsnorm",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
