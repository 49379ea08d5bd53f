"""DeepSeek-V3 (671B) — MLA attention, 1 shared + 256 routed experts top-8,
MTP.  [arXiv:2412.19437; hf]
(copy of ``repro.configs.deepseek_v3_671b``)"""

from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v3-671b")
def deepseek_v3_671b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        source="arXiv:2412.19437",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,              # dense FFN width (first 3 layers)
        vocab_size=129280,
        norm="rmsnorm",
        # MoE
        n_experts=256,
        n_shared_experts=1,
        experts_per_token=8,
        moe_d_ff=2048,
        moe_every=1,
        first_dense_layers=3,
        # MLA
        attention="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        head_dim=192,            # qk_nope + qk_rope
        mtp_depth=1,
        rope_theta=10000.0,
    )
