"""Whisper-tiny — encoder-decoder audio backbone.  The conv frontend
(two width-3 1-D convs over n_mels=80 log-mel frames) is real when the
batch carries ``audio``; precomputed ``enc_input`` frame embeddings
remain accepted as the stub path.  [arXiv:2212.04356; unverified]
(copy of ``repro.configs.whisper_tiny``)"""

from repro_torch.configs.base import ModelConfig, register


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        source="arXiv:2212.04356",
        n_layers=4,            # decoder layers
        n_enc_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        norm="layernorm",
        norm_eps=1e-5,
        act="gelu",
        is_encoder_decoder=True,
        enc_seq_len=1500,
        n_mels=80,
        rope_theta=0.0,        # whisper uses learned/sinusoidal positions
    )
