"""Assigned-architecture configs (copy of ``repro.configs``).  Importing
this package registers all architectures with the ``--arch`` registry in
configs/base.py; ``models.model.check_supported`` decides which of them
the port serves."""

from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    jamba_v0_1_52b,
    llama3_2_1b,
    llama3_2_vision_11b,
    mamba2_1_3b,
    qwen1_5_32b,
    qwen2_moe_a2_7b,
    qwen3_14b,
    stablelm_1_6b,
    whisper_tiny,
)
from repro_torch.configs.base import (
    ModelConfig,
    get_config,
    list_archs,
    scaled_down,
)

ALL_ARCHS = [
    "qwen3-14b",
    "stablelm-1.6b",
    "llama3.2-1b",
    "qwen1.5-32b",
    "jamba-v0.1-52b",
    "whisper-tiny",
    "mamba2-1.3b",
    "deepseek-v3-671b",
    "qwen2-moe-a2.7b",
    "llama-3.2-vision-11b",
]

__all__ = [
    "ALL_ARCHS",
    "ModelConfig",
    "get_config",
    "list_archs",
    "scaled_down",
]
