"""Architectures the port serves.  Importing this package registers them
with the ``--arch`` registry in configs/base.py."""

from repro_torch.configs import llama3_2_1b  # noqa: F401
from repro_torch.configs.base import ModelConfig, get_config, list_archs, scaled_down

ALL_ARCHS = ["llama3.2-1b"]

__all__ = ["ALL_ARCHS", "ModelConfig", "get_config", "list_archs", "scaled_down"]
