"""Per-GEMM-site dims for protection plans (port of the dense-GQA part of
``repro.models.counting``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.intensity import GemmDims
from repro_torch.models.model import check_supported, layer_tags


def shard_gemms(sites: dict, cfg: ModelConfig, model_parallel: int) -> dict:
    """Per-device dims under tensor parallelism: not ported (one card)."""
    if int(model_parallel) > 1:
        raise NotImplementedError("tensor-parallel plans are not ported")
    return sites


def layer_gemms(cfg: ModelConfig, n_tokens: int, phase: str = "prefill",
                dtype_bytes: int = 2, model_parallel: int = 1) -> dict:
    """{site: (GemmDims, multiplicity)} for one representative layer plus
    the head; ``n_tokens`` is the GEMM M dim."""
    check_supported(cfg)
    hd = cfg.resolved_head_dim

    def g(k, n):
        return GemmDims(m=n_tokens, k=k, n=n, dtype_bytes=dtype_bytes)

    n_layers = len(layer_tags(cfg))
    sites = {
        "attn.q": (g(cfg.d_model, cfg.n_heads * hd), n_layers),
        "attn.k": (g(cfg.d_model, cfg.n_kv_heads * hd), n_layers),
        "attn.v": (g(cfg.d_model, cfg.n_kv_heads * hd), n_layers),
        "attn.o": (g(cfg.n_heads * hd, cfg.d_model), n_layers),
        "mlp.up": (g(cfg.d_model, cfg.d_ff), n_layers * 2),
        "mlp.down": (g(cfg.d_ff, cfg.d_model), n_layers),
        "lm_head": (g(cfg.d_model, cfg.vocab_size), 1),
    }
    return shard_gemms(sites, cfg, model_parallel)


def layer_specs(cfg: ModelConfig, n_tokens: int, phase: str = "prefill",
                dtype_bytes: int = 2, model_parallel: int = 1) -> list:
    """Plan-ready ``LayerSpec``s; the first-layer flag sits on ``attn.q``
    (the mixer projection of the stack's first layer)."""
    from repro_torch.core.policy import LayerSpec

    sites = layer_gemms(cfg, n_tokens, phase, dtype_bytes, model_parallel)
    return [LayerSpec(name=name, dims=dims, count=count,
                      first=(name == "attn.q"))
            for name, (dims, count) in sites.items()]
