"""Distribution: sharding rules, mesh construction, the collectives of
tensor-parallel serving and the launcher of its ranks (port of
``repro.distributed``)."""

from repro_torch.distributed.sharding import (
    batch_axes,
    batch_specs,
    cache_specs,
    expert_axes,
    logits_spec,
    make_sharding,
    opt_state_specs,
    param_specs,
)

__all__ = [
    "batch_axes",
    "batch_specs",
    "cache_specs",
    "expert_axes",
    "logits_spec",
    "make_sharding",
    "opt_state_specs",
    "param_specs",
]
