"""Historical mesh entry points: thin wrappers over the canonical
constructor in ``repro_torch.distributed.mesh`` (port of
``repro.launch.mesh``).  Functions only: importing this module touches no
device state."""

from __future__ import annotations

from repro_torch.distributed.mesh import build_mesh, rank_devices


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: one pod = 16 x 16 ranks, multi-pod = 2 pods
    with a leading 'pod' data-parallel axis."""
    if multi_pod:
        return build_mesh(pod=2, data=16, model=16)
    return build_mesh(data=16, model=16)


def make_host_mesh():
    """A (1, n) mesh over every rank of this process's world."""
    return build_mesh(data=1, model=len(rank_devices()))


def make_mesh_from_devices(devices, *, model_parallel: int):
    """Elastic variant: a (data, model) mesh over a surviving device list.
    Raises when the survivors cannot host ``model_parallel``."""
    return build_mesh(model=model_parallel, devices=devices)
