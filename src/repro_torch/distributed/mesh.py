"""Canonical mesh construction (port of ``repro.distributed.mesh``): the
one place ``(data, model)`` meshes are built, and the ``ShardingHints``
for a model on one.

The port's ``Mesh`` is a grid of process ranks: one process a rank, each
on its own ``torch.device`` (k ranks may share one card), joined by
``torch.distributed`` (``distributed/spawn.py`` starts them).  It carries
what JAX's carries for the sharding rules, ``shape`` (a dict) and
``axis_names``, plus the grid of ranks, each rank's device, this
process's rank and the process groups of its ``model`` axis (its row of
the grid) and its ``data`` axis (its column), each None when the axis is
one wide or spans the whole world (the collectives then use the default
group, or are the identity), and of the whole grid where it holds fewer
ranks than the world (a restore onto a smaller mesh inside one world:
the ranks off the grid take no part in its collectives).

Functions only: importing this module touches no device and no process
group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(eq=False)
class Mesh:
    grid: np.ndarray            # ranks, shaped as the mesh
    axis_names: tuple
    devices: tuple              # torch.device of each rank, rank order
    rank: int = 0               # this process's rank
    group: object = None        # this rank's model-axis process group
    data_group: object = None   # this rank's data-axis process group
    # every rank of the grid, where the grid holds fewer ranks than the
    # world (None: the default group)
    grid_group: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    def coords(self) -> dict:
        """{axis: index} of this process's rank."""
        pos = np.argwhere(self.grid == self.rank)
        if not len(pos):
            raise ValueError(f"rank {self.rank} is not on the mesh "
                             f"{self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in pos[0])))

    @property
    def model_rank(self) -> int:
        return self.coords()["model"] if "model" in self.axis_names else 0

    @property
    def data_rank(self) -> int:
        return self.coords()["data"] if "data" in self.axis_names else 0

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def holds(self, rank: int) -> bool:
        """Whether ``rank`` is on the grid."""
        return bool((self.grid == rank).any())


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def rank_devices(device_type: str | None = None) -> list:
    """One device a rank of this process's world (a lone process is a
    world of one): rank r on ``cuda:{r % cards}`` where the type is CUDA
    (by default whenever CUDA is available), else on the CPU."""
    dist = _dist()
    world = dist.get_world_size() if dist is not None else None
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device for the mesh's ranks")
        if world is None:
            return [torch.device("cuda", i) for i in range(cards)]
        return [torch.device("cuda", r % cards) for r in range(world)]
    return [torch.device("cpu")] * (world or 1)


def build_mesh(*, model: int = 1, data: int | None = None,
               pod: int | None = None, devices=None) -> Mesh:
    """Build a (data, model) — or (pod, data, model) — mesh.

    ``model``: the tensor-parallel width (the axis ABFT plans are keyed
    on).  ``data``: the data-parallel width, ``None`` for as many replicas
    as the devices allow.  ``devices``: one device a rank (``rank_devices()``
    by default: this process's world).  Raises ``ValueError`` on
    ``model < 1`` and ``RuntimeError`` when the devices cannot host the
    shape; never clamps ``model``.  Under ``torch.distributed`` this
    process's rank and its model- and data-axis groups come with the mesh
    (every rank must build the same mesh: the groups are made
    collectively, every row of the grid and then every column, in grid
    order, by every rank)."""
    devices = rank_devices() if devices is None else list(devices)
    n = len(devices)
    if model < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model}")
    if n < model:
        raise RuntimeError(
            f"not enough devices ({n}) for model_parallel={model}")
    if data is None:
        data = n // model
    shape = (pod, data, model) if pod is not None else (data, model)
    axes = POD_AXES if pod is not None else AXES
    need = 1
    for s in shape:
        need *= s
    if need > n:
        raise RuntimeError(
            f"mesh shape {shape} needs {need} devices, have {n}")
    grid = np.arange(need).reshape(shape)
    dist = _dist()
    rank, group, data_group, grid_group = 0, None, None, None
    if dist is not None:
        rank = dist.get_rank()
        world = dist.get_world_size()
        group = _axis_groups(dist, grid, axes.index("model"), rank, world)
        data_group = _axis_groups(dist, grid, axes.index("data"), rank,
                                  world)
        if 1 < need < world:
            grid_group = dist.new_group(list(range(need)))
    return Mesh(grid=grid, axis_names=axes,
                devices=tuple(devices[:need]), rank=rank, group=group,
                data_group=data_group, grid_group=grid_group)


def _axis_groups(dist, grid, axis: int, rank: int, world: int):
    """One process group for each line of ``grid`` along ``axis`` (the
    ranks that differ in that coordinate alone), made in grid order by
    every rank; returns this rank's (None where the axis is one wide or
    spans the whole world)."""
    n = grid.shape[axis]
    if n == 1 or n >= world:
        return None
    mine = None
    for line in np.moveaxis(grid, axis, -1).reshape(-1, n):
        g = dist.new_group([int(r) for r in line])
        if rank in line:
            mine = g
    return mine


def make_hints(cfg, mesh):
    """``ShardingHints`` for a model on this mesh (the reference's): the
    data axes and their product (the MoE dispatch's group count), the
    expert axis and the MoE mode (EP when the experts divide the model
    axis, else TP on the expert FFN dim)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import ShardingHints

    ba = shd.batch_axes(mesh)
    dp_size = 1
    for a in ba:
        dp_size *= mesh.shape[a]
    ep_fits = (cfg.n_experts % mesh.shape["model"] == 0) \
        if cfg.n_experts else True
    return ShardingHints(dp=ba, dp_size=dp_size, ep=("model",),
                         moe_mode="ep" if ep_fits else "tp")
