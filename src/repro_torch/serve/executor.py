"""Executor layer of the serving engine (port of ``LocalExecutor``): the
device residency of params, cache and the per-slot sampling generators,
and the engine's protection plan.  Sharded serving (``MeshExecutor``) is
not ported."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  No CUDA and no explicit request is an error, never a silent
    CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree


class LocalExecutor:
    """Single-device executor: owns params and cache."""

    model_parallel = 1

    def __init__(self, model: Model, params, *, dtype, device):
        self.model = model
        self.device = device
        self.params = tree_to(params, device)
        self.dtype = dtype
        self.dtype_bytes = dtype.itemsize
        self.cache = None
        self.gens: list = []

    def init_generators(self, seed: int, slots: int) -> None:
        """One ``torch.Generator`` per slot on the engine's device, each
        seeded from ``seed`` through numpy's ``SeedSequence`` (the slots'
        streams are independent)."""
        seeds = np.random.SeedSequence(int(seed)).generate_state(slots)
        self.gens = [torch.Generator(device=self.device).manual_seed(int(s))
                     for s in seeds]

    def init_dense_cache(self, slots: int, max_len: int) -> None:
        self.cache = self.model.init_cache(slots, max_len, dtype=self.dtype,
                                           device=self.device)

    def init_paged_cache(self, num_blocks: int, block_size: int) -> None:
        self.cache = self.model.init_paged_cache(
            num_blocks, block_size, dtype=self.dtype, device=self.device)

    def protection_plan(self, abft, *, slots: int):
        return self.model.protection_plan(
            hw=abft.hardware, policy=abft.effective_policy(),
            phase="serve", n_tokens=slots, dtype_bytes=self.dtype_bytes)
