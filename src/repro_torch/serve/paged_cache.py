"""Paged KV cache: block-table memory manager and device ops (port of
``repro.serve.paged_cache`` without prefix sharing).

Per layer the KV tensors are pools ``(num_blocks, block_size, KV, D)``;
the host ``BlockPool`` owns the free list and one block table per slot,
padded with the out-of-range ``SENTINEL`` (== num_blocks).  A token at
logical position ``t`` of slot ``s`` lives at
``pool[table[s, t // block_size], t % block_size]``.  Writes routed to the
sentinel are dropped; gathers read sentinel blocks as zeros.

The port updates the pools in place.  A retry after an ABFT flag is still
sound: tables only change outside the attempt/retry window, and a retry
rewrites exactly the (block, offset) cells its attempt wrote.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class PoolExhausted(Exception):
    """Raised by the strict alloc API when the free list cannot cover a
    request (the engine uses the non-throwing ``try_*`` variants)."""


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``n_tokens`` cache entries."""
    return max(0, -(-int(n_tokens) // block_size))


@dataclasses.dataclass
class BlockPool:
    """Host-side free-list allocator + per-slot block tables.  Freed
    blocks go to the head of the free list (LIFO)."""

    num_blocks: int
    block_size: int
    slots: int
    table_width: int

    def __post_init__(self):
        assert self.num_blocks >= 1 and self.block_size >= 1
        self.reset()

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_used(self) -> int:
        return self.num_blocks - len(self._free)

    def reset(self) -> None:
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._used = np.zeros((self.slots,), np.int32)
        self.refcount = np.zeros((self.num_blocks,), np.int32)
        self.tables = np.full(
            (self.slots, self.table_width), self.num_blocks, np.int32)
        self.sentinel = self.num_blocks

    def try_alloc(self, slot: int, n_tokens: int) -> bool:
        """All-or-nothing allocation for a fresh sequence."""
        assert self._used[slot] == 0, f"slot {slot} already allocated"
        return self.try_grow(slot, n_tokens)

    def alloc(self, slot: int, n_tokens: int) -> None:
        if not self.try_alloc(slot, n_tokens):
            raise PoolExhausted(
                f"need {blocks_for(n_tokens, self.block_size)} blocks, "
                f"{self.blocks_free} free")

    def try_grow(self, slot: int, n_tokens: int) -> bool:
        """Ensure ``slot`` can hold ``n_tokens`` tokens.  All-or-nothing."""
        need = blocks_for(n_tokens, self.block_size)
        have = int(self._used[slot])
        if need <= have:
            return True
        if need > self.table_width or need - have > len(self._free):
            return False
        for b in range(have, need):
            blk = self._free.pop()
            self.tables[slot, b] = blk
            self.refcount[blk] = 1
        self._used[slot] = need
        return True

    def free_slot(self, slot: int) -> list:
        """Drop the slot's blocks; returns the physically freed ids."""
        n = int(self._used[slot])
        freed = []
        for b in range(n - 1, -1, -1):
            blk = int(self.tables[slot, b])
            self.refcount[blk] -= 1
            assert self.refcount[blk] >= 0, f"double free of block {blk}"
            if self.refcount[blk] == 0:
                self._free.append(blk)
                freed.append(blk)
        self.tables[slot, :] = self.num_blocks
        self._used[slot] = 0
        return freed

    def check_invariants(self) -> None:
        assert len(self._free) == len(set(self._free)), "free-list dup"
        refs = np.zeros((self.num_blocks,), np.int32)
        for s in range(self.slots):
            for b in range(int(self._used[s])):
                refs[int(self.tables[s, b])] += 1
        assert (refs == self.refcount).all(), "refcount != table references"
        assert self.blocks_free + self.blocks_used == self.num_blocks

    def device_tables(self, rows=None, device="cpu") -> torch.Tensor:
        """Block tables as an int32 tensor — all slots or the given rows."""
        t = self.tables if rows is None else self.tables[np.asarray(rows)]
        return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def init_paged_gqa_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                         dtype, device) -> dict:
    hd = cfg.resolved_head_dim
    shape = (num_blocks, block_size, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_scatter_prefill(pool, new, tables, lengths) -> None:
    """Write an admission batch into the pool in place.  new: (A, L, ...);
    tables: (A, W); positions >= lengths[a] (and sentinel blocks) drop."""
    nb, bs = pool.shape[0], pool.shape[1]
    A, L = new.shape[0], new.shape[1]
    t = torch.arange(L, device=pool.device)
    col = (t // bs).clamp(max=tables.shape[1] - 1)
    blk = tables.to(pool.device).long()[:, col]                 # (A, L)
    off = (t % bs).expand(A, L)
    keep = (t[None, :] < lengths.to(pool.device)[:, None]) & (blk < nb)
    pool[blk[keep], off[keep]] = new[keep].to(pool.dtype)


def paged_scatter_decode(pool, new, tables, pos) -> None:
    """Write one entry per slot at its own cursor, in place.  new: (B, ...);
    tables: (B, W); pos: (B,).  Sentinel tables (inactive slots) drop."""
    nb, bs = pool.shape[0], pool.shape[1]
    pos = pos.to(pool.device).long()
    rows = torch.arange(new.shape[0], device=pool.device)
    blk = tables.to(pool.device).long()[rows, pos // bs]
    keep = blk < nb
    pool[blk[keep], (pos % bs)[keep]] = new[keep].to(pool.dtype)


def paged_gather(pool, tables):
    """Materialize per-slot contiguous KV: (B, W*BS, ...); sentinel blocks
    read as zeros (the plain-attention path; K3 reads the pool in place)."""
    nb, bs = pool.shape[0], pool.shape[1]
    tb = tables.to(pool.device).long()
    g = pool[tb.clamp(max=nb - 1)]
    ok = (tb < nb).reshape(tb.shape + (1,) * (g.dim() - 2))
    g = torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device))
    B, W = tb.shape
    return g.reshape((B, W * bs) + tuple(pool.shape[2:]))


def pytree_bytes(tree) -> int:
    """Total bytes of every tensor in a nested dict/list structure."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(pytree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_bytes(v) for v in tree)
    return 0
