"""Paged KV cache: block-table memory manager, prefix index and device
ops (port of ``repro.serve.paged_cache``).

Per layer the KV tensors are pools ``(num_blocks, block_size, KV, D)``
(GQA's k and v) or ``(num_blocks, block_size, kv_lora + rope)`` (MLA's
latent); a Mamba2 layer keeps its constant-size state a slot, unpaged;
the host ``BlockPool`` owns the free list and one block table per slot,
padded with the out-of-range ``SENTINEL`` (== num_blocks).  A token at
logical position ``t`` of slot ``s`` lives at
``pool[table[s, t // block_size], t % block_size]``.  Writes routed to the
sentinel are dropped; gathers read sentinel blocks as zeros.

Prefix sharing: every physical block carries a refcount (1 when drawn
from the free list, +1 per table entry that aliases it through
``try_admit_prefix``); ``free_slot`` returns a block to the free list only
when its last reference drops, so evicting one sharer never frees a block
a live request still reads.  ``PrefixIndex`` maps hash chains over fully
prefilled blocks (and each prompt's partial tail) to physical ids; lookups
re-verify the stored tokens, entries are added only after a prompt's
prefill read back a clean flag and purged when their block is physically
freed.  A slot that must write into a block another slot references
first redirects its table entry (``try_cow``) and the engine copies the
payload on the device, before any attempt runs.

The port updates the pools in place.  A retry after an ABFT flag is still
sound: tables, refcounts and COW copies only change outside the
attempt/retry window, and a retry rewrites exactly the (block, offset)
cells its attempt wrote.
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
    """Host-side free-list allocator + per-slot block tables with
    per-block refcounts.  Freed blocks go to the head of the free list
    (LIFO)."""

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

    @property
    def blocks_shared(self) -> int:
        """Physical blocks referenced by more than one table entry."""
        return int((self.refcount > 1).sum())

    def ref_of(self, block: int) -> int:
        return int(self.refcount[block])

    def slot_blocks(self, slot: int) -> int:
        return int(self._used[slot])

    def capacity_tokens(self, slot: int) -> int:
        """Tokens the slot's current allocation can hold."""
        return self.slot_blocks(slot) * self.block_size

    def can_admit(self, n_tokens: int) -> bool:
        return blocks_for(n_tokens, self.block_size) <= self.blocks_free

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

    def grow(self, slot: int, n_tokens: int) -> None:
        if not self.try_grow(slot, n_tokens):
            raise PoolExhausted(
                f"slot {slot}: grow to {n_tokens} tokens failed "
                f"({self.blocks_free} blocks free)")

    def try_admit_prefix(self, slot: int, n_tokens: int,
                         shared_ids) -> bool:
        """Admission with a shared prefix: the slot's leading table
        entries alias ``shared_ids`` (refcount +1 each, no free-list
        draw), the rest of ``blocks_for(n_tokens)`` come fresh.
        All-or-nothing."""
        assert self._used[slot] == 0, f"slot {slot} already allocated"
        need = blocks_for(n_tokens, self.block_size)
        k = len(shared_ids)
        assert k <= need, "shared prefix longer than the prompt"
        if need > self.table_width or need - k > len(self._free):
            return False
        for i, blk in enumerate(shared_ids):
            assert self.refcount[blk] >= 1, f"sharing a free block {blk}"
            self.tables[slot, i] = int(blk)
            self.refcount[blk] += 1
        for i in range(k, need):
            blk = self._free.pop()
            self.tables[slot, i] = blk
            self.refcount[blk] = 1
        self._used[slot] = need
        return True

    def try_cow(self, slot: int, idx: int):
        """Copy-on-write: if table entry ``idx`` of ``slot`` aliases a
        block another entry also references, redirect it to a fresh
        block and return ``(src, dst)`` for the device copy; None when the
        block is exclusively owned.  Raises ``PoolExhausted`` when a copy
        is needed and the free list is empty."""
        assert 0 <= idx < int(self._used[slot])
        src = int(self.tables[slot, idx])
        if self.refcount[src] <= 1:
            return None
        if not self._free:
            raise PoolExhausted(f"COW for slot {slot} needs a free block")
        dst = self._free.pop()
        self.refcount[src] -= 1
        self.refcount[dst] = 1
        self.tables[slot, idx] = dst
        return src, dst

    def free_slot(self, slot: int) -> list:
        """Drop the slot's references; blocks whose refcount reaches zero
        return to the free list.  Returns the physically freed ids.
        Idempotent."""
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
        """Refcounts and the free list agree exactly with the tables."""
        assert len(self._free) == len(set(self._free)), "free-list dup"
        refs = np.zeros((self.num_blocks,), np.int32)
        for s in range(self.slots):
            for b in range(int(self._used[s])):
                refs[int(self.tables[s, b])] += 1
        assert (refs == self.refcount).all(), "refcount != table references"
        on_free = np.zeros((self.num_blocks,), bool)
        on_free[self._free] = True
        assert ((self.refcount == 0) == on_free).all(), (
            "a block is on the free list iff its refcount is 0")
        assert self.blocks_free + self.blocks_used == self.num_blocks

    def device_tables(self, rows=None, device="cpu") -> torch.Tensor:
        """Block tables as an int32 tensor — all slots or the given rows."""
        t = self.tables if rows is None else self.tables[np.asarray(rows)]
        return torch.from_numpy(np.ascontiguousarray(t)).to(device)


# ---------------------------------------------------------------- prefix index

_ROOT = "prefix-index-root"


@dataclasses.dataclass
class PrefixMatch:
    """A prefix lookup: the physical blocks the new slot aliases (full
    blocks, plus at most one partial tail the caller must COW before
    writing its suffix into it) and the matched token count."""

    shared_ids: list
    match_len: int
    partial: bool          # last entry of shared_ids is a partial block

    @property
    def full_blocks(self) -> int:
        return len(self.shared_ids) - (1 if self.partial else 0)


class PrefixIndex:
    """Content-hash index over cached prompt blocks.  Full blocks are
    keyed by a hash chain ``key_i = hash((key_{i-1}, tokens_i))``, so a
    block matches only behind the exact prefix that produced its KV; each
    chain node also keeps the partial tails registered under it.  Every
    entry stores its tokens and lookups re-verify them: a hash collision
    is a miss, never a wrong share."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._full: dict = {}       # chain key -> (block_id, tokens)
        self._partial: dict = {}    # chain key -> [(block_id, tokens), ...]
        self._by_block: dict = {}   # block_id -> set of (kind, key)

    def _note(self, block: int, kind: str, key) -> None:
        self._by_block.setdefault(int(block), set()).add((kind, key))

    @staticmethod
    def _chain(parent, tokens: tuple):
        return hash((parent, tokens))

    def add(self, prompt, table_row) -> None:
        """Register a fully prefilled prompt: one chain entry per full
        block and its partial tail.  First writer wins."""
        toks = tuple(int(t) for t in prompt)
        bs = self.block_size
        key = _ROOT
        for i in range(len(toks) // bs):
            blk_toks = toks[i * bs:(i + 1) * bs]
            key = self._chain(key, blk_toks)
            if key not in self._full:
                blk = int(table_row[i])
                self._full[key] = (blk, blk_toks)
                self._note(blk, "full", key)
        rem = len(toks) % bs
        if rem:
            tail = toks[len(toks) - rem:]
            cand = self._partial.setdefault(key, [])
            if not any(t == tail for _, t in cand):
                blk = int(table_row[len(toks) // bs])
                cand.append((blk, tail))
                self._note(blk, "partial", key)

    def match(self, prompt) -> PrefixMatch:
        """Longest cached prefix of ``prompt``, capped at ``len(prompt) -
        1`` tokens so the suffix prefill always has a token to sample
        from.  A partial tail (or a cached full block the cap cut short)
        is shared up to the longest common lead of its tokens."""
        toks = tuple(int(t) for t in prompt)
        bs = self.block_size
        cap = len(toks) - 1
        ids, key, matched = [], _ROOT, 0
        while matched + bs <= cap:
            blk_toks = toks[matched:matched + bs]
            nxt = self._chain(key, blk_toks)
            ent = self._full.get(nxt)
            if ent is None or ent[1] != blk_toks:     # miss or hash clash
                break
            ids.append(ent[0])
            key = nxt
            matched += bs
        best_blk, best_m = None, 0
        candidates = list(self._partial.get(key, []))
        if matched + bs <= len(toks):
            ent = self._full.get(self._chain(key, toks[matched:matched + bs]))
            if ent is not None:
                candidates.append((ent[0], ent[1]))
        for blk, cand_toks in candidates:
            m = 0
            lim = min(len(cand_toks), cap - matched)
            while m < lim and cand_toks[m] == toks[matched + m]:
                m += 1
            if m > best_m:
                best_blk, best_m = blk, m
        if best_m > 0:
            ids.append(best_blk)
            return PrefixMatch(ids, matched + best_m, partial=True)
        return PrefixMatch(ids, matched, partial=False)

    def purge(self, freed_blocks) -> None:
        """Remove every entry naming a physically freed block."""
        for blk in freed_blocks:
            for kind, key in self._by_block.pop(int(blk), ()):
                if kind == "full":
                    ent = self._full.get(key)
                    if ent is not None and ent[0] == int(blk):
                        del self._full[key]
                else:
                    cand = self._partial.get(key)
                    if cand is not None:
                        cand[:] = [c for c in cand if c[0] != int(blk)]
                        if not cand:
                            del self._partial[key]


# ---------------------------------------------------------------- device ops

def init_paged_gqa_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                         dtype, device) -> dict:
    """The (NB, BS, KV_eff, hd) ``k`` and ``v`` pools: the padded kv
    heads (``attention.eff_counts``)."""
    from repro_torch.models.attention import eff_counts

    hd = cfg.resolved_head_dim
    shape = (num_blocks, block_size, eff_counts(cfg)[1], hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_mla_cache(cfg: ModelConfig, num_blocks: int,
                         block_size: int, dtype, device) -> dict:
    """MLA's one pool leaf, the latent (NB, BS, kv_lora + rope): the
    scatters, the gather and the COW copy index its two leading dims, as
    they do the GQA pools'."""
    shape = (num_blocks, block_size,
             cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    return {"latent": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_mamba_cache(cfg: ModelConfig, slots: int, dtype,
                           device) -> dict:
    """A Mamba2 layer's state under the paged engine: constant-size a
    request, so one entry a slot (``mamba.init_mamba_cache``), never
    paged; the block tables do not reach it."""
    from repro_torch.models.mamba import init_mamba_cache

    return init_mamba_cache(cfg, slots, dtype, device)


def _prefill_index(pool, tables, lengths, L: int, starts=None):
    """(blk, off, keep) of a paged prefill of ``L`` padded tokens, each
    (A, L): token t of row a sits at logical position ``starts[a] + t``
    (``starts`` None: 0); the cells written are ``(blk[keep],
    off[keep])``; positions >= lengths[a] and sentinel blocks drop."""
    nb, bs = pool.shape[0], pool.shape[1]
    dev = pool.device
    t = torch.arange(L, device=dev)
    tb = tables.to(dev).long()
    logical = t.expand(tb.shape[0], L)
    if starts is not None:
        logical = starts.to(dev).long()[:, None] + logical
    col = (logical // bs).clamp(max=tb.shape[1] - 1)
    blk = torch.gather(tb, 1, col)                              # (A, L)
    off = logical % bs
    keep = (t[None, :] < lengths.to(dev)[:, None]) & (blk < nb)
    return blk, off, keep


def _decode_index(pool, tables, pos):
    """(blk, off, keep) of a paged decode write, each (B,): row b writes at
    its own cursor; sentinel tables (inactive slots) drop."""
    nb, bs = pool.shape[0], pool.shape[1]
    pos = pos.to(pool.device).long()
    rows = torch.arange(tables.shape[0], device=pool.device)
    blk = tables.to(pool.device).long()[rows, pos // bs]
    return blk, pos % bs, blk < nb


def prefill_write_index(pool, tables, lengths, L: int,
                        starts=None) -> tuple:
    """(cells, src) of a paged prefill of ``L`` padded tokens a row: the
    (block, offset) cells written and, for each, the index of its token
    among the (A * L) rows.  One host read (the mask's ``nonzero``); a
    speculative verify step builds it once and every layer writes through
    it (``index_write``)."""
    blk, off, keep = _prefill_index(pool, tables, lengths, L, starts)
    a, t = keep.nonzero(as_tuple=True)
    return (blk[a, t], off[a, t]), a * L + t


def index_write(leaf, new, index) -> None:
    """Write ``new`` (A, L, ...) into ``leaf`` through a ``(cells, src)``
    index: integer indices only, so the write waits on nothing."""
    cells, src = index
    leaf[cells] = new.reshape(-1, *new.shape[2:])[src].to(leaf.dtype)


def prefill_cells(pool, tables, lengths, L: int, starts=None) -> tuple:
    """Index of the pool cells ``paged_scatter_prefill`` writes."""
    return prefill_write_index(pool, tables, lengths, L, starts)[0]


def decode_cells(pool, tables, pos) -> tuple:
    """Index of the pool cells ``paged_scatter_decode`` writes."""
    blk, off, keep = _decode_index(pool, tables, pos)
    return blk[keep], off[keep]


def paged_scatter_prefill(pool, new, tables, lengths, starts=None) -> None:
    """Write an admission batch into the pool in place.  new: (A, L, ...);
    tables: (A, W); ``new[a, t]`` lands at logical position ``starts[a] +
    t`` (``starts`` None: t — the suffix of a shared prefix or a prompt
    chunk resumes behind its resident KV); positions >= lengths[a] (and
    sentinel blocks) drop, so padding rows (lengths 0) write nothing."""
    index_write(pool, new, prefill_write_index(pool, tables, lengths,
                                               new.shape[1], starts))


def paged_scatter_decode(pool, new, tables, pos) -> None:
    """Write one entry per slot at its own cursor, in place.  new: (B, ...);
    tables: (B, W); pos: (B,).  Sentinel tables (inactive slots) drop."""
    blk, off, keep = _decode_index(pool, tables, pos)
    pool[blk[keep], off[keep]] = new[keep].to(pool.dtype)


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
