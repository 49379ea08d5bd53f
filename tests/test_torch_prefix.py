"""Refcounted block pool and prefix index against the reference.

The same seeded sequence of ``try_alloc`` / ``try_admit_prefix`` /
``try_cow`` / ``grow`` / ``try_grow`` / ``free_slot`` calls, and of
``PrefixIndex.add`` / ``match`` / ``purge`` calls, runs through
``repro.serve.paged_cache`` and ``repro_torch.serve.paged_cache``.  The
tables, refcounts, free list, the blocks each free returns, every COW
pair and every match must be EQUAL (host logic: exact).  A random
lifecycle (admit with the longest match, COW the partial tail, grow,
evict, register only clean prompts) must hold the invariants at every
step, never leak and never double-free.
"""

import numpy as np
import pytest

from repro.serve import paged_cache as jpc
from repro_torch.serve import paged_cache as tpc


def _pair(nb, bs, slots, width):
    return (jpc.BlockPool(nb, bs, slots, width),
            tpc.BlockPool(nb, bs, slots, width))


def _same_pool(a, b):
    assert (a.tables == b.tables).all()
    assert (a.refcount == b.refcount).all()
    assert a._free == b._free
    assert (a._used == b._used).all()
    assert a.blocks_shared == b.blocks_shared
    b.check_invariants()


def _same_match(m, n):
    assert (list(m.shared_ids), m.match_len, m.partial, m.full_blocks) == \
        (list(n.shared_ids), n.match_len, n.partial, n.full_blocks)


def _lifecycle(seed, pools, indexes, steps=300):
    """Drive both (pool, index) pairs through one random lifecycle; every
    result must agree.  Returns the number of shares and COWs seen."""
    rng = np.random.default_rng(seed)
    (jp, tp), (ji, ti) = pools, indexes
    bs, slots = tp.block_size, tp.slots
    # a few templates so prompts share prefixes of every length
    templates = [rng.integers(1, 9, size=int(n)) for n in (5, 11, 16, 23)]
    prompts = {}
    shares = cows = 0
    for _ in range(steps):
        s = int(rng.integers(slots))
        op = rng.random()
        if tp.slot_blocks(s) == 0 and op < 0.6:
            base = templates[int(rng.integers(len(templates)))]
            cut = int(rng.integers(1, len(base) + 1))
            tail = rng.integers(1, 9, size=int(rng.integers(0, 6)))
            prompt = np.concatenate([base[:cut], tail]).astype(np.int32)
            if len(prompt) < 2:
                continue
            jm, tm = ji.match(prompt), ti.match(prompt)
            _same_match(jm, tm)
            if tm.shared_ids:
                ok = (jp.try_admit_prefix(s, len(prompt), jm.shared_ids),
                      tp.try_admit_prefix(s, len(prompt), tm.shared_ids))
                assert ok[0] == ok[1]
                if ok[1]:
                    shares += 1
                    if tm.partial:
                        idx = len(tm.shared_ids) - 1
                        if tp.blocks_free:
                            pair = (jp.try_cow(s, idx), tp.try_cow(s, idx))
                            assert pair[0] == pair[1]
                            cows += pair[1] is not None
                        else:
                            with pytest.raises(jpc.PoolExhausted):
                                jp.try_cow(s, idx)
                            with pytest.raises(tpc.PoolExhausted):
                                tp.try_cow(s, idx)
            else:
                ok = (jp.try_alloc(s, len(prompt)),
                      tp.try_alloc(s, len(prompt)))
                assert ok[0] == ok[1]
            if ok[1]:
                prompts[s] = prompt
                if rng.random() < 0.8:        # its prefill read back clean
                    ji.add(prompt, jp.tables[s])
                    ti.add(prompt, tp.tables[s])
        elif tp.slot_blocks(s) and op < 0.75:
            n = tp.capacity_tokens(s) + int(rng.integers(1, 2 * bs))
            assert jp.try_grow(s, n) == tp.try_grow(s, n)
        elif tp.slot_blocks(s):
            freed = (jp.free_slot(s), tp.free_slot(s))
            assert freed[0] == freed[1]
            ji.purge(freed[0])
            ti.purge(freed[1])
            prompts.pop(s, None)
        _same_pool(jp, tp)
        jp.check_invariants()
        assert ji._by_block.keys() == ti._by_block.keys()
    return shares, cows


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_lifecycle_matches_reference(seed):
    pools = _pair(24, 4, 5, 8)
    indexes = (jpc.PrefixIndex(4), tpc.PrefixIndex(4))
    shares, cows = _lifecycle(seed, pools, indexes)
    assert shares > 0 and cows > 0
    # drain: every block comes back exactly once
    jp, tp = pools
    for s in range(tp.slots):
        assert jp.free_slot(s) == tp.free_slot(s)
    _same_pool(jp, tp)
    assert tp.blocks_free == tp.num_blocks and not tp.refcount.any()


def test_admit_prefix_cow_grow_free_sequence():
    """A fixed sequence with known answers: two sharers of two full
    blocks and a partial tail, the COW of the tail, growth, eviction of
    one sharer (blocks stay), then of the other (blocks return)."""
    jp, tp = _pair(8, 4, 3, 4)
    for p in (jp, tp):
        assert p.try_alloc(0, 10)                  # blocks 0, 1, 2
        assert p.try_admit_prefix(1, 11, [0, 1, 2])
        assert p.ref_of(0) == p.ref_of(2) == 2 and p.blocks_shared == 3
        assert p.try_cow(1, 2) == (2, 3)           # slot 1's tail -> 3
        assert p.try_cow(1, 0) == (0, 4)           # a full block too
        assert p.try_cow(0, 1) == (1, 5)
        assert p.try_cow(0, 1) is None             # now exclusively owned
        p.grow(1, 16)                              # one more block
        with pytest.raises((jpc.PoolExhausted, tpc.PoolExhausted)):
            p.grow(2, 17)                          # > table width
        assert not p.can_admit(40)
    _same_pool(jp, tp)
    assert jp.free_slot(0) == tp.free_slot(0)
    assert jp.free_slot(1) == tp.free_slot(1)
    _same_pool(jp, tp)
    assert tp.blocks_free == 8


def test_index_add_match_purge_sequence():
    """Chains, partial tails, the cap at len - 1, a full block seeding a
    partial share, first writer wins, purge by freed block."""
    ji, ti = jpc.PrefixIndex(4), tpc.PrefixIndex(4)
    a = np.arange(1, 11)                           # 2 full + tail of 2
    b = np.concatenate([np.arange(1, 9), [7, 7, 7]])
    c = np.arange(1, 9)                            # block-aligned
    for idx in (ji, ti):
        idx.add(a, [10, 11, 12])
        idx.add(b, [20, 21, 22])                   # full blocks: a's win
        idx.add(c, [30, 31])
    queries = [a, b, c, np.arange(1, 13), np.arange(1, 6), np.arange(2, 9),
               np.concatenate([np.arange(1, 9), [9, 7]]), np.array([1, 2])]
    for q in queries:
        _same_match(ji.match(q), ti.match(q))
    assert ti.match(a).shared_ids == [10, 11, 12] and ti.match(a).partial
    assert ti.match(c).match_len == 7              # capped at len - 1
    for freed in ([12], [10], [22, 31]):
        ji.purge(freed)
        ti.purge(freed)
        for q in queries:
            _same_match(ji.match(q), ti.match(q))
    assert ti.match(a).match_len == 0


def test_paged_scatter_prefill_starts_matches_reference():
    """The suffix scatter (``starts=``) writes the reference's cells:
    padding and lengths-0 rows write nothing."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(0)
    pool = rng.standard_normal((9, 4, 2, 3)).astype(np.float32)
    new = rng.standard_normal((3, 6, 2, 3)).astype(np.float32)
    tables = np.array([[0, 1, 2, 9], [3, 4, 9, 9], [0, 1, 2, 9]], np.int32)
    lengths = np.array([5, 3, 0], np.int32)
    starts = np.array([6, 2, 0], np.int32)
    want = np.asarray(jpc.paged_scatter_prefill(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(tables),
        jnp.asarray(lengths), starts=jnp.asarray(starts)))
    got = torch.from_numpy(pool.copy())
    tpc.paged_scatter_prefill(got, torch.from_numpy(new),
                              torch.from_numpy(tables),
                              torch.from_numpy(lengths),
                              starts=torch.from_numpy(starts))
    assert np.array_equal(got.numpy(), want)
    blk, off = tpc.prefill_cells(got, torch.from_numpy(tables),
                                 torch.from_numpy(lengths), 6,
                                 torch.from_numpy(starts))
    changed = np.argwhere((want != pool).any(axis=(2, 3)))
    assert sorted(zip(blk.tolist(), off.tolist())) == \
        sorted(map(tuple, changed.tolist()))
