"""K3 (fused-ABFT flash decode): the port's plain version, through its
wrappers ``flash_decode`` / ``flash_decode_paged``, against the reference
wrappers running the Pallas kernels in interpret mode.  GQA grouping,
ragged lengths, a permuted block table with sentinel tails, and alien
data in every slot past a row's length.

Tolerances: outputs within 1e-5 (f32 online softmax, same block
partition); bounds within 1e-5 relative; thresholds within 1e-5
relative.  Residuals are f32 rounding noise and are checked against the
threshold, not element-wise.

The split walk and merge (``flash_decode_split_ref``, what the kernel
computes) is held against the sequential walk and against the Pallas
kernel's per-(row, kv head) arrays at every split count: it sums in
another order (per split, then weighted across splits), so f32 outputs
agree within 1e-5 x max|o| and residuals within 1e-5 x the largest bound
of the same check (a residual is rounding noise of sums of that size);
bf16 outputs within 2^-7 x max|o| (one bf16 rounding of either side),
their f32 check arrays as in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_decode_paged_kernel
from repro.kernels import flash_ops as jfo
from repro_torch.kernels import flash_ops
from repro_torch.kernels.flash_attention import (
    decode_splits,
    flash_decode_kernel,
    flash_decode_ref,
    flash_decode_split_ref,
)

torch.set_num_threads(1)


def _paged_case(seed, B=3, KV=2, G=2, D=16, BS=8, W=5):
    rng = np.random.default_rng(seed)
    NB = B * W + 3
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    # alien data everywhere: slots past a row's length hold large garbage
    kp = (5 * rng.standard_normal((NB, BS, KV, D))).astype(np.float32)
    vp = (5 * rng.standard_normal((NB, BS, KV, D))).astype(np.float32)
    table = rng.permutation(NB)[:B * W].reshape(B, W).astype(np.int32)
    lengths = np.array([1, 20, 40][:B], np.int32)
    table[0, 1:] = NB                              # sentinel tail
    return q, kp, vp, table, lengths


def _close(cj, ct):
    np.testing.assert_allclose(ct.threshold.numpy(),
                               np.asarray(cj.threshold), rtol=1e-5)
    assert bool(cj.flag) == bool(ct.flag)
    assert (ct.residual.numpy() <= ct.threshold.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_plain_version_matches_reference(seed):
    q, kp, vp, table, lengths = _paged_case(seed)
    oj, cj = jfo.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(table),
                                    jnp.asarray(lengths))
    ot, ct = flash_ops.flash_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    _close(cj, ct)


@pytest.mark.parametrize("S", [37, 64, 200])
def test_dense_plain_version_matches_reference(S):
    rng = np.random.default_rng(S)
    B, KV, G, D = 3, 2, 2, 16
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    vc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    lengths = np.array([1, S // 2, S], np.int32)
    oj, cj = jfo.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(lengths))
    ot, ct = flash_ops.flash_decode(torch.from_numpy(q),
                                    torch.from_numpy(kc),
                                    torch.from_numpy(vc),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    _close(cj, ct)


def test_alien_data_past_length_changes_nothing():
    """Rewriting every invalid slot changes neither the output nor the
    check vectors (both score-check sides are masked to < length)."""
    q, kp, vp, table, lengths = _paged_case(7)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    a = flash_decode_ref(*args, block=kp.shape[1])
    kp2, vp2 = kp.copy(), vp.copy()
    BS = kp.shape[1]
    for b in range(table.shape[0]):
        for j in range(table.shape[1]):
            blk = table[b, j]
            if blk >= kp.shape[0]:
                continue
            for t in range(BS):
                if j * BS + t >= lengths[b]:
                    kp2[blk, t] = 1e3
                    vp2[blk, t] = -1e3
    owned = set(table[table < kp.shape[0]].tolist())
    for blk in set(range(kp.shape[0])) - owned:
        kp2[blk], vp2[blk] = 7e2, 7e2
    args[1], args[2] = torch.from_numpy(kp2), torch.from_numpy(vp2)
    bsum = flash_decode_ref(*args, block=BS)
    for u, v in zip(a, bsum):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_dense_reads_cache_without_repeat_or_pad():
    """GQA grouping: all query heads of one kv head see the same keys;
    the dense wrapper passes the cache itself (no copy) to the kernel."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(
        np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 13, 2, 8)).astype(
        np.float32))
    seen = {}

    def spy(q_, k_, v_, table, lengths, *, block, scale=None):
        seen["k"], seen["block"] = k_, block
        return flash_decode_ref(q_, k_, v_, table, lengths, block=block)

    orig = flash_ops.flash_decode_ref
    flash_ops.flash_decode_ref = spy
    try:
        flash_ops.flash_decode(q, kc, kc, 5)
    finally:
        flash_ops.flash_decode_ref = orig
    assert seen["k"] is kc and seen["block"] == 16


def test_kernel_wrapper_never_falls_back_for_cpu_tensors():
    q, kp, vp, table, lengths = _paged_case(4)
    with pytest.raises(ValueError):
        flash_decode_kernel(*(torch.from_numpy(a) for a in
                              (q, kp, vp, table, lengths)), block=8)


# ------------------------------------------------- split walk (the kernel)

SPLIT_B, SPLIT_KV, SPLIT_G, SPLIT_D = 4, 2, 2, 16
SPLIT_LENGTHS = np.array([1, 17, 100, 255], np.int32)
SPLIT_CASES = {"paged": (16, 16), "dense": (32, 8)}      # (block, W)


@functools.lru_cache(maxsize=None)
def _split_case(kind, dtype_name):
    """Inputs with garbage (+-1e3) in every slot past a row's length and a
    sentinel tail on row 0, and the Pallas kernel's per-(row, kv head)
    (o, res_s, bnd_s, res_pv, bnd_pv) on them (interpret mode)."""
    rng = np.random.default_rng(11)
    B, KV, G, D = SPLIT_B, SPLIT_KV, SPLIT_G, SPLIT_D
    T, W = SPLIT_CASES[kind]
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    lens = SPLIT_LENGTHS
    if kind == "paged":
        NB = B * W + 3
        kc = (3 * rng.standard_normal((NB, T, KV, D))).astype(np.float32)
        vc = (3 * rng.standard_normal((NB, T, KV, D))).astype(np.float32)
        table = rng.permutation(NB)[:B * W].reshape(B, W).astype(np.int32)
        for b in range(B):
            for j in range(W):
                for t in range(T):
                    if j * T + t >= lens[b]:
                        kc[table[b, j], t], vc[table[b, j], t] = 1e3, -1e3
        table[0, 1:] = NB                           # sentinel tail
    else:
        table = None
        kc = (3 * rng.standard_normal((B, T * W, KV, D))).astype(np.float32)
        vc = (3 * rng.standard_normal((B, T * W, KV, D))).astype(np.float32)
        for b in range(B):
            kc[b, lens[b]:], vc[b, lens[b]:] = 1e3, -1e3
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in (q, kc, vc))
    qg = qj[:, 0].reshape(B, KV, G, D)
    if kind == "paged":
        tb = jnp.clip(jnp.asarray(table), 0, kc.shape[0] - 1)

        def one(qk, kh, vh, t_, ln):
            return flash_decode_paged_kernel(qk, kh, vh, t_, ln,
                                                 interpret=True)
        f = jax.vmap(jax.vmap(one, in_axes=(0, 0, 0, None, None)),
                     in_axes=(0, None, None, 0, 0))
        ref = f(qg, jnp.moveaxis(kj, 2, 0), jnp.moveaxis(vj, 2, 0), tb,
                jnp.asarray(lens)[:, None])
    else:
        def one(qk, kh, vh, ln):             # G query heads on one kv head
            return flash_decode_paged_kernel(
                qk, kh.reshape(W, T, D), vh.reshape(W, T, D),
                jnp.arange(W, dtype=jnp.int32), ln, interpret=True)
        f = jax.vmap(jax.vmap(one, in_axes=(0, 0, 0, None)),
                     in_axes=(0, 0, 0, 0))
        ref = f(qg, jnp.moveaxis(kj, 2, 1), jnp.moveaxis(vj, 2, 1),
                jnp.asarray(lens)[:, None])
    ref = [np.asarray(jnp.asarray(r).astype(jnp.float32)) for r in ref]
    return q, kc, vc, table, lens, ref


def _torch_args(case, dtype):
    q, kc, vc, table, lens, _ = case
    cast = lambda a: torch.from_numpy(a).to(dtype)       # noqa: E731
    return (cast(q), cast(kc), cast(vc),
            None if table is None else torch.from_numpy(table),
            torch.from_numpy(lens))


def _split_params():
    return [(kind, dt, s) for kind, (_, W) in SPLIT_CASES.items()
            for dt in ("float32", "bfloat16") for s in range(1, W + 1)]


@pytest.mark.parametrize("kind,dtype_name,splits", _split_params())
def test_split_plain_version_matches_walk_and_reference(kind, dtype_name,
                                                        splits):
    dtype = getattr(torch, dtype_name)
    case = _split_case(kind, dtype_name)
    T, W = SPLIT_CASES[kind]
    args = _torch_args(case, dtype)
    got = flash_decode_split_ref(*args, block=T, splits=splits)
    seq = flash_decode_ref(*args, block=T)
    B, KV, G = SPLIT_B, SPLIT_KV, SPLIT_G
    jo, jrs, jbs, jrp, jbp = case[5]
    otol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for other_o, other_checks in (
            (seq[0].float().numpy(), [c.numpy() for c in seq[1:]]),
            (jo.reshape(B, 1, KV * G, -1), [jrs, jbs, jrp, jbp])):
        o = got[0].float().numpy()
        assert np.isfinite(o).all()
        assert np.abs(o - other_o).max() <= otol * np.abs(other_o).max()
        rs, bs, rp, bp = (c.numpy() for c in got[1:])
        ors, obs, orp, obp = (np.asarray(c).reshape(B, KV, G)
                              for c in other_checks)
        np.testing.assert_allclose(bs, obs, rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(bp, obp, rtol=1e-5, atol=1e-30)
        assert np.abs(rs - ors).max() <= 1e-5 * obs.max()
        assert np.abs(rp - orp).max() <= 1e-5 * obp.max()
    if splits == 1:       # one split is the sequential walk, bit for bit
        for u, v in zip(got, seq):
            assert torch.equal(u, v)


def test_split_walk_past_the_length_contributes_nothing():
    """Row 0 (length 1) has every split but the first wholly past its
    length: the merged row equals its single-split walk, with no NaN."""
    case = _split_case("paged", "float32")
    args = _torch_args(case, torch.float32)
    one = flash_decode_split_ref(*args, block=16, splits=1)
    for splits in (2, 5, 16):
        many = flash_decode_split_ref(*args, block=16, splits=splits)
        for u, v in zip(many, one):
            assert torch.isfinite(u).all()
            assert torch.equal(u[0], v[0])


@pytest.mark.parametrize("B,KV,W,T,want", [
    (4, 8, 32, 16, 4),       # the paged engine: 4 slots, max_len 512
    (4, 8, 4, 128, 4),       # k3_timing's dense cache (S = 512)
    (2, 2, 4, 16, 2),        # the small engine test (max_len 64), paged
    (2, 2, 1, 64, 1),        # its dense cache: one block
    (1, 1, 64, 16, 32),      # one row: at least 32 keys a split
    (1, 1, 256, 16, 64),     # at most 64 splits (the merge's staging)
    (64, 8, 32, 16, 1),      # 512 CTAs already: no split
])
def test_decode_splits_from_shapes(B, KV, W, T, want):
    s = decode_splits(B, KV, W, T)
    assert s == want and 1 <= s <= W
    per = -(-W // s)
    assert (s - 1) * per < W <= s * per           # no empty tail split
    assert per * T >= min(32, W * T)


@pytest.mark.parametrize("B,KV,G,W,T,want", [
    (4, 8, 4, 32, 16, 4),      # the engine: one CTA a kv head
    (4, 8, 3, 32, 16, 4),      # G = 3 rounds up within one CTA
    (4, 8, 16, 32, 16, 2),     # 16 heads: two CTAs a kv head, 64 CTAs
    (1, 8, 24, 64, 128, 5),    # 24 heads: three CTAs a kv head
])
def test_decode_splits_counts_head_groups(B, KV, G, W, T, want):
    """A kv head of G query heads takes ceil(G / 8) CTAs: the split count
    aims at one wave over all of them."""
    s = decode_splits(B, KV, W, T, G)
    assert s == want and 1 <= s <= W
    assert s * B * KV * -(-G // 8) <= 132 or s == 1
