"""MLA in the port (``models/attention.py``: ``init_mla``, the ``mla_*``
paths, ``init_mla_cache``; ``serve/paged_cache.py::init_paged_mla_cache``)
against the reference's, function by function, at ``scaled_down``
deepseek-v3-671b (4 heads, q/kv latent ranks 32, head dims 16 + 8, f32).
Inputs and the reference's ``init_mla`` params come from seeds and cross
over through numpy; the reference runs its block schemes through the XLA
emulation (``use_pallas=False``; K1 in interpret mode for a faulted call),
the port the K1 plain versions.

Tolerances (f32, the same sums in another order): outputs and latent
cells within 1e-5 absolute and relative (a single sublayer, values of
order 1e-2..1); flags equal.  Port-only identities are bitwise: a
verify row against the decode step at its position, and the serving
prefill (row-wise attention, absorbed products in fixed row blocks) whole
against suffix and chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, ModelFault as JMF
from repro.models import attention as jattn
from repro.serve import paged_cache as jpc
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models import attention as tattn
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model
from repro_torch.serve import paged_cache as tpc

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
B, S, BS = 3, 32, 8          # slots, cache depth, block size
NB = B * S // BS
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def mla():
    jcfg = jscaled(jget(ARCH))
    cfg = scaled_down(get_config(ARCH))
    jp = jattn.init_mla(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _ctxs(site=None):
    """A faulted call compares with the reference's Pallas K1 (interpret
    mode): its emulation corrupts (row, col) in every batch row, the kernel
    (and the port) flattened row ``row`` only."""
    jf = tf = None
    if site is not None:
        jf = JMF.at(0, site, JFault.value(0, 2, 1e4))
        tf = ModelFault.at(0, site, FaultSpec.value(0, 2, 1e4))
    return (JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=jf is not None,
                                        hardware=JTPU), fault=jf),
            LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                 hardware=TPU_V5E),
                     fault=tf))


def _x(cfg, n, L, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, L, cfg.d_model)).astype(np.float32)


def _tables():
    """A block table a slot, the blocks shuffled across the pool."""
    perm = np.random.default_rng(2).permutation(NB).astype(np.int32)
    return perm.reshape(B, S // BS)


def _caches(cfg, jcfg, kind, fill_seed=None):
    """The reference's and the port's empty (or seeded) latent caches."""
    if kind == "paged":
        jc = jpc.init_paged_mla_cache(jcfg, NB, BS, jnp.float32)
        tc = tpc.init_paged_mla_cache(cfg, NB, BS, torch.float32, "cpu")
    else:
        jc = jattn.init_mla_cache(jcfg, B, S, jnp.float32)
        tc = tattn.init_mla_cache(cfg, B, S, torch.float32, "cpu")
    if fill_seed is not None:
        lat = np.random.default_rng(fill_seed).standard_normal(
            tuple(tc["latent"].shape)).astype(np.float32)
        jc = {"latent": jnp.asarray(lat)}
        tc = {"latent": torch.from_numpy(lat.copy())}
    return jc, tc


def _same(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_leaves_and_caches_have_the_references_shapes(mla):
    jcfg, cfg, jp, tp = mla
    own = tattn.init_mla(cfg, lambda *s: torch.zeros(s),
                         lambda n, fill: torch.full((n,), fill))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert own["q_a_norm"].eq(1).all() and own["kv_a_norm"].eq(1).all()
    for kind in ("dense", "paged"):
        jc, tc = _caches(cfg, jcfg, kind)
        assert list(tc) == list(jc) == ["latent"]
        assert tuple(tc["latent"].shape) == tuple(jc["latent"].shape)
    full = get_config(ARCH)
    assert tuple(tattn.init_mla_cache(full, 1, 2, torch.bfloat16, "meta")[
        "latent"].shape) == (1, 2, 576)


@pytest.mark.parametrize("site", [None, "q_a", "kv_a", "attn_out"])
def test_forward_matches_reference(mla, site):
    jcfg, cfg, jp, tp = mla
    x = _x(cfg, 2, 16)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    jctx, tctx = _ctxs(site)
    jo, jf = jattn.mla_forward(jnp.asarray(x), jp, jcfg, jctx,
                               jnp.asarray(pos))
    to, tf = tattn.mla_forward(torch.from_numpy(x), tp, cfg, tctx,
                               torch.from_numpy(pos.copy()))
    _same(to, jo)
    assert bool(tf) == bool(jf) == (site is not None)


@pytest.mark.parametrize("kind", ["whole", "slots", "starts"])
def test_prefill_matches_reference(mla, kind):
    """``whole``: a B-deep cache filled from row 0; ``slots``: ragged rows
    into engine slots; ``starts``: a chunk behind a resident prefix (the
    cache seeded), attending the slots' rows."""
    jcfg, cfg, jp, tp = mla
    L = 8
    slots = np.array([2, 0], np.int32)
    lengths = np.array([5, 8], np.int32)
    starts = np.array([6, 3], np.int32) if kind == "starts" else None
    if kind == "whole":
        x, jc, tc = _x(cfg, B, L), *_caches(cfg, jcfg, "dense")
        pos = np.broadcast_to(np.arange(L), (B, L))
    else:
        x = _x(cfg, 2, L)
        jc, tc = _caches(cfg, jcfg, "dense",
                         fill_seed=5 if kind == "starts" else None)
        pos = np.broadcast_to(np.arange(L), (2, L)) + (
            0 if starts is None else starts[:, None])
    jctx, tctx = _ctxs()
    kw = {} if kind == "whole" else dict(slots=slots, lengths=lengths)
    if starts is not None:
        kw["starts"] = starts
    jo, jnew, _ = jattn.mla_prefill(
        jnp.asarray(x), jp, jcfg, jctx, jnp.asarray(pos), jc,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    to, tf = tattn.mla_prefill(
        torch.from_numpy(x), tp, cfg, tctx, torch.from_numpy(pos.copy()),
        tc, **{k: torch.from_numpy(v) for k, v in kw.items()})
    if kind == "whole":
        _same(to, jo)
    else:      # padding rows past each length are not compared
        for a, n in enumerate(lengths):
            _same(to[a, :n], jo[a, :n])
    _same(tc["latent"], jnew["latent"])
    assert not bool(tf)


def _decode_inputs(cfg):
    x = _x(cfg, B, 1, seed=7)
    pos = np.array([5, 0, 17], np.int32)
    return x, pos


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_decode_matches_reference(mla, kind):
    jcfg, cfg, jp, tp = mla
    x, pos = _decode_inputs(cfg)
    jc, tc = _caches(cfg, jcfg, kind, fill_seed=9)
    jctx, tctx = _ctxs()
    tab = _tables()
    if kind == "paged":
        jo, jnew, _ = jattn.mla_paged_decode(
            jnp.asarray(x), jp, jcfg, jctx, jnp.asarray(pos), jc,
            jnp.asarray(tab))
        to, _ = tattn.mla_paged_decode(
            torch.from_numpy(x), tp, cfg, tctx, torch.from_numpy(pos), tc,
            torch.from_numpy(tab))
    else:
        jo, jnew, _ = jattn.mla_decode(jnp.asarray(x), jp, jcfg, jctx,
                                       jnp.asarray(pos), jc)
        to, _ = tattn.mla_decode(torch.from_numpy(x), tp, cfg, tctx,
                                 torch.from_numpy(pos), tc)
    _same(to, jo)
    _same(tc["latent"], jnew["latent"])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_matches_reference(mla, kind):
    """A window of T = 4 a row from each cursor, ``valid`` 4, 1 and 2:
    rows past ``valid`` write nothing (their outputs are discarded)."""
    jcfg, cfg, jp, tp = mla
    T = 4
    x = _x(cfg, B, T, seed=8)
    pos = np.array([5, 0, 27], np.int32)
    valid = np.array([4, 1, 2], np.int32)
    jc, tc = _caches(cfg, jcfg, kind, fill_seed=10)
    jctx, tctx = _ctxs()
    tab = _tables()
    tx, tpos, tvalid = (torch.from_numpy(a) for a in (x, pos, valid))
    if kind == "paged":
        jo, jnew, _ = jattn.mla_paged_verify(
            jnp.asarray(x), jp, jcfg, jctx, jnp.asarray(pos), jc,
            jnp.asarray(valid), jnp.asarray(tab))
        index = tpc.prefill_write_index(tc["latent"], torch.from_numpy(tab),
                                        tvalid, T, tpos)
        to, _ = tattn.mla_paged_verify(tx, tp, cfg, tctx, tpos, tc, index,
                                       torch.from_numpy(tab))
    else:
        jo, jnew, _ = jattn.mla_verify(jnp.asarray(x), jp, jcfg, jctx,
                                       jnp.asarray(pos), jc,
                                       jnp.asarray(valid))
        index = tattn.verify_write_index(tpos, tvalid, T, S)
        to, _ = tattn.mla_verify(tx, tp, cfg, tctx, tpos, tc, index)
    for b, n in enumerate(valid):
        _same(to[b, :n], jo[b, :n])
    _same(tc["latent"], jnew["latent"])


@pytest.mark.parametrize("kind", ["whole", "starts"])
def test_paged_prefill_matches_reference(mla, kind):
    jcfg, cfg, jp, tp = mla
    L = 8
    lengths = np.array([5, 8, 0], np.int32)       # a padding row
    starts = np.array([9, 2, 0], np.int32) if kind == "starts" else None
    x = _x(cfg, B, L, seed=12)
    pos = np.broadcast_to(np.arange(L), (B, L)) + (
        0 if starts is None else starts[:, None])
    jc, tc = _caches(cfg, jcfg, "paged",
                     fill_seed=13 if kind == "starts" else None)
    tab = _tables()
    jctx, tctx = _ctxs()
    jo, jnew, _ = jattn.mla_paged_prefill(
        jnp.asarray(x), jp, jcfg, jctx, jnp.asarray(pos), jc,
        jnp.asarray(tab), jnp.asarray(lengths),
        starts=None if starts is None else jnp.asarray(starts))
    to, _ = tattn.mla_paged_prefill(
        torch.from_numpy(x), tp, cfg, tctx, torch.from_numpy(pos.copy()),
        tc, torch.from_numpy(tab), torch.from_numpy(lengths),
        starts=None if starts is None else torch.from_numpy(starts))
    for a, n in enumerate(lengths):
        _same(to[a, :n], jo[a, :n])
    _same(tc["latent"], jnew["latent"])


def test_serving_prefill_is_the_same_whole_as_suffix_and_chunks(mla):
    """The serving prefill (``spans``; the absorbed products at
    ``ABSORB_ROWS``-row blocks) gives a prompt's latent cells and its last
    output bit for bit whether it is prefilled whole, as the suffix behind
    its first 5 tokens, or in chunks of 4 — and within tolerance of the
    batched (non-``spans``) path."""
    jcfg, cfg, jp, tp = mla
    L = 11
    x = torch.from_numpy(_x(cfg, 1, L, seed=14))
    _, tctx = _ctxs()
    slots = torch.tensor([1])

    def run(cuts, spans=True):
        _, tc = _caches(cfg, jcfg, "dense")
        out = None
        for s, e in zip(cuts[:-1], cuts[1:]):
            n = e - s
            pos = torch.arange(s, e)[None]
            kw = dict(slots=slots, lengths=torch.tensor([n]))
            if s:
                kw["starts"] = torch.tensor([s])
            out, _ = tattn.mla_prefill(
                x[:, s:e], tp, cfg, tctx, pos, tc,
                spans=[(s, e)] if spans else None, **kw)
        return out[0, -1], tc["latent"][1, :L]

    o_whole, c_whole = run([0, L])
    for cuts in ([0, 5, L], [0, 4, 8, L]):
        o, c = run(cuts)
        assert torch.equal(o, o_whole) and torch.equal(c, c_whole), cuts
    o_plain, c_plain = run([0, L], spans=False)
    np.testing.assert_allclose(o_whole.numpy(), o_plain.numpy(), **TOL)
    assert torch.equal(c_whole, c_plain)


def test_verify_rows_equal_decode_bit_for_bit(mla):
    """Row t of a verify window is what the decode step computes at its
    position: the window's latents and outputs, bit for bit."""
    jcfg, cfg, jp, tp = mla
    T = 3
    x = torch.from_numpy(_x(cfg, B, T, seed=15))
    pos = torch.tensor([4, 9, 1], dtype=torch.int32)
    _, tctx = _ctxs()
    _, ver = _caches(cfg, jcfg, "dense", fill_seed=16)
    _, dec = _caches(cfg, jcfg, "dense", fill_seed=16)
    index = tattn.verify_write_index(pos, torch.full((B,), T), T, S)
    out_v, _ = tattn.mla_verify(x, tp, cfg, tctx, pos, ver, index)
    for t in range(T):
        out_d, _ = tattn.mla_decode(x[:, t:t + 1].contiguous(), tp, cfg,
                                    tctx, pos + t, dec)
        assert torch.equal(out_v[:, t:t + 1], out_d), t
    assert torch.equal(ver["latent"], dec["latent"])


@pytest.mark.parametrize("n", [3, 256, 300])
def test_absorbed_product_orders_agree(mla, n):
    """``_absorb`` batched, in row blocks (one block, exactly one, and a
    padded second) and a step at a time: the reference's f32 einsum
    within f32 rounding of sums in another order."""
    jcfg, cfg, jp, tp = mla
    a = np.random.default_rng(17).standard_normal(
        (1, n, 4, 16)).astype(np.float32)
    want = np.einsum("blhd,hdc->blhc", a, np.asarray(jp["w_uk"]))
    ta = torch.from_numpy(a)
    for order in (None, "rows", "steps"):
        got = tattn._absorb(ta, tp["w_uk"], torch.float32, order)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_pool_ops_serve_the_latent_pool(mla):
    """Scatter, gather and the COW copy index the leading two dims, so
    they serve the (NB, BS, kv_lora + rope) pool as they serve GQA's:
    cells land where the tables say, sentinel blocks read as zeros and
    drop writes, and ``copy_paged_blocks`` moves whole latent blocks."""
    jcfg, cfg, jp, tp = mla
    _, tc = _caches(cfg, jcfg, "paged")
    pool = tc["latent"]
    D = pool.shape[-1]
    tab = torch.from_numpy(_tables())
    tab[2, 1:] = NB                                   # sentinel blocks
    new = torch.arange(B * 12 * D, dtype=torch.float32).reshape(B, 12, D)
    tpc.paged_scatter_prefill(pool, new, tab, torch.tensor([12, 7, 12]))
    got = tpc.paged_gather(pool, tab)
    assert got.shape == (B, S, D)
    for b, n in enumerate((12, 7, 8)):
        assert torch.equal(got[b, :n], new[b, :n]), b
        assert got[b, n:].eq(0).all(), b
    tpc.paged_scatter_decode(pool, torch.full((B, D), -1.0), tab,
                             torch.tensor([12, 7, 25]))
    got = tpc.paged_gather(pool, tab)
    assert got[0, 12].eq(-1).all() and got[1, 7].eq(-1).all()
    assert got[2, 8:].eq(0).all()                    # dropped write
    blk, off = tpc.decode_cells(pool, tab, torch.tensor([12, 7, 25]))
    assert pool[blk, off].eq(-1).all() and blk.numel() == 2
    model = Model(cfg)
    src, dst = int(tab[0, 0]), int(tab[1, 3])
    model.copy_paged_blocks([tc], [src], [dst])
    assert torch.equal(pool[dst], pool[src])
