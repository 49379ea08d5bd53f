"""The port's Mamba2 mixer (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba``, on the CPU in f32 at ``scaled_down``
mamba2-1.3b (d_model 64, d_inner 128, 8 heads of 16, state 16, chunk 8,
conv width 4): the causal conv, the chunked SSD scan (L a multiple of the
chunk and not), the full forward, the whole and the ragged prefill
(prompts shorter than the conv window included), the conv step and the
decode step, and prefill then decode against the forward.

Inputs come from numpy with a seed; the mixer's params are the
reference's ``init_mamba`` draw, carried across.  The reference's GEMMs
run through the XLA emulation of its block schemes (``use_pallas=False``),
the port's through the K1 plain versions.  Tolerance: 1e-5 absolute and
relative on every output and state (f32 both sides; the scan's
contractions sum in another order, and the port fixes its own).  Flags are
equal.
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
from repro.models import mamba as jmb
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models import mamba as tmb
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import _to_torch

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def mixer():
    jcfg = jscaled(jget(ARCH))
    cfg = scaled_down(get_config(ARCH))
    jp = jmb.init_mamba(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = {k: _to_torch(np.asarray(v), "cpu", None) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _ctxs(fault=None):
    jf = tf = None
    if fault is not None:
        jf = JMF.at(0, fault, JFault.value(0, 1, 1e4))
        tf = ModelFault.at(0, fault, FaultSpec.value(0, 1, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU), fault=jf)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E), fault=tf)
    return jctx, tctx


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_params_follow_the_references_layout(mixer):
    jcfg, cfg, jp, tp = mixer
    leaves = {}
    own = tmb.init_mamba(
        cfg, lambda *s, scale=0.02: torch.zeros(s),
        lambda n, fill, dtype=torch.float32: torch.full((n,), fill,
                                                        dtype=dtype))
    for k, v in jp.items():
        leaves[k] = tuple(v.shape)
        assert tuple(own[k].shape) == leaves[k], k
    assert set(own) == set(jp)
    assert own["A_log"].dtype == own["dt_bias"].dtype == torch.float32
    assert tmb.conv_dim(cfg) == jmb.conv_dim(jcfg) == 128 + 32


@pytest.mark.parametrize("L", [1, 3, 12])
def test_causal_conv(mixer, L):
    jcfg, cfg, jp, tp = mixer
    u = _x((2, L, cfg.d_inner), seed=L)
    got = tmb._causal_conv(torch.from_numpy(u), tp["conv_x_w"],
                           tp["conv_x_b"])
    _close(got, jmb._causal_conv(jnp.asarray(u), jp["conv_x_w"],
                                 jp["conv_x_b"]))


@pytest.mark.parametrize("L", [8, 13, 24, 5], ids=lambda n: f"L{n}")
def test_ssd_chunked_scan(mixer, L):
    """L = 8, 24: whole chunks; 13: a padded last chunk; 5: one chunk
    shorter than the configured 8."""
    jcfg, cfg, _, _ = mixer
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = _x((2, L, H, P), 1)
    dt = np.abs(_x((2, L, H), 2, 0.1)).astype(np.float32)
    A = -np.exp(_x((H,), 3, 0.5))
    Bm, Cm = _x((2, L, N), 4), _x((2, L, N), 5)
    y, S = tmb._ssd_chunked(*(torch.from_numpy(a) for a in
                              (xh, dt, A, Bm, Cm)), cfg.ssm_chunk)
    jy, jS = jmb._ssd_chunked(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)),
                              jcfg.ssm_chunk)
    assert y.shape == (2, L, H, P) and S.shape == (2, H, P, N)
    _close(y, jy)
    _close(S, jS)


@pytest.mark.parametrize("fault", [None, "ssm_in", "ssm_out"])
def test_mamba_forward(mixer, fault):
    """A faulted call runs one row: the reference's XLA emulation of a
    block scheme corrupts (row, col) in every leading batch index, K1 (the
    port's, and the reference's Pallas kernel) the flattened row alone."""
    jcfg, cfg, jp, tp = mixer
    x = _x((1 if fault else 2, 13, cfg.d_model), 6)
    jctx, tctx = _ctxs(fault)
    # the reference jitted (its op-by-op run takes several times longer)
    jo, jf = jax.jit(lambda a, p: jmb.mamba_forward(a, p, jcfg, jctx))(
        jnp.asarray(x), jp)
    with torch.no_grad():
        to, tf = tmb.mamba_forward(torch.from_numpy(x), tp, cfg, tctx)
    _close(to, jo)
    assert bool(tf) == bool(jf) == (fault is not None)


def _cache(cfg, batch):
    return tmb.init_mamba_cache(cfg, batch, torch.float32, "cpu")


def test_whole_prefill_writes_the_final_state(mixer):
    jcfg, cfg, jp, tp = mixer
    x = _x((2, 11, cfg.d_model), 7)
    jctx, tctx = _ctxs()
    jo, jc, _ = jax.jit(
        lambda a, p, c: jmb.mamba_prefill(a, p, jcfg, jctx, c))(
        jnp.asarray(x), jp, jmb.init_mamba_cache(jcfg, 2, jnp.float32))
    cache = _cache(cfg, 2)
    with torch.no_grad():
        to, _ = tmb.mamba_prefill(torch.from_numpy(x), tp, cfg, tctx, cache)
    _close(to, jo)
    for k in ("conv_x", "conv_bc", "ssm"):
        _close(cache[k], jc[k])


@pytest.mark.parametrize("lengths", [(9, 16, 2), (1, 3, 16)],
                         ids=["ragged", "shorter_than_window"])
def test_ragged_prefill_scatters_into_its_slots(mixer, lengths):
    """Rows padded to 16 with ragged lengths land in slots (3, 0, 2) of a
    4-slot cache; slot 1 stays zero.  Lengths 1 and 3 are shorter than the
    conv window (W - 1 = 3 inputs): the window keeps the zero padding."""
    jcfg, cfg, jp, tp = mixer
    x = _x((3, 16, cfg.d_model), 8)
    slots, lens = np.array([3, 0, 2], np.int32), np.array(lengths, np.int32)
    jctx, tctx = _ctxs()
    jo, jc, _ = jax.jit(
        lambda a, p, c, s, n: jmb.mamba_prefill(a, p, jcfg, jctx, c,
                                                slots=s, lengths=n))(
        jnp.asarray(x), jp, jmb.init_mamba_cache(jcfg, 4, jnp.float32),
        jnp.asarray(slots), jnp.asarray(lens))
    cache = _cache(cfg, 4)
    with torch.no_grad():
        to, _ = tmb.mamba_prefill(torch.from_numpy(x), tp, cfg, tctx, cache,
                                  slots=torch.from_numpy(slots),
                                  lengths=torch.from_numpy(lens))
    keep = np.arange(16)[None, :] < lens[:, None]
    np.testing.assert_allclose(to.numpy()[keep], np.asarray(jo)[keep], **TOL)
    for k in ("conv_x", "conv_bc", "ssm"):
        _close(cache[k], jc[k])
        assert not cache[k][1].any()


def test_conv_step(mixer):
    jcfg, cfg, jp, tp = mixer
    state = _x((3, cfg.ssm_conv_width - 1, cfg.d_inner), 9)
    new = _x((3, cfg.d_inner), 10)
    out, win = tmb._conv_step(torch.from_numpy(state), torch.from_numpy(new),
                              tp["conv_x_w"], tp["conv_x_b"])
    jout, jwin = jmb._conv_step(jnp.asarray(state), jnp.asarray(new),
                                jp["conv_x_w"], jp["conv_x_b"])
    _close(out, jout)
    _close(win, jwin)


@pytest.mark.parametrize("fault", [None, "ssm_out"])
def test_decode_returns_the_next_state_and_leaves_the_cache(mixer, fault):
    """One row when faulted (``test_mamba_forward`` says why)."""
    jcfg, cfg, jp, tp = mixer
    rng = np.random.default_rng(11)
    B = 1 if fault else 3
    cache = {k: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32))
        for k, v in _cache(cfg, B).items()}
    before = {k: v.clone() for k, v in cache.items()}
    x = _x((B, 1, cfg.d_model), 12)
    jctx, tctx = _ctxs(fault)
    jo, jc, jf = jax.jit(
        lambda a, p, c: jmb.mamba_decode(a, p, jcfg, jctx, c))(
        jnp.asarray(x), jp,
        {k: jnp.asarray(v.numpy()) for k, v in cache.items()})
    with torch.no_grad():
        to, tf, state = tmb.mamba_decode(torch.from_numpy(x), tp, cfg, tctx,
                                         cache)
    _close(to, jo)
    assert bool(tf) == bool(jf) == (fault is not None)
    for k in ("conv_x", "conv_bc", "ssm"):
        _close(state[k], jc[k])
        assert state[k].dtype == cache[k].dtype
        assert torch.equal(cache[k], before[k]), f"decode wrote {k}"


def test_prefill_then_decode_equals_forward(mixer):
    """Prefill 13 tokens (a padded last chunk), then decode 5 one at a
    time: each output row equals the full forward's at its position, in
    the port alone and in the reference alike (1e-5: the scan and the
    recurrence sum in different orders)."""
    jcfg, cfg, jp, tp = mixer
    x = _x((2, 18, cfg.d_model), 13)
    _, tctx = _ctxs()
    with torch.no_grad():
        full, _ = tmb.mamba_forward(torch.from_numpy(x), tp, cfg, tctx)
        cache = _cache(cfg, 2)
        pre, _ = tmb.mamba_prefill(torch.from_numpy(x[:, :13]), tp, cfg,
                                   tctx, cache)
        outs = [pre]
        for t in range(13, 18):
            o, _, cache = tmb.mamba_decode(torch.from_numpy(x[:, t:t + 1]),
                                           tp, cfg, tctx, cache)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)
