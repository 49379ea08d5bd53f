"""The port's memory-path building blocks against the reference, on the CPU
in f32: cross-attention (``cross_kv``, ``cross_forward``), the GELU MLP
with its biases, ``sinusoid_pos`` and whisper's conv stem at an even and
an odd frame count.  Inputs are seeded numpy arrays fed to both.

Tolerances (f32, sums in another order): 1e-5 of each output's scale.
Two checks show the tolerance sees the faults it must: the exact (erf)
GELU is off the reference's tanh GELU by at least 10x the tolerance, and
so is a stem padded (1, 1) at stride 2 on an even frame count where XLA's
SAME pads (0, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, build_model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.protected import ABFTConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)

REL = 1e-5
JCTX = JCtx(abft=JABFT(use_pallas=False))
TCTX = LayerCtx(abft=ABFTConfig())


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    tol = rel * max(np.abs(want).max(), 1e-30)
    assert err <= tol, (err, tol)
    return tol


def _cfg(arch, **over):
    return jscaled(jget(arch), **over), scaled_down(get_config(arch), **over)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
@pytest.mark.parametrize("L", [1, 7])
def test_cross_kv_and_forward_match_reference(arch, L):
    """Memory (2, 9, d) projected to K/V, then L queries a row against
    all 9 memory positions (GQA at KV = 2 for vision, MHA for whisper);
    L = 1 is the decode step's shape."""
    jcfg, tcfg = _cfg(arch)
    rng = np.random.default_rng(0)
    p = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in (
        ("wq", (64, tcfg.n_heads * 16)), ("wk", (64, tcfg.n_kv_heads * 16)),
        ("wv", (64, tcfg.n_kv_heads * 16)),
        ("wo", (tcfg.n_heads * 16, 64)))}
    mem = rng.standard_normal((2, 9, 64)).astype(np.float32)
    x = rng.standard_normal((2, L, 64)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jk, jv, jf = jattn.cross_kv(jnp.asarray(mem), jp, jcfg, JCTX)
    tk, tv, tf = tattn.cross_kv(torch.from_numpy(mem), tp, tcfg, TCTX)
    _close(tk, jk)
    _close(tv, jv)
    assert tk.shape == (2, 9, tcfg.n_kv_heads, 16)
    jo, jf2 = jattn.cross_forward(jnp.asarray(x), jk, jv, jp, jcfg, JCTX)
    to, tf2 = tattn.cross_forward(torch.from_numpy(x), tk, tv, tp, tcfg,
                                  TCTX)
    _close(to, jo)
    assert not any(bool(f) for f in (jf, tf, jf2, tf2))


def test_init_cross_and_its_cache_have_the_references_shapes():
    jcfg, tcfg = _cfg("llama-3.2-vision-11b")
    jp = jattn.init_cross(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = tattn.init_cross(tcfg, lambda *s: torch.zeros(s))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    jc = jmodel.init_cross_cache(jcfg, 3, 8, jnp.bfloat16)
    tc = tattn.init_cross_cache(tcfg, 3, 8, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["k"].dtype == torch.bfloat16


def _gelu_case():
    """x (2, 5, 64) and a GELU FFN with biases whose pre-activations
    spread over [-6, 6], where the two GELU forms part most."""
    rng = np.random.default_rng(1)
    p = {"up": 0.25 * rng.standard_normal((64, 128)),
         "down": 0.1 * rng.standard_normal((128, 64)),
         "up_b": 0.5 * rng.standard_normal(128),
         "down_b": 0.1 * rng.standard_normal(64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    return x, p


def test_gelu_mlp_matches_reference_and_is_the_tanh_form(monkeypatch):
    """``mlp(act="gelu")``: up + up_b, tanh GELU in f32, down + down_b.
    An exact GELU in its place is off by more than 10x the tolerance."""
    x, p = _gelu_case()
    jo, jf = jlayers.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()},
                         JCTX, act="gelu")
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    to, tf = tlayers.mlp(torch.from_numpy(x), tp, TCTX, act="gelu")
    tol = _close(to, jo)
    assert not bool(jf) and not bool(tf)
    monkeypatch.setattr(tlayers, "gelu", torch.nn.functional.gelu)
    exact, _ = tlayers.mlp(torch.from_numpy(x), tp, TCTX, act="gelu")
    assert np.abs(exact.numpy() - np.asarray(jo)).max() > 10 * tol


@pytest.mark.parametrize("d_model", [64, 384, 2])
def test_sinusoid_pos_matches_reference(d_model):
    """Positions up to 1499 (whisper's 1500 frames), d_model 64 and 384
    and the degenerate 2 (one frequency: ``max(half - 1, 1)``).  The
    two libraries' f32 ``exp`` may part by an ulp in a frequency; at
    angles of 1024-1499 rad one ulp of the angle is 2^-13, so the
    tolerance is two of them (2^-12 absolute), and two ulps of a 64 rad
    angle (2^-17) where the angles stay under 64 rad (the first 64
    positions)."""
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    want = np.asarray(jmodel.sinusoid_pos(jnp.asarray(pos), d_model))
    got = tmodel.sinusoid_pos(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (2, 1500, d_model)
    np.testing.assert_allclose(got.numpy(), want, atol=2 ** -12, rtol=0)
    np.testing.assert_allclose(got[0, :64].numpy(), want[0, :64],
                               atol=2 ** -17, rtol=0)


def _stem_pair():
    jm = build_model(jscaled(jget("whisper-tiny")))
    jp = jm.init_params(jax.random.PRNGKey(2), dtype=jnp.float32)
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(3)
    cs = np_p["conv_stem"]
    for b in ("b1", "b2"):
        cs[b] = (0.1 * rng.standard_normal(cs[b].shape)).astype(np.float32)
    for w in ("w1", "w2"):
        cs[w] = (0.3 * rng.standard_normal(cs[w].shape)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, np_p)
    cfg = scaled_down(get_config("whisper-tiny"))
    return jm, jp, Model(cfg), params_from_reference(cfg, np_p)


@pytest.mark.parametrize("T", [32, 31])
def test_conv_stem_matches_reference_at_even_and_odd_T(T):
    """(2, T, 8) log-mel frames through both stems: (2, ceil(T / 2), 64).
    XLA's SAME pads the stride-2 conv (0, 1) on an even T and (1, 1) on
    an odd one; on the even T, (1, 1) is off by more than 10x the
    tolerance."""
    jm, jp, tm, tp = _stem_pair()
    audio = np.random.default_rng(T).standard_normal((2, T, 8)).astype(
        np.float32)
    want = np.asarray(jm._conv_stem(jp, jnp.asarray(audio)))
    got = tm._conv_stem(tp, torch.from_numpy(audio))
    assert got.shape == (2, -(-T // 2), 64)
    tol = _close(got, want)
    if T % 2 == 0:
        cs = tp["conv_stem"]
        h = torch.from_numpy(audio).transpose(1, 2)
        h = tlayers.gelu(tmodel._conv_same(h, cs["w1"], 1)
                         + cs["b1"][:, None])
        sym = torch.nn.functional.conv1d(
            torch.nn.functional.pad(h, (1, 1)), cs["w2"].permute(2, 1, 0),
            stride=2)
        sym = tlayers.gelu(sym + cs["b2"][:, None]).transpose(1, 2)
        assert sym.shape == got.shape
        assert np.abs(sym.numpy() - want).max() > 10 * tol
