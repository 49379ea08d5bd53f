"""The MoE layer of the port against the reference, on the CPU: K1 batched
over experts (its plain version against ``jax.vmap`` of the reference's
Pallas kernel in interpret mode), the batched protected GEMM, routing and
``moe_forward``.

Inputs come from numpy with a seed and go to both packages.  Tolerances,
each with its reason:

- f32: y, bounds and thresholds within 1e-5 relative (the same f32 sums
  in another order); a clean residual is rounding noise, so it is held
  only under its threshold on both sides, while a faulted one (≈1e5)
  agrees within 1e-4 relative;
- bf16 operands: y within 2^-7 of max|y| (one bf16 rounding of either
  side);
- ``moe_forward`` in f32: y within 1e-5 absolute and relative, the aux
  loss within 1e-6 relative; routing compared exactly, and where a
  token's K-th and (K+1)-th router probabilities lie within 1e-5 of each
  other (the f32 logit tolerance) a differing choice must be that tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.faults import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.kernels import ops as jops
from repro.models import LayerCtx as JCtx, ModelFault as JMF
from repro.models import moe as jmoe
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import (
    ABFTConfig,
    protected_matmul,
    protected_matmul_batched,
)
from repro_torch.core.schemes import Scheme
from repro_torch.kernels import ops
from repro_torch.kernels.ref import abft_matmul_batched_ref, abft_matmul_ref
from repro_torch.models import moe
from repro_torch.models.layers import LayerCtx, ModelFault, batched_dense

torch.set_num_threads(1)

# (E, C, K, N): ragged rows and columns, the scaled-down expert GEMMs
# (K = 64 up, 32 down: one short k-block), two-row capacity
SHAPES = [(4, 5, 40, 24), (3, 8, 64, 32), (2, 2, 32, 64)]


def _operands(E, C, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    w = (0.1 * rng.standard_normal((E, K, N))).astype(np.float32)
    return x, w


def _ref_vmap(x, w, mode, fault=None, dtype=jnp.float32):
    """The reference's per-expert kernel call under ``jax.vmap`` (Pallas
    in interpret mode), the fault closed over as in ``moe.py``."""
    return jax.vmap(lambda a, b: jops.abft_matmul(
        a, b, mode=mode, fault=fault))(jnp.asarray(x, dtype),
                                       jnp.asarray(w, dtype))


@pytest.mark.parametrize("mode", ["1s", "2s", "replica"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batched_k1_plain_matches_the_vmapped_reference(shape, mode):
    x, w = _operands(*shape, seed=sum(shape))
    jy, jchk = _ref_vmap(x, w, mode)
    y, chk = ops.abft_matmul_batched(torch.from_numpy(x),
                                     torch.from_numpy(w), mode=mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert chk.residual.shape == jchk.residual.shape
    np.testing.assert_allclose(chk.threshold.numpy(),
                               np.asarray(jchk.threshold), rtol=1e-5,
                               atol=1e-30)
    assert bool((chk.residual <= chk.threshold).all())
    assert bool(np.all(np.asarray(jchk.residual)
                       <= np.asarray(jchk.threshold)))
    assert not bool(chk.flag) and not bool(np.any(np.asarray(jchk.flag)))


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "x".join(map(str, s)))
def test_batched_k1_fault_lands_in_every_expert(shape, mode):
    """The fault is no vmapped argument in the reference: an enabled fault
    at (row, col) corrupts every expert's output there, and every expert
    flags it at its block and row."""
    E, C, K, N = shape
    x, w = _operands(*shape, seed=7)
    row, col = C - 1, N - 3
    jy, jchk = _ref_vmap(x, w, mode, JFault.value(row, col, 1e5))
    y, chk = ops.abft_matmul_batched(torch.from_numpy(x),
                                     torch.from_numpy(w), mode=mode,
                                     fault=FaultSpec.value(row, col, 1e5))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    clean = np.einsum("eck,ekn->ecn", x, w)
    assert np.all(y.numpy()[:, row, col] - clean[:, row, col] > 9e4)
    res, jres = chk.residual.numpy(), np.asarray(jchk.residual)
    hot = res > chk.threshold.numpy()
    assert np.array_equal(hot, jres > np.asarray(jchk.threshold))
    assert hot.reshape(E, -1).sum(1).tolist() == [1] * E
    np.testing.assert_allclose(res[hot], jres[hot], rtol=1e-4)
    assert np.asarray(jchk.flag).all() and bool(chk.flag)


def test_batched_k1_bf16_matches_the_vmapped_reference():
    x, w = _operands(3, 8, 64, 32, seed=3)
    jy, jchk = _ref_vmap(x, w, "1s", dtype=jnp.bfloat16)
    y, chk = ops.abft_matmul_batched(torch.from_numpy(x).bfloat16(),
                                     torch.from_numpy(w).bfloat16())
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    np.testing.assert_allclose(chk.threshold.numpy(),
                               np.asarray(jchk.threshold), rtol=1e-5)
    assert not bool(chk.flag)


def test_batched_plain_version_is_the_2d_one_per_expert():
    """Expert e of the batched plain version is the 2-D plain version of
    (x[e], w[e]), the fault included (f32 sums batched in another order:
    1e-6 relative; clean residuals are noise of ≈1e-6)."""
    x, w = (torch.from_numpy(a) for a in _operands(3, 13, 40, 24, seed=9))
    kw = dict(mode="1s", bm=16, bk=40, bn=24, out_dtype=torch.float32)
    fault = (0, 0, 12, 5, 1, -1)
    y, res, bnd = abft_matmul_batched_ref(x, w, fault, 3.0, **kw)
    for e in range(3):
        ye, re, be = abft_matmul_ref(x[e], w[e], fault, 3.0, **kw)
        torch.testing.assert_close(y[e], ye, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(bnd[e], be, rtol=1e-6, atol=0)
        torch.testing.assert_close(res[e], re, rtol=1e-6, atol=1e-5)
        assert float(res[e, 0, 0, 12]) > 2.9


def test_batched_k1_backward_is_the_plain_batched_product():
    x, w = (torch.from_numpy(a) for a in _operands(3, 5, 40, 24, seed=4))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 5, 24)).astype(np.float32))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    (ops.abft_matmul_batched(xa, wa)[0] * g).sum().backward()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (torch.bmm(xb, wb) * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-6, atol=1e-6)


def test_batched_k1_rejects_mismatched_shapes():
    x = torch.zeros(3, 4, 8)
    for w in (torch.zeros(2, 8, 4), torch.zeros(3, 6, 4), torch.zeros(8, 4)):
        with pytest.raises(ValueError):
            ops.abft_matmul_batched(x, w)


# ------------------------------------------------------------ protected

class _Recording(IntensityGuidedPolicy):
    """The default policy, recording the dims it is asked about."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "seen", [])

    def select(self, dims, hw=None, **kw):
        self.seen.append(dims)
        return super().select(dims, hw, **kw) if hw is not None \
            else super().select(dims, **kw)


def test_scheme_is_resolved_from_one_experts_gemm():
    pol = _Recording()
    x, w = (torch.from_numpy(a) for a in _operands(6, 4, 40, 24, seed=1))
    protected_matmul_batched(x, w, ABFTConfig(policy=pol))
    assert [(d.m, d.k, d.n) for d in pol.seen] == [(4, 40, 24)]


@pytest.mark.parametrize("scheme", [Scheme.NONE, Scheme.GLOBAL,
                                    Scheme.BLOCK_1S, Scheme.BLOCK_2S])
@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "fault"])
def test_batched_scheme_equals_the_2d_scheme_per_expert(scheme, faulty):
    """Every built-in scheme batched over experts gives each expert the
    2-D scheme's y, and the flag is any expert's: the fault (in every
    expert) raises it under every scheme but ``none``."""
    x, w = (torch.from_numpy(a) for a in _operands(3, 5, 40, 24, seed=2))
    cfg = ABFTConfig(policy=FixedPolicy(scheme))
    fault = FaultSpec.value(4, 7, 1e4) if faulty else None
    y, flag = protected_matmul_batched(x, w, cfg, fault=fault)
    flags = []
    for e in range(3):
        ye, chk = protected_matmul(x[e], w[e], cfg, fault=fault)
        torch.testing.assert_close(y[e], ye, rtol=1e-6, atol=1e-6)
        flags.append(bool(chk.flag))
    assert bool(flag) == any(flags) == (faulty and scheme != Scheme.NONE)


def test_a_plug_in_scheme_has_no_batched_executor():
    x, w = torch.zeros(2, 3, 8), torch.zeros(2, 8, 4)

    class Named(IntensityGuidedPolicy):
        def select(self, dims, hw=None, **kw):
            return dataclasses.replace(super().select(dims, **kw),
                                       scheme="fused_page")

    with pytest.raises(NotImplementedError, match="batched"):
        protected_matmul_batched(x, w, ABFTConfig(policy=Named()))


# ------------------------------------------------------------ routing

def test_capacity_matches_reference():
    for arch in ("qwen2-moe-a2.7b", "deepseek-v3-671b", "jamba-v0.1-52b"):
        for cf in (0.5, 1.0, 1.25, 2.0):
            jc = dataclasses.replace(jget(arch), capacity_factor=cf)
            tc = dataclasses.replace(get_config(arch), capacity_factor=cf)
            for t in (1, 2, 3, 4, 7, 8, 16, 48, 100, 1024, 4096):
                assert moe.capacity(tc, t) == jmoe.capacity(jc, t)


def test_top_k_takes_the_lower_index_on_ties():
    rng = np.random.default_rng(0)
    p = rng.integers(0, 4, size=(64, 12)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(p), 5)
    tv, ti = moe.top_k(torch.from_numpy(p), 5)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def _moe_setup(seed=0, **over):
    jcfg = jscaled(jget("qwen2-moe-a2.7b"), **over)
    tcfg = scaled_down(get_config("qwen2-moe-a2.7b"), **over)
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    np_p = jax.tree_util.tree_map(np.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, np_p)
    return jcfg, tcfg, p, tp


def test_routing_matches_reference_exactly():
    jcfg, tcfg, p, tp = _moe_setup()
    K = tcfg.experts_per_token
    x = np.random.default_rng(3).standard_normal((64, 64)).astype(
        np.float32)
    jlog = np.asarray(jnp.asarray(x) @ p["router"])
    tlog = (torch.from_numpy(x) @ tp["router"]).numpy()
    np.testing.assert_allclose(tlog, jlog, rtol=1e-5, atol=1e-5)
    jprob = jax.nn.softmax(jnp.asarray(jlog), axis=-1)
    _, ji = jax.lax.top_k(jprob, K)
    _, ti = moe.top_k(torch.softmax(torch.from_numpy(tlog), dim=-1), K)
    ji = np.asarray(ji)
    srt = -np.sort(-np.asarray(jprob), axis=-1)
    for t in np.nonzero((ji != ti.numpy()).any(1))[0]:
        assert srt[t, K - 1] - srt[t, K] < 1e-5, t


def _ctxs(fault=None, use_pallas=False):
    jf = tf = None
    if fault is not None:
        site, row, col = fault
        jf = JMF.at(0, site, JFault.value(row, col, 1e4))
        tf = ModelFault.at(0, site, FaultSpec.value(row, col, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=use_pallas,
                                       hardware=JTPU), fault=jf,
                layer_idx=jnp.asarray(0, jnp.int32))
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E),
                    fault=tf, layer_idx=0)
    return jctx, tctx


# name: (config overrides, batch, length)
CASES = {
    "shared": (dict(), 2, 12),
    "no_shared": (dict(n_shared_experts=0), 2, 12),
    "drops": (dict(capacity_factor=0.5), 4, 24),
    "top1_16_experts": (dict(n_experts=16, experts_per_token=1), 2, 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_reference(case):
    over, B, L = CASES[case]
    jcfg, tcfg, p, tp = _moe_setup(seed=len(case), **over)
    x = np.random.default_rng(5).standard_normal((B, L, 64)).astype(
        np.float32)
    jctx, tctx = _ctxs()
    # the reference jitted (its op-by-op run takes several times longer)
    jy, jf, ja = jax.jit(lambda a, q: jmoe.moe_forward(a, q, jcfg, jctx))(
        jnp.asarray(x), p)
    with torch.no_grad():
        ty, tf, ta = moe.moe_forward(torch.from_numpy(x), tp, tcfg, tctx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert bool(tf) == bool(jf) is False
    if case == "drops":     # the case drops tokens: capacity < demand
        C = moe.capacity(tcfg, B * L)
        assert C * tcfg.n_experts < B * L * tcfg.experts_per_token


@pytest.mark.parametrize("site", ["router", "expert_up", "expert_down"])
def test_moe_forward_faults_match_reference(site):
    """A fault at each MoE site corrupts the same output as the
    reference's Pallas kernel (interpret mode) and raises the flag."""
    jcfg, tcfg, p, tp = _moe_setup(seed=2)
    x = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(
        np.float32)
    jctx, tctx = _ctxs((site, 1, 3), use_pallas=True)
    jy, jf, ja = jmoe.moe_forward(jnp.asarray(x), p, jcfg, jctx)
    with torch.no_grad():
        ty, tf, ta = moe.moe_forward(torch.from_numpy(x), tp, tcfg, tctx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert bool(tf) and bool(jf)


@pytest.mark.parametrize("site", ["expert_up", "expert_down"])
def test_expert_fault_is_flagged_in_every_expert(site):
    """``batched_dense`` at a faulted expert site: every expert's output
    carries the fault, and every expert's check sees it."""
    _, tcfg, _, tp = _moe_setup()
    w = tp["w_up"] if site == "expert_up" else tp["w_down"]
    E, K, N = w.shape
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (E, 6, K)).astype(np.float32))
    _, tctx = _ctxs((site, 2, 5))
    y, flag = batched_dense(x, w, tctx, site)
    clean = torch.bmm(x, w)
    assert bool(flag)
    assert bool(((y - clean)[:, 2, 5] > 9e3).all())
    _, chk = ops.abft_matmul_batched(x, w, fault=FaultSpec.value(2, 5, 1e4))
    hot = (chk.residual > chk.threshold).reshape(E, -1)
    assert hot.sum(1).tolist() == [1] * E
    _, other = batched_dense(x, w, tctx, "router")
    assert not bool(other)
