"""Speculative decoding in the port (``serve/spec_decode.py``, the verify
path of the model and the engine's verify core) against the reference's,
on scaled-down llama3.2-1b (2 layers, f32, the reference's parameters
through numpy).  The reference runs as its own tests run it on the CPU
(``use_pallas=False``).

Exact: proposals, acceptance, ``tune_draft_len`` (host logic), and every
greedy stream and spec counter (greedy tokens and ABFT flags agree
exactly on short streams, as in the other engine tests).  Within f32
tolerance: attention outputs and verify logits against the reference
(1e-5 and 1e-4 absolute: sums in another order through 2 layers, the
same bounds as ``test_torch_model.py``).  Bitwise: the port's verify row
t against its own decode step at that position (the byte-equality
contract; on the CPU the plain K1 and the stepwise norms and attention
give it).  Sampling is held in law only: the port draws from a
``torch.Generator``, the reference from JAX keys; the chi-squared bound
is the 0.999 quantile, so a correct sampler fails one seed in a
thousand, and the seeds are fixed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_shared_runners import shared_runners
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.faults import FaultModel as JFaultModel
from repro.core.hardware import HardwareSpec as JHW, TPU_V5E as JTPU
from repro.core.policy import (
    ErrorAdaptivePolicy as JAdaptive,
    IntensityGuidedPolicy as JGuided,
    ProtectionPlan as JPlan,
)
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro.models.layers import verify_attention as jverify_attention
from repro.obs import EngineTelemetry as JTelemetry
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro.serve.spec_decode import (
    NGramProposer as JNGram,
    greedy_accept as jgreedy_accept,
    target_probs as jtarget_probs,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultModel, FaultSpec
from repro_torch.core.hardware import NVIDIA_H100_SXM, TPU_V5E, HardwareSpec
from repro_torch.core.policy import (
    ErrorAdaptivePolicy,
    IntensityGuidedPolicy,
    ProtectionPlan,
)
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import (
    LayerCtx,
    ModelFault,
    decode_attention,
    verify_attention,
)
from repro_torch.models.model import Model, params_from_reference
from repro_torch.obs import EngineTelemetry
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.serve.spec_decode import (
    NGramProposer,
    SelfDraftProposer,
    greedy_accept,
    make_proposer,
    rejection_sample,
    target_probs,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``)."""
    with shared_runners():
        yield


# the reference test's crafted roofline: the scaled model's (64, 128) f32
# step projection picks block_1s below 18 tokens a step and global from
# 18, so a 4-slot decode (4 tokens) and a K=4 verify (20) differ
_FLIP = dict(name="flip", peak_flops=1e10, vpu_flops=2.6e8, hbm_bw=1e9,
             ici_bw=1e9, hbm_bytes=1 << 30, vmem_bytes=1 << 20,
             fixed_op_overhead_s=1e-6)
FLIP_HW, JFLIP_HW = HardwareSpec(**_FLIP), JHW(**_FLIP)
COUNTERS = ("steps", "tokens", "faults_detected", "retries", "hard_faults",
            "evictions", "draft_proposed", "draft_accepted",
            "verify_retries", "scheme_flips", "cow_copies",
            "prefill_chunks", "faults_injected", "faults_corrected",
            "faults_uncorrected", "sdc_faults", "masked_faults")
LOG_KEYS = ("source", "kind", "engine_step", "phase", "outcome",
            "tokens_match", "onset_step", "layer", "site", "row", "col",
            "armed_step", "run_step")


@pytest.fixture(scope="module")
def models():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


# ------------------------------------------------------------- proposers

def _histories():
    rng = np.random.default_rng(5)
    periodic = [np.tile(3 + np.arange(p, dtype=np.int32), 12)[:n]
                for p, n in ((4, 21), (5, 23), (3, 9), (7, 30))]
    rand = [rng.integers(1, 12, size=int(n)).astype(np.int32)
            for n in (2, 5, 17, 40)]
    rand.append(rng.integers(1, 256, size=33).astype(np.int32))
    return periodic + rand


@pytest.mark.parametrize("k", [0, 1, 3, 8])
def test_ngram_proposals_equal_reference(k):
    """Periodic and random histories (some generated tokens appended): the
    port proposes exactly the reference's tokens."""
    for i, h in enumerate(_histories()):
        for cut in (len(h), max(1, len(h) - 4)):
            tr = Request(uid=i, prompt=h[:cut], max_new_tokens=20)
            tr.generated = [int(t) for t in h[cut:]]
            jr = JRequest(uid=i, prompt=h[:cut], max_new_tokens=20)
            jr.generated = list(tr.generated)
            for kw in ({}, {"max_n": 2}, {"max_n": 4, "min_n": 2}):
                got = NGramProposer(**kw).propose(tr, k)
                want = JNGram(**kw).propose(jr, k)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_accept_and_target_probs_equal_reference():
    rng = np.random.default_rng(2)
    for _ in range(50):
        T = int(rng.integers(1, 6))
        targets = rng.integers(0, 4, size=T).astype(np.int32)
        drafts = rng.integers(0, 4, size=T - 1).astype(np.int32)
        assert greedy_accept(drafts, targets) == \
            jgreedy_accept(drafts, targets)
    logits = rng.normal(size=(3, 17)).astype(np.float32) * 3
    for temp, top_k in ((1.0, 0), (0.7, 5), (1.3, 40), (0.0, 3)):
        np.testing.assert_array_equal(
            target_probs(logits, temp, top_k),
            np.asarray(jtarget_probs(logits, temp, top_k)))


def _chi2(counts, p):
    """Pearson's statistic over the categories of non-zero probability,
    and its 0.999 quantile (Wilson-Hilferty) at their count - 1 degrees of
    freedom.  A category of zero probability must never be drawn."""
    n = counts.sum()
    live = p > 0
    assert counts[~live].sum() == 0
    e = n * p[live]
    stat = float(((counts[live] - e) ** 2 / e).sum())
    df = int(live.sum()) - 1
    z = 3.090232                       # the 0.999 normal quantile
    crit = df * (1 - 2 / (9 * df) + z * np.sqrt(2 / (9 * df))) ** 3
    return stat, crit


@pytest.mark.parametrize("draft", [0, 2, 4])
def test_rejection_sample_is_exact_in_law(draft):
    """The first emitted token follows the target row whether the draft
    is likely, unlikely or impossible under it; after an accepted draft
    the bonus token follows the last row."""
    probs = np.array([[0.4, 0.25, 0.2, 0.15, 0.0],
                      [0.1, 0.2, 0.3, 0.25, 0.15]], np.float64)
    gen = torch.Generator().manual_seed(100 + draft)
    first, bonus = np.zeros(5), np.zeros(5)
    for _ in range(4000):
        out = rejection_sample(np.array([draft], np.int32), probs, gen)
        first[out[0]] += 1
        if out[0] == draft:
            assert len(out) == 2
            bonus[out[1]] += 1
        else:
            assert len(out) == 1
    stat, crit = _chi2(first, probs[0])
    assert stat < crit, (stat, crit)
    if probs[0, draft] > 0:
        stat, crit = _chi2(bonus, probs[1])
        assert stat < crit, (stat, crit)


def test_rejection_sample_bonus_and_point_mass():
    """A point mass at the draft always accepts and draws the bonus from
    the last row; a point mass elsewhere always emits its own token."""
    gen = torch.Generator().manual_seed(0)
    probs = np.array([[1.0, 0.0], [0.0, 1.0]], np.float64)
    for _ in range(20):
        assert rejection_sample(np.array([0], np.int32), probs, gen) == \
            [0, 1]
        assert rejection_sample(np.array([1], np.int32), probs, gen) == [0]
    # no drafts: one draw from the only row
    assert rejection_sample(np.zeros((0,), np.int32), probs[1:], gen) == [1]


def test_make_proposer_validation(models):
    _, _, tm, tp = models
    assert isinstance(make_proposer("ngram", tm, None, lambda: tp),
                      NGramProposer)
    assert isinstance(make_proposer("self-draft", tm, LayerCtx(),
                                    lambda: tp), SelfDraftProposer)
    with pytest.raises(ValueError, match="unknown draft proposer"):
        make_proposer("beam", tm, None, lambda: tp)
    with pytest.raises(TypeError, match="propose"):
        make_proposer(42, tm, None, lambda: tp)


# ------------------------------------------------------------- tuning

@pytest.mark.parametrize("hw", ["h100", "v5e", "flip"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-14b"])
def test_tune_draft_len_equals_reference(arch, hw):
    """The K the roofline picks at batch 1-8 (and at other acceptance
    rates and margins) equals the reference's, fed the same hardware;
    the result is memoized under the reference's key."""
    port_hw = {"h100": NVIDIA_H100_SXM, "v5e": TPU_V5E, "flip": FLIP_HW}[hw]
    ref_hw = JHW(**dataclasses.asdict(port_hw))
    kw = dict(phase="serve", n_tokens=4, dtype_bytes=2)
    plan = ProtectionPlan.for_model(get_config(arch), hw=port_hw, **kw)
    jplan = JPlan.for_model(jget(arch), hw=ref_hw, **kw)
    for b in range(1, 9):
        for opts in ({}, {"accept_rate": 0.3}, {"accept_rate": 1.0},
                     {"tput_margin": 0.2, "hi": 6}):
            assert plan.tune_draft_len(batch=b, **opts) == \
                jplan.tune_draft_len(batch=b, **opts), (b, opts)
    assert ("draft", 4, 1, 8, 0.7, 0.0) in plan._tune_cache
    plan._tune_cache[("draft", 4, 1, 8, 0.7, 0.0)] = 99
    assert plan.tune_draft_len(batch=4) == 99


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("T", [1, 2, 3, 5])
def test_verify_attention_matches_reference(T):
    """T queries a row against a cache of ragged lengths; row t attends
    ``length + t`` keys.  T = 1 is ``decode_attention`` exactly, and row
    t is bit for bit ``decode_attention`` at length ``length + t``."""
    rng = np.random.default_rng(T)
    B, S, H, KV, D = 3, 24, 4, 2, 8
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    length = np.array([1, 7, S - T + 1], np.int32)
    got = verify_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(length))
    want = jverify_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             jnp.asarray(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for t in range(T):
        dec = decode_attention(torch.from_numpy(q[:, t:t + 1].copy()),
                               torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(length + t))
        assert torch.equal(got[:, t:t + 1], dec), t


def _ctxs():
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU))
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E))
    return jctx, tctx


SLOTS, MAX_LEN, BS = 3, 32, 4


def _prefilled(models, kind):
    """Both packages' caches after one ragged prefill of slots 2 and 0
    (9 and 16 tokens; slot 1 stays empty); paged tables cover 24 tokens a
    slot.  Returns (jcache, tcache, tables, pos)."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(11)
    lengths = np.array([9, 16], np.int32)
    slots = np.array([2, 0], np.int32)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    tables = None
    if kind == "paged":
        nb = SLOTS * MAX_LEN // BS
        pool = BlockPool(nb, BS, SLOTS, MAX_LEN // BS)
        for s in slots:
            pool.alloc(int(s), 24)
        jcache = jm.init_paged_cache(SLOTS, nb, BS, dtype=jnp.float32)
        tcache = tm.init_paged_cache(nb, BS, dtype=torch.float32)
        tables = pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
    jctx, tctx = _ctxs()
    pre = None if tables is None else tables[slots]
    _, jcache, _ = jm.prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcache, jctx,
        slots=jnp.asarray(slots), lengths=jnp.asarray(lengths),
        block_tables=None if pre is None else jnp.asarray(pre))
    tm.prefill(tp, torch.from_numpy(toks).long(), tcache, tctx,
               slots=torch.from_numpy(slots),
               lengths=torch.from_numpy(lengths),
               block_tables=None if pre is None else torch.from_numpy(pre))
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    return jcache, tcache, tables, pos


def _clone(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


@pytest.mark.parametrize("T", [1, 2, 3, 5])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_model_verify_matches_reference_and_decode(models, kind, T):
    """``Model.verify`` logits within f32 tolerance of the reference's on
    every valid row, flags equal; row t bit for bit the port's own decode
    step at ``pos + t`` (fed the same window token by token, on a copy of
    the cache); the k/v rows past ``valid`` are never written."""
    jm, jp, tm, tp = models
    jcache, tcache, tables, pos = _prefilled(models, kind)
    rng = np.random.default_rng(20 + T)
    toks = rng.integers(1, 256, size=(SLOTS, T)).astype(np.int32)
    valid = np.array([T, 0, max(1, T - 1)], np.int32)
    jctx, tctx = _ctxs()
    tab = None if tables is None else torch.from_numpy(tables)
    before = _clone(tcache)
    jl, _, jf = jm.verify(jp, jnp.asarray(toks), jcache, jnp.asarray(pos),
                          jctx, jnp.asarray(valid),
                          block_tables=None if tables is None
                          else jnp.asarray(tables))
    tl, _, tf = tm.verify(tp, torch.from_numpy(toks).long(), tcache,
                          torch.from_numpy(pos), tctx,
                          torch.from_numpy(valid), block_tables=tab)
    assert bool(jf) is False and bool(tf) is False
    assert tl.dtype == torch.float32 and tl.shape[:2] == (SLOTS, T)
    for s in (0, 2):
        np.testing.assert_allclose(tl[s, :valid[s]].numpy(),
                                   np.asarray(jl)[s, :valid[s]], atol=1e-4,
                                   rtol=1e-4)
    # decode, one token at a time, from the pre-verify cache
    dcache = _clone(before)
    for t in range(T):
        dl, _, _ = tm.decode(tp, torch.from_numpy(toks[:, t:t + 1]).long(),
                             dcache, torch.from_numpy(pos + t), tctx,
                             block_tables=tab)
        for s in (0, 2):
            if t < valid[s]:
                assert torch.equal(tl[s, t], dl[s, 0]), (s, t)
    # cells past valid: untouched (slot 1 writes nothing at all)
    for layer, ref in zip(tcache, before):
        for name in ("k", "v"):
            for s in range(SLOTS):
                for t in range(valid[s], T):
                    p = int(pos[s]) + t
                    if kind == "paged":
                        if s == 1:
                            continue           # sentinel table: no cell
                        cell = (int(tables[s, p // BS]), p % BS)
                    else:
                        cell = (s, p)
                    assert torch.equal(layer[name][cell], ref[name][cell])


def test_window_write_drops_rows_past_the_cache_depth():
    """A window that would run past the cache depth drops those rows;
    nothing is clamped back onto committed keys."""
    from repro_torch.models.attention import verify_cells, verify_write_index
    from repro_torch.serve.paged_cache import index_write

    cache = torch.zeros((2, 6, 1, 1))
    new = torch.arange(1, 9, dtype=torch.float32).reshape(2, 4, 1, 1)
    pos = torch.tensor([3, 0], dtype=torch.int32)
    valid = torch.tensor([4, 2], dtype=torch.int32)
    index_write(cache, new, verify_write_index(pos, valid, 4, 6))
    assert cache[0, :, 0, 0].tolist() == [0, 0, 0, 1, 2, 3]
    assert cache[1, :, 0, 0].tolist() == [5, 6, 0, 0, 0, 0]
    rows, at = verify_cells(pos, valid, 6)
    assert rows.tolist() == [0, 0, 0, 1, 1]
    assert at.tolist() == [3, 4, 5, 0, 1]


# ------------------------------------------------------------- engine

def _prompts(seed=3):
    """Periodic prompts (the prompt-lookup best case) and prompts that
    repeat a random span, as the reference's spec tests and the chip
    phase's copy traffic use."""
    rng = np.random.default_rng(seed)
    out = [np.tile(3 + np.arange(4 + i % 2, dtype=np.int32), 16)[:21 + 2 * i]
           for i in range(2)]
    for n in (5, 9):
        span = rng.integers(1, 256, size=n)
        out.append(np.concatenate(
            [rng.integers(1, 256, size=4), span, rng.integers(1, 256, size=3),
             span]).astype(np.int32))
    return out


def _engine(models, pkg, *, slots=2, hw="v5e", adaptive=None, retries=1,
            **kw):
    jm, jp, tm, tp = models
    kw = dict(slots=slots, max_len=64, **kw)
    if pkg == "port":
        pol = adaptive or IntensityGuidedPolicy()
        return ServeEngine(
            tm, tp, abft=ABFTConfig.from_policy(
                pol, hardware=FLIP_HW if hw == "flip" else TPU_V5E),
            dtype=torch.float32, device="cpu",
            policy=RecoveryPolicy(max_retries=retries), **kw)
    pol = adaptive or JGuided()
    return JEngine(jm, jp, abft=JABFT.from_policy(
        pol, use_pallas=False, hardware=JFLIP_HW if hw == "flip" else JTPU),
        dtype=jnp.float32, policy=JRecovery(max_retries=retries), **kw)


def _drive(models, pkg, budgets=(10, 12, 11, 10), fault_at=None, **kw):
    eng = _engine(models, pkg, **kw)
    cls = Request if pkg == "port" else JRequest
    reqs = [cls(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), budgets))]
    out = eng.run(reqs, fault_at=fault_at)
    st = eng.stats
    return {"streams": {u: [int(t) for t in g] for u, g in out.items()},
            "errors": {r.uid: r.error for r in reqs if r.error},
            "counters": {k: getattr(st, k) for k in COUNTERS},
            "log": [{k: e.get(k) for k in LOG_KEYS}
                    for e in st.injection_log],
            "trace": st.selection_trace, "draft_len": eng.draft_len}


SPEC_RUNS = {
    "ngram_dense_k4": dict(spec_decode="ngram", draft_len=4),
    "ngram_paged_k4": dict(spec_decode="ngram", draft_len=4,
                           cache_kind="paged", block_size=4),
    "ngram_dense_auto": dict(spec_decode="ngram", draft_len="auto"),
    "ngram_paged_auto": dict(spec_decode="ngram", draft_len="auto",
                             cache_kind="paged", block_size=4),
    "self_draft_dense": dict(spec_decode="self_draft", draft_len=3,
                             draft_units=1, draft_window=8),
    "self_draft_paged": dict(spec_decode="self_draft", draft_len=2,
                             draft_units=2, draft_window=6,
                             cache_kind="paged", block_size=4),
    "ngram_share_chunks": dict(spec_decode="ngram", draft_len=4,
                               cache_kind="paged", block_size=4,
                               prefix_sharing=True, chunk_tokens=8),
}


@pytest.fixture(scope="module")
def unsped(models):
    return {kind: _drive(models, "port", cache_kind=kind)["streams"]
            for kind in ("dense", "paged")}


@pytest.mark.parametrize("name", sorted(SPEC_RUNS))
def test_spec_streams_equal_unsped_and_reference(models, unsped, name):
    """Greedy streams of a speculative engine equal, exactly, the port's
    unsped engine's and the reference spec engine's; the spec counters,
    the step count and the selection trace equal the reference's, and
    speculation really engaged."""
    kw = SPEC_RUNS[name]
    port = _drive(models, "port", **kw)
    ref = _drive(models, "ref", **kw)
    assert port["streams"] == unsped[kw.get("cache_kind", "dense")]
    assert port["streams"] == ref["streams"]
    assert port["counters"] == ref["counters"]
    assert port["trace"] == ref["trace"]
    assert port["draft_len"] == ref["draft_len"]
    assert not port["errors"] and not ref["errors"]
    c = port["counters"]
    assert 0 < c["draft_accepted"] <= c["draft_proposed"]


def test_verify_fault_retries_the_window_only(models):
    """A transient fault on a verify step: detected, the window re-runs
    alone, the streams equal the clean run's, and only
    ``verify_retries`` moves; log and counters equal the reference's."""
    fault = (1, ModelFault.at(1, "mlp_down", FaultSpec.value(0, 2, 1e4)))
    jfault = (1, JMF.at(1, "mlp_down", JFault.value(0, 2, 1e4)))
    kw = dict(spec_decode="ngram", draft_len=3)
    clean = _drive(models, "port", **kw)
    port = _drive(models, "port", fault_at=fault, **kw)
    ref = _drive(models, "ref", fault_at=jfault, **kw)
    assert port["streams"] == clean["streams"] == ref["streams"]
    c = port["counters"]
    assert c["faults_detected"] == c["verify_retries"] == c["retries"] == 1
    assert c["hard_faults"] == 0 and c["steps"] == clean["counters"]["steps"]
    assert port["counters"] == ref["counters"]
    assert port["log"] == ref["log"]
    assert port["log"][0]["phase"] == "verify"
    assert port["log"][0]["outcome"] == "corrected"


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_sticky_verify_fault_evicts(models, cache):
    """A sticky permanent campaign fault on ``mlp_down`` corrupts the
    retry like the attempt: the verify window becomes a hard fault and
    every resident slot is evicted with ``hard_fault:verify``; streams,
    errors, counters and the injection log equal the reference's."""
    recs = {}
    for pkg in ("port", "ref"):
        cls, dt = (FaultModel, torch.float32) if pkg == "port" \
            else (JFaultModel, np.float32)
        fm = cls(transient_rate=0.0, permanent_rate=0.3,
                 permanent_duration=3, seed=1, layers=2, dtype=dt,
                 magnitude=1e4, sites=("mlp_down",))
        recs[pkg] = _drive(models, pkg, spec_decode="ngram", draft_len=3,
                           cache_kind=cache, block_size=4, fault_model=fm)
    port, ref = recs["port"], recs["ref"]
    assert port["streams"] == ref["streams"]
    assert port["errors"] == ref["errors"]
    assert port["counters"] == ref["counters"]
    assert port["log"] == ref["log"]
    assert "hard_fault:verify" in port["errors"].values()
    assert port["counters"]["hard_faults"] >= 1


def test_escalation_shrinks_the_draft_like_the_reference(models):
    """``shrink_draft`` under escalation and back: the port's draft_len
    sequence equals the reference's, fixed and auto."""
    seqs = {}
    for pkg in ("port", "ref"):
        for dl in (4, 7, "auto"):
            pol = (ErrorAdaptivePolicy(shrink_draft=0.5) if pkg == "port"
                   else JAdaptive(shrink_draft=0.5))
            eng = _engine(models, pkg, adaptive=pol, spec_decode="ngram",
                          draft_len=dl)
            seq = [eng.draft_len]
            for level in (1, 0, 1):
                pol.level = level
                eng._set_protection_level(level, {})
                if dl == "auto":
                    eng._retune_draft_len()
                seq.append(eng.draft_len)
            seqs[(pkg, dl)] = seq
    for dl in (4, 7, "auto"):
        assert seqs[("port", dl)] == seqs[("ref", dl)], dl
    assert seqs[("port", 4)] == [4, 2, 4, 2]


def test_flip_hw_scheme_flips_equal_reference(models):
    """On the crafted roofline a 4-slot K=4 verify step crosses the CMR:
    the selection trace carries both schemes, and the trace and the
    ``scheme_flip`` instants equal the reference's."""
    recs = {}
    for pkg in ("port", "ref"):
        tel = EngineTelemetry(trace=True) if pkg == "port" \
            else JTelemetry(trace=True)
        rec = _drive(models, pkg, slots=4, hw="flip", spec_decode="ngram",
                     draft_len=4, telemetry=tel, budgets=(14, 14, 13, 12))
        rec["flips"] = [{k: e["args"][k] for k in (
            "intensity", "scheme", "decode", "prefill")}
            for e in tel.tracer.events if e.get("name") == "scheme_flip"]
        recs[pkg] = rec
    port, ref = recs["port"], recs["ref"]
    schemes = {e["scheme"] for e in port["trace"] if e["decode"]}
    assert schemes == {"block_1s", "global"}
    assert port["trace"] == ref["trace"]
    assert port["flips"] == ref["flips"]
    assert len(port["flips"]) == port["counters"]["scheme_flips"] > 0
    assert port["streams"] == ref["streams"]


def test_spec_counters_reach_the_telemetry(models):
    tel = EngineTelemetry()
    eng = _engine(models, "port", spec_decode="ngram", draft_len=3,
                  telemetry=tel)
    eng.run([Request(uid=i, prompt=p, max_new_tokens=8)
             for i, p in enumerate(_prompts())])
    assert tel.counters_match(eng.stats)
    snap = tel.registry.snapshot()
    val = {g: snap[g]["series"][0]["value"] for g in (
        "serve_spec_draft_proposed_total", "serve_spec_draft_accepted_total",
        "serve_spec_draft_len", "serve_spec_accept_rate")}
    st = eng.stats
    assert val["serve_spec_draft_proposed_total"] == st.draft_proposed > 0
    assert val["serve_spec_draft_accepted_total"] == st.draft_accepted
    assert val["serve_spec_draft_len"] == eng.draft_len
    assert val["serve_spec_accept_rate"] == pytest.approx(
        st.draft_accepted / st.draft_proposed)


def test_sampled_spec_stream_is_seeded(models):
    """Sampling through the rejection rule: tokens in the vocabulary, the
    same seed gives the same streams, and a verify retry redraws
    nothing (the draws follow the accepted attempt)."""
    def run(fault=None):
        eng = _engine(models, "port", spec_decode="ngram", draft_len=3,
                      temperature=0.8, top_k=20, seed=3)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=9)
                for i, p in enumerate(_prompts())]
        out = eng.run(reqs, fault_at=fault)
        return {u: list(g) for u, g in out.items()}, eng.stats

    a, st = run()
    b, _ = run()
    c, st_c = run((1, ModelFault.at(0, "mlp_down",
                                    FaultSpec.value(0, 1, 1e4))))
    assert a == b == c
    assert st.draft_proposed > 0 and st_c.verify_retries == 1
    vocab = models[2].cfg.vocab_size
    assert all(0 <= t < vocab for s in a.values() for t in s)


@pytest.mark.parametrize("opt", ["flash", "draft_len_0", "draft_len_str",
                                 "draft_len_float"])
def test_invalid_spec_options_raise_value_error(models, opt):
    """Flash attention with speculation and a bad draft length raise the
    reference's ValueError, in both packages."""
    kw = {"flash": dict(draft_len=2),
          "draft_len_0": dict(draft_len=0),
          "draft_len_str": dict(draft_len="big"),
          "draft_len_float": dict(draft_len=2.5)}[opt]
    jm, jp, tm, tp = models
    flash = opt == "flash"
    with pytest.raises(ValueError, match="flash" if flash else "draft_len"):
        ServeEngine(tm, tp, slots=1, max_len=16, device="cpu",
                    dtype=torch.float32, spec_decode="ngram",
                    abft=ABFTConfig(flash_attention=flash), **kw)
    with pytest.raises(ValueError, match="flash" if flash else "draft_len"):
        JEngine(jm, jp, slots=1, max_len=16, dtype=jnp.float32,
                spec_decode="ngram",
                abft=JABFT(use_pallas=flash, flash_attention=flash), **kw)
