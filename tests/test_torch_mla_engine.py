"""The serving engine on deepseek-v3-671b against the reference's, on the
CPU at ``scaled_down`` (f32): the two-layer MLA stack with an MoE layer
(plain dense and paged engines, prefix sharing with copy-on-write and
chunked prefill together, a decode fault at ``kv_a`` under sharing, a
fault campaign with sharing, and the shadow classification of undetected
faults), then speculative decoding on the all-dense one-layer MLA stack;
on the two-layer stack speculation raises ``NotImplementedError``.

An MLA layer caches one leaf, ``latent``: the engine gathers, scatters
and fences it by walking each layer's leaves (no leaf is named ``k`` or
``v``).  The reference runs its block schemes through the XLA emulation
(``use_pallas=False``), the port the K1 plain versions; greedy streams,
counters, selection traces, errors and injection records must be equal
(an MoE stream under sharing or chunking is held to the reference's,
whose capacity the call's tokens set).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_mla_model import build_pair
import torch

from repro.core import FaultSpec as JFault
from repro.core.faults import FaultModel as JFaultModel
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import ModelFault as JMF
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro_torch.core.faults import FaultModel, FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import ModelFault
from repro_torch.serve.engine import (
    Cells,
    RecoveryPolicy,
    Request,
    ServeEngine,
)

torch.set_num_threads(1)

COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "rejections", "steps", "tokens", "prefix_tokens_shared",
            "cow_copies", "prefill_chunks", "faults_injected",
            "faults_corrected", "faults_uncorrected", "sdc_faults",
            "masked_faults", "draft_proposed", "draft_accepted",
            "verify_retries")
LOG_KEYS = ("source", "kind", "engine_step", "phase", "outcome",
            "tokens_match", "layer", "site", "row", "col")
MLA_SITES = ("q_a", "kv_a", "attn_out", "router", "expert_up", "mlp_down")
# name: (cache, chunk_tokens, prefix_sharing, (decode step, layer, site))
SCENARIOS = {
    "dense": ("dense", None, False, None),
    "share_chunk": ("paged", 8, True, None),
    "kv_a_fault_shared": ("paged", None, True, (3, 0, "kv_a")),
}
PORT_ONLY = {"paged": ("paged", None, False, None),
             "share": ("paged", None, True, None)}
BUDGETS = (16, 3, 5, 5, 5)      # new tokens a request


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def dense_pair():
    return build_pair(n_layers=1)


def _traffic():
    """Three prompts open with one 9-token system prefix (the first stays
    resident longest: ``BUDGETS``), a long one, and a copy of the first
    (its blocks shared, then copied on write)."""
    rng = np.random.default_rng(3)
    sys_p = rng.integers(1, 256, size=9)
    prompts = [np.concatenate([sys_p, rng.integers(1, 256, size=int(n))])
               for n in (3, 6, 2)]
    prompts += [rng.integers(1, 256, size=27), prompts[0].copy()]
    return [p.astype(np.int32) for p in prompts]


def _reqs(port, prompts=None, budgets=BUDGETS):
    R = Request if port else JRequest
    return [R(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts or _traffic(), budgets))]


def _engine(port, pair, cache, chunk=None, share=False, **kw):
    jm, jp, tm, tp = pair
    kw = dict(slots=2, max_len=48, cache_kind=cache, block_size=8,
              chunk_tokens=chunk, prefix_sharing=share, **kw)
    if port:
        enabled = kw.pop("abft_enabled", True)
        abft = (ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                       hardware=TPU_V5E) if enabled
                else ABFTConfig(enabled=False))
        return ServeEngine(tm, tp, dtype=torch.float32, device="cpu",
                           abft=abft, policy=RecoveryPolicy(max_retries=1),
                           **kw)
    enabled = kw.pop("abft_enabled", True)
    abft = (JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)
            if enabled else JABFT(enabled=False, use_pallas=False))
    return JEngine(jm, jp, dtype=jnp.float32, abft=abft,
                   policy=JRecovery(max_retries=1), **kw)


def _record(eng, out, reqs) -> dict:
    st = eng.stats
    return {"streams": {u: [int(t) for t in g] for u, g in out.items()},
            "counters": {k: getattr(st, k) for k in COUNTERS},
            "trace": st.selection_trace,
            "errors": {r.uid: r.error for r in reqs if r.error},
            "log": [{k: e.get(k) for k in LOG_KEYS}
                    for e in st.injection_log]}


def _serve(port, pair, name):
    cache, chunk, share, fault = {**SCENARIOS, **PORT_ONLY}[name]
    eng = _engine(port, pair, cache, chunk, share)
    reqs = _reqs(port)
    fault_at = None
    if fault is not None:
        step, layer, site = fault
        fault_at = (step, ModelFault.at(layer, site,
                                        FaultSpec.value(0, 1, 1e5))
                    if port else JMF.at(layer, site,
                                        JFault.value(0, 1, 1e5)))
    return _record(eng, eng.run(reqs, fault_at=fault_at), reqs)


@pytest.fixture(scope="module")
def plain_paged(pair):
    return _serve(True, pair, "paged")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(pair, plain_paged, name):
    """Each scenario's records equal the reference's; the plain dense
    engine's streams equal the plain paged engine's, and the faulted
    shared run's equal its clean twin's."""
    got, ref = _serve(True, pair, name), _serve(False, pair, name)
    assert got == ref
    c = got["counters"]
    assert not got["errors"]
    if SCENARIOS[name][2]:
        assert c["prefix_tokens_shared"] > 0 and c["cow_copies"] > 0
    if SCENARIOS[name][1]:
        assert c["prefill_chunks"] > len(_traffic())
    if SCENARIOS[name][3] is not None:
        assert c["faults_detected"] >= 1 and c["retries"] >= 1
        assert got["log"] and got["log"][0]["outcome"] == "corrected"
    if name == "kv_a_fault_shared":         # recomputed to the clean run
        clean = _serve(True, pair, "share")
        assert clean["counters"]["faults_detected"] == 0
        assert got["streams"] == clean["streams"]
    if name == "dense":
        assert got["streams"] == plain_paged["streams"]


def test_the_engine_walks_the_latent_leaf(pair):
    """The cache holds one ``latent`` leaf a layer and the engine's
    gather, scatter and fence walk it (its attention cells, ``Cells.kv``:
    the MLA stack has no per-slot state)."""
    for cache in ("dense", "paged"):
        eng = _engine(True, pair, cache)
        assert all(list(layer) == ["latent"] for layer in eng.cache)
        cells = Cells(kv=(torch.tensor([1, 0]), torch.tensor([5, 2])),
                      rows=torch.tensor([0]))
        assert [t.data_ptr() for t, _ in eng._leaves(cells)] == \
            [layer["latent"].data_ptr() for layer in eng.cache]
        vals = [torch.full((2, leaf.shape[-1]), float(i))
                for i, (leaf, _) in enumerate(eng._leaves(cells))]
        eng._scatter(cells, vals)
        for got, want in zip(eng._gather(cells), vals, strict=True):
            assert torch.equal(got, want)


@pytest.mark.parametrize("abft", ["protected", "off"])
def test_campaign_with_sharing_records_equal_the_references(pair, abft):
    """A seeded transient campaign over the MLA and MoE sites on the
    paged engine with prefix sharing: the schedule, the injection log,
    every counter and the streams equal the reference's.  Protected,
    every fault is detected and recomputed (its latent cells rewritten by
    the retry); with ABFT off every fault is undetected and classified by
    a shadow run, which gathers the faulted latent cells, re-runs clean
    and scatters them back."""
    recs = []
    for port in (True, False):
        cls, dt = (FaultModel, torch.float32) if port \
            else (JFaultModel, np.float32)
        # row 0: the reference's emulation hits (row, col) of each batch
        # row's (1, N) decode output, so a row past 0 would miss it there
        fm = cls(transient_rate=0.4, seed=7, layers=2, sites=MLA_SITES,
                 rows=1, cols=8, dtype=dt, magnitude=1e4)
        eng = _engine(port, pair, "paged", share=True, fault_model=fm,
                      abft_enabled=abft == "protected")
        reqs = _reqs(port)
        rec = _record(eng, eng.run(reqs), reqs)
        rec["schedule"] = fm.schedule
        recs.append(rec)
    got, ref = recs
    assert got["schedule"] == ref["schedule"] and got["schedule"]
    assert {r["site"] for r in got["schedule"]} & {"q_a", "kv_a"}
    assert got == ref
    c = got["counters"]
    assert c["faults_injected"] == (c["faults_corrected"]
                                    + c["faults_uncorrected"]
                                    + c["sdc_faults"] + c["masked_faults"])
    assert c["faults_injected"] > 0 and c["prefix_tokens_shared"] > 0
    if abft == "protected":
        assert c["sdc_faults"] == 0 and c["faults_corrected"] > 0
    else:
        assert c["faults_detected"] == 0
        assert all(e["tokens_match"] is not None for e in got["log"])


def _spec_prompts():
    """Periodic prompts and prompts that repeat a random span (n-gram
    proposals find matches)."""
    rng = np.random.default_rng(3)
    out = [np.tile(3 + np.arange(4 + i, dtype=np.int32), 16)[:21 + 2 * i]
           for i in range(2)]
    for n in (5, 9):
        span = rng.integers(1, 256, size=n)
        out.append(np.concatenate(
            [rng.integers(1, 256, size=4), span, rng.integers(1, 256, size=3),
             span]).astype(np.int32))
    return out


SPEC_RUNS = {
    "ngram_dense_k4": dict(spec_decode="ngram", draft_len=4),
    "ngram_paged_share_chunks": dict(spec_decode="ngram", draft_len=3,
                                     cache_kind="paged", block_size=4,
                                     prefix_sharing=True, chunk_tokens=8),
}


def _spec(port, pair, **kw):
    jm, jp, tm, tp = pair
    kw = dict(slots=2, max_len=64, **kw)
    if port:
        eng = ServeEngine(tm, tp, dtype=torch.float32, device="cpu",
                          abft=ABFTConfig.from_policy(
                              IntensityGuidedPolicy(), hardware=TPU_V5E),
                          policy=RecoveryPolicy(max_retries=1), **kw)
    else:
        eng = JEngine(jm, jp, dtype=jnp.float32,
                      abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                             hardware=JTPU),
                      policy=JRecovery(max_retries=1), **kw)
    reqs = _reqs(port, _spec_prompts(), (10, 12, 11, 10))
    return _record(eng, eng.run(reqs), reqs)


@pytest.mark.parametrize("name", sorted(SPEC_RUNS))
def test_spec_on_the_dense_mla_stack_equals_unsped_and_reference(
        dense_pair, name):
    """Speculation on the all-dense MLA stack: greedy streams equal the
    port's unsped engine's and the reference's spec engine's; the counters
    and traces equal the reference's, and speculation engaged."""
    kw = SPEC_RUNS[name]
    port, ref = _spec(True, dense_pair, **kw), _spec(False, dense_pair, **kw)
    unsped = _spec(True, dense_pair, cache_kind=kw.get("cache_kind",
                                                       "dense"))
    assert port == ref
    assert port["streams"] == unsped["streams"]
    c = port["counters"]
    assert 0 < c["draft_accepted"] <= c["draft_proposed"]


def test_spec_on_the_moe_stack_raises(pair):
    """Speculation on the MLA + MoE stack is ported (the name is the
    refusal this test held before): it constructs and serves with the
    reference's window (``tests/test_torch_moe_spec.py`` holds its
    streams to the reference's)."""
    jm, jp, tm, tp = pair
    eng = ServeEngine(tm, tp, slots=1, max_len=16, device="cpu",
                      dtype=torch.float32, spec_decode="ngram", draft_len=2)
    out = eng.run([Request(uid=0, prompt=np.array([5, 6, 5, 6, 5]),
                           max_new_tokens=4)])
    assert len(out[0]) == 4 and eng.stats.steps >= 1
