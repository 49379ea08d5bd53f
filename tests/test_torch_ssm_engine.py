"""The serving engine on the SSM family against the reference's, on the
CPU in f32: mamba2-1.3b at ``scaled_down`` (2 ``mamba:none:0`` layers) and
jamba-v0.1-52b at ``scaled_down`` cut to one 8-layer unit (7 Mamba2 layers,
one attention layer, MoE every other layer).  Greedy streams, counters,
flags, request errors and selection traces of the dense and paged engines
equal the reference's, faults included; a decode fault at ``ssm_in`` or
``ssm_out`` is retried from the pre-step state, so the stream and every
state leaf at the end equal the clean run's bit for bit; a sticky fault
evicts as the reference's does; a campaign's records (shadow
``state_match`` included) equal the reference's; and prefix sharing,
chunked prefill and speculation raise the reference's ``ValueError``s.

The reference runs its block schemes through the XLA emulation
(``use_pallas=False``).  That emulation corrupts a fault's (row, col) in
every leading batch index, K1 the flattened row alone, so records that
depend on where an undetected fault lands are compared on a one-slot
engine, where the two agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_shared_runners import shared_runners
from test_torch_ssm_model import build_pair
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
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

torch.set_num_threads(1)

COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "rejections", "steps", "tokens", "faults_injected",
            "faults_corrected", "faults_uncorrected", "sdc_faults",
            "masked_faults")
BUDGETS = (9, 3, 6, 5)          # new tokens a request
# name: (cache, decode fault (layer, site) at run step 3)
SCENARIOS = {
    "dense": ("dense", None),
    "paged": ("paged", None),
    "ssm_in_fault": ("dense", (1, "ssm_in")),
    "ssm_out_fault": ("paged", (1, "ssm_out")),
}
MAMBA2, JAMBA = "mamba2-1.3b", "jamba-v0.1-52b"
# jamba (eight layers, the reference's engine jitted anew each run) runs
# the plain, the paged and one fault scenario and the shadowed campaign
CASES = [(MAMBA2, n) for n in sorted(SCENARIOS)] + [
    (JAMBA, n) for n in ("dense", "paged", "ssm_in_fault")]
_PAIRS: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``)."""
    with shared_runners():
        yield


def _pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = (arch,) + build_pair(arch)
    return _PAIRS[arch]


def _traffic():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 256, size=int(n)).astype(np.int32)
            for n in (5, 2, 11, 7)]


def _reqs(port, budgets=BUDGETS):
    R = Request if port else JRequest
    return [R(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_traffic(), budgets))]


def _engine(port, pair, cache, slots=2, fault_model=None, retries=1, **kw):
    _, jm, jp, tm, tp = pair
    kw = dict(slots=slots, max_len=48, cache_kind=cache, block_size=8,
              fault_model=fault_model, **kw)
    if port:
        return ServeEngine(tm, tp, dtype=torch.float32, device="cpu",
                           abft=ABFTConfig.from_policy(
                               IntensityGuidedPolicy(), hardware=TPU_V5E),
                           policy=RecoveryPolicy(max_retries=retries), **kw)
    return JEngine(jm, jp, dtype=jnp.float32,
                   abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                          hardware=JTPU),
                   policy=JRecovery(max_retries=retries), **kw)


def _fault(port, layer, site, delta=1e5):
    return (ModelFault.at(layer, site, FaultSpec.value(0, 1, delta)) if port
            else JMF.at(layer, site, JFault.value(0, 1, delta)))


def _states(eng) -> list:
    return [t.clone() for layer, st in zip(eng.cache,
                                           eng.model.state_layers)
            if st for t in layer.values()]


def _serve(port, pair, name):
    cache, fault = SCENARIOS[name]
    eng = _engine(port, pair, cache)
    reqs = _reqs(port)
    fault_at = None if fault is None else (3, _fault(port, *fault))
    out = eng.run(reqs, fault_at=fault_at)
    st = eng.stats
    return (out, {k: getattr(st, k) for k in COUNTERS}, st.selection_trace,
            {r.uid: r.error for r in reqs},
            _states(eng) if port else None)


@pytest.mark.parametrize("arch,name", CASES)
def test_engine_matches_reference(arch, name):
    pair = _pair(arch)
    got, ref = _serve(True, pair, name), _serve(False, pair, name)
    assert got[0] == ref[0], "greedy streams differ"
    assert got[1] == ref[1], "engine counters differ"
    assert got[2] == ref[2], "selection traces differ"
    assert got[3] == ref[3], "request errors differ"
    if SCENARIOS[name][1] is not None:
        c = got[1]
        assert c["faults_detected"] == c["retries"] == 1
        clean = _serve(True, pair, SCENARIOS[name][0])
        assert got[0] == clean[0], "the retried stream differs"
        assert all(torch.equal(a, b) for a, b in zip(got[4], clean[4])), \
            "the retried run's state differs from the clean run's"


def test_decode_retry_reads_the_pre_step_state():
    """The faulted decode attempt's state is never committed: with the
    retry refused (``max_retries=0``) the fault evicts every resident
    request and commits nothing, so the state is the one before the
    step; with one retry the step's state is the clean step's."""
    pair = _pair(MAMBA2)
    clean = _engine(True, pair, "dense")
    reqs = _reqs(True)
    clean.admit(list(reqs))
    pre = _states(clean)
    clean.step()
    for retries, want in ((0, pre), (1, _states(clean))):
        eng = _engine(True, pair, "dense", retries=retries)
        eng.admit(list(_reqs(True)))
        assert all(torch.equal(a, b) for a, b in zip(_states(eng), pre))
        eng.step(_fault(True, 1, "ssm_out"))
        assert all(torch.equal(a, b) for a, b in zip(_states(eng), want))
        assert eng.stats.hard_faults == (1 - retries)


def test_sticky_fault_evicts_as_the_reference():
    """A permanent campaign fault at ``ssm_in`` survives the retry and
    evicts the residents with ``hard_fault:decode``; the schedule, log,
    counters, errors and streams equal the reference's."""
    pair = _pair(MAMBA2)
    recs = []
    for port in (True, False):
        cls, dt = (FaultModel, torch.float32) if port \
            else (JFaultModel, np.float32)
        fm = cls(permanent_rate=0.3, permanent_duration=3, seed=6, layers=2,
                 sites=("ssm_in",), rows=1, cols=8, dtype=dt,
                 magnitude=1e4)
        eng = _engine(port, pair, "paged", fault_model=fm)
        reqs = _reqs(port)
        out = eng.run(reqs)
        st = eng.stats
        recs.append((out, fm.schedule, {k: getattr(st, k) for k in COUNTERS},
                     {r.uid: r.error for r in reqs},
                     [{k: e.get(k) for k in ("kind", "engine_step", "phase",
                                             "outcome", "layer", "site")}
                      for e in st.injection_log]))
    got, ref = recs
    assert got == ref
    assert got[2]["hard_faults"] >= 1
    assert "hard_fault:decode" in got[3].values()


@pytest.mark.parametrize("arch,magnitude", [
    (MAMBA2, 1e4), (MAMBA2, 1e-3), (JAMBA, 1e-3)],
    ids=["mamba2-detected", "mamba2-shadowed", "jamba-shadowed"])
def test_campaign_records_equal_the_references(arch, magnitude):
    """A seeded transient campaign over ``ssm_in`` and ``ssm_out`` on a
    one-slot engine: at 1e4 every fault is detected and corrected; at 1e-3
    none is, and the shadow run classifies each with ``tokens_match`` and
    ``state_match`` (the state rows compared and the faulted ones kept).
    Schedule, log, counters and streams equal the reference's."""
    pair = _pair(arch)
    layers = pair[3].cfg.n_layers
    recs = []
    for port in (True, False):
        cls, dt = (FaultModel, torch.float32) if port \
            else (JFaultModel, np.float32)
        fm = cls(transient_rate=0.4, seed=4, layers=layers,
                 sites=("ssm_in", "ssm_out"), rows=1, cols=8, dtype=dt,
                 magnitude=magnitude)
        eng = _engine(port, pair, "dense", slots=1, fault_model=fm)
        out = eng.run(_reqs(port, (6, 3, 4, 2)))
        st = eng.stats
        recs.append({"streams": out, "schedule": fm.schedule,
                     "counters": {k: getattr(st, k) for k in COUNTERS},
                     "log": [{k: e.get(k) for k in (
                         "kind", "engine_step", "phase", "outcome", "layer",
                         "site", "row", "col", "tokens_match",
                         "state_match")} for e in st.injection_log]})
    got, ref = recs
    assert got["schedule"] == ref["schedule"] and got["schedule"]
    assert got["log"] == ref["log"]
    assert got["counters"] == ref["counters"]
    assert got["streams"] == ref["streams"]
    c = got["counters"]
    if magnitude > 1:
        assert c["faults_corrected"] == c["faults_injected"] > 0
    else:
        assert c["faults_detected"] == 0
        assert c["masked_faults"] + c["sdc_faults"] == c["faults_injected"]
        assert any(e["state_match"] is False for e in got["log"])


def test_shadow_keeps_the_faulted_state():
    """An undetected decode fault stays committed after the shadow run:
    the classified engine ends with the same streams and state as one
    that does not classify."""
    pair = _pair(MAMBA2)
    out = []
    for classify in (True, False):
        eng = _engine(True, pair, "dense", classify_injections=classify)
        res = eng.run(_reqs(True), fault_at=(2, _fault(True, 0, "ssm_out",
                                                       1e-3)))
        out.append((res, _states(eng), eng.stats.injection_log))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    rec = out[0][2][0]
    assert rec["outcome"] in ("masked", "sdc") and rec["state_match"] is False
    assert "state_match" not in out[1][2][0]


@pytest.mark.parametrize("opts", [
    dict(cache_kind="paged", prefix_sharing=True),
    dict(chunk_tokens=8),
    dict(spec_decode="ngram", draft_len=2),
], ids=["prefix_sharing", "chunk_tokens", "spec_decode"])
@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_mid_prompt_and_speculative_options_raise(arch, opts):
    _, jm, jp, tm, tp = _pair(arch)
    with pytest.raises(ValueError) as got:
        ServeEngine(tm, tp, slots=2, max_len=48, dtype=torch.float32,
                    device="cpu", **opts)
    with pytest.raises(ValueError) as ref:
        JEngine(jm, jp, slots=2, max_len=48, dtype=jnp.float32, **opts)
    assert str(got.value).split("(")[0] == str(ref.value).split("(")[0]
