"""The serving engine on qwen2-moe-a2.7b against the reference's, on the
CPU at ``scaled_down`` (2 MoE layers, 8 experts, top 2, f32): greedy
streams, counters, flags and selection traces of the plain dense and
paged engines, prefix sharing with copy-on-write, chunked prefill, a
decode fault at an expert GEMM, and one fault campaign over the MoE
sites whose records equal the reference's.

An MoE layer's capacity, and so which tokens its experts drop, depends on
every token of a call, so a shared or chunked MoE stream is held to the
reference's shared or chunked stream, not to the plain run's.  Padding
rows and free slots are routed and take capacity, as in the reference:
the engines use the reference's padded shapes.  The reference runs its
block schemes through the XLA emulation (``use_pallas=False``), the port
the K1 plain versions; flags and streams must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_moe_model import build_pair
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
            "rejections", "steps", "tokens", "prefix_tokens_shared",
            "cow_copies", "prefill_chunks", "faults_injected",
            "faults_corrected", "faults_uncorrected", "sdc_faults",
            "masked_faults")
MOE_SITES = ("qkv", "attn_out", "router", "expert_up", "expert_down",
             "mlp_down")
# name: (cache, chunk_tokens, prefix_sharing, decode fault at step)
SCENARIOS = {
    "dense": ("dense", None, False, None),
    "paged": ("paged", None, False, None),
    "share": ("paged", None, True, None),
    "chunk": ("dense", 8, False, None),
    "expert_fault": ("paged", None, False, 3),
}


BUDGETS = (16, 3, 5, 5, 5)      # new tokens a request


@pytest.fixture(scope="module")
def pair():
    return build_pair()


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


def _reqs(port):
    R = Request if port else JRequest
    return [R(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_traffic(), BUDGETS))]


def _engine(port, pair, cache, chunk=None, share=False, fault_model=None):
    jm, jp, tm, tp = pair
    kw = dict(slots=2, max_len=48, cache_kind=cache, block_size=8,
              chunk_tokens=chunk, prefix_sharing=share,
              fault_model=fault_model)
    if port:
        return ServeEngine(tm, tp, dtype=torch.float32, device="cpu",
                           abft=ABFTConfig.from_policy(
                               IntensityGuidedPolicy(), hardware=TPU_V5E),
                           policy=RecoveryPolicy(max_retries=1), **kw)
    return JEngine(jm, jp, dtype=jnp.float32,
                   abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                          hardware=JTPU),
                   policy=JRecovery(max_retries=1), **kw)


def _serve(port, pair, name):
    cache, chunk, share, fstep = SCENARIOS[name]
    eng = _engine(port, pair, cache, chunk, share)
    reqs = _reqs(port)
    fault_at = None
    if fstep is not None:
        fault_at = (fstep, ModelFault.at(1, "expert_up",
                                         FaultSpec.value(0, 1, 1e5))
                    if port else JMF.at(1, "expert_up",
                                        JFault.value(0, 1, 1e5)))
    out = eng.run(reqs, fault_at=fault_at)
    st = eng.stats
    return (out, {k: getattr(st, k) for k in COUNTERS},
            st.selection_trace, {r.uid: r.error for r in reqs})


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_reference(pair, name):
    got, ref = _serve(True, pair, name), _serve(False, pair, name)
    assert got[0] == ref[0], "greedy streams differ"
    assert got[1] == ref[1], "engine counters differ"
    assert got[2] == ref[2], "selection traces differ"
    assert got[3] == ref[3], "request errors differ"
    c = got[1]
    if name == "share":
        assert c["prefix_tokens_shared"] > 0 and c["cow_copies"] > 0
    if name == "chunk":
        assert c["prefill_chunks"] > len(_traffic())
    if name == "expert_fault":
        assert c["faults_detected"] >= 1 and c["retries"] >= 1
        assert got[0] == _serve(True, pair, "paged")[0]


def test_moe_campaign_records_equal_the_references(pair):
    """A seeded transient campaign over the MoE sites (router, expert
    up/down, the shared experts' down and the attention GEMMs): the
    schedule, the injection log, every counter and the streams equal the
    reference's; every injection is accounted for and none is an SDC."""
    recs = []
    for port in (True, False):
        cls, dt = (FaultModel, torch.float32) if port \
            else (JFaultModel, np.float32)
        fm = cls(transient_rate=0.4, seed=4, layers=2, sites=MOE_SITES,
                 rows=2, cols=8, dtype=dt, magnitude=1e4)
        eng = _engine(port, pair, "paged", fault_model=fm)
        out = eng.run(_reqs(port))
        st = eng.stats
        recs.append({"streams": out, "schedule": fm.schedule,
                     "counters": {k: getattr(st, k) for k in COUNTERS},
                     "log": [{k: e.get(k) for k in (
                         "source", "kind", "engine_step", "phase",
                         "outcome", "layer", "site", "row", "col")}
                         for e in st.injection_log]})
    got, ref = recs
    assert got["schedule"] == ref["schedule"] and got["schedule"]
    assert {r["site"] for r in got["schedule"]} & {"router", "expert_up",
                                                    "expert_down"}
    assert got["log"] == ref["log"]
    assert got["counters"] == ref["counters"]
    assert got["streams"] == ref["streams"]
    c = got["counters"]
    assert c["faults_injected"] == (c["faults_corrected"]
                                    + c["faults_uncorrected"]
                                    + c["sdc_faults"] + c["masked_faults"])
    assert c["faults_injected"] > 0 and c["sdc_faults"] == 0
