"""Fault campaigns, shadow-stream classification and adaptive protection:
the port's ``ServeEngine`` against the reference's on scaled-down
llama3.2-1b (2 layers, f32, the reference's parameters through numpy).
The reference runs as its own tests run it on the CPU
(``use_pallas=False``).

Every campaign here injects VALUE faults of magnitude 1e4 (``MAG``, the
reference's own campaign tests and benchmark use it): the residual of
such a fault sits orders of magnitude above both the port's threshold
(the reference's kernel path) and the reference emulation's, and a clean
step's sits far below both, so each outcome — corrected, uncorrected,
sdc, masked — is a deterministic function of the seed in both packages
and is compared EXACTLY, entry by entry.  Random exponent-bit flips are
not compared one by one: a low exponent bit scales one element by a
power of two, whose residual can land between the two packages'
thresholds (ROADMAP queue C: the kernel path omits the emulation's
quantization terms), so those campaigns are held to the invariants
only.  Cache contents after an SDC step are f32 values computed by two
implementations; they agree within 1e-4 of the largest magnitude (f32
rounding through 2 layers of a model whose faulted activations reach
~1e4), and the faulted cells differ from clean ones by far more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_shared_runners import shared_runners
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.faults import FaultModel as JFaultModel
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import (
    ErrorAdaptivePolicy as JAdaptive,
    IntensityGuidedPolicy as JGuided,
)
from repro.core.protected import ABFTConfig as JABFT
from repro.models import build_model
from repro.obs import EngineTelemetry as JTelemetry
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultModel
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import ErrorAdaptivePolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.model import Model, params_from_reference
from repro_torch.obs import EngineTelemetry
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``)."""
    with shared_runners():
        yield


MAG = 1e4
COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "steps", "tokens", "faults_injected", "faults_corrected",
            "faults_uncorrected", "sdc_faults", "masked_faults",
            "protection_escalations", "protection_deescalations")
LOG_KEYS = ("source", "kind", "engine_step", "phase", "outcome",
            "tokens_match", "state_match", "onset_step", "layer", "site",
            "row", "col", "bit", "delta", "armed_step", "run_step")


@pytest.fixture(scope="module")
def setup():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 24, size=5)]
    return jm, jp, Model(cfg), tp, prompts


def _fm(pkg, kind, rate, seed=0, **kw):
    cls, dt = (FaultModel, torch.float32) if pkg == "port" \
        else (JFaultModel, np.float32)
    return cls(transient_rate=rate if kind == "transient" else 0.0,
               permanent_rate=rate if kind == "permanent" else 0.0,
               permanent_duration=4, seed=seed, layers=2, dtype=dt,
               magnitude=MAG, **kw)


def _abft(pkg, protect, flash, adaptive=False):
    if pkg == "port":
        pol = IntensityGuidedPolicy()
        if adaptive:
            pol = ErrorAdaptivePolicy(pol, detection_threshold=0.02,
                                      deescalate_after=4)
        return ABFTConfig.from_policy(pol, hardware=TPU_V5E,
                                      flash_attention=flash,
                                      enabled=protect)
    pol = JGuided()
    if adaptive:
        pol = JAdaptive(pol, detection_threshold=0.02, deescalate_after=4)
    cfg = JABFT.from_policy(pol, use_pallas=False, hardware=JTPU,
                            flash_attention=flash)
    return cfg if protect else JABFT.off()


def _engine(setup, pkg, *, cache="dense", protect=True, flash=False,
            adaptive=False, fault_model=None, telemetry=None, retries=1):
    jm, jp, tm, tp, _ = setup
    kw = dict(slots=2, max_len=64, cache_kind=cache,
              fault_model=fault_model, telemetry=telemetry,
              abft=_abft(pkg, protect, flash, adaptive))
    if pkg == "port":
        return ServeEngine(tm, tp, dtype=torch.float32, device="cpu",
                           policy=RecoveryPolicy(max_retries=retries), **kw)
    return JEngine(jm, jp, dtype=jnp.float32,
                   policy=JRecovery(max_retries=retries), **kw)


def _reqs(setup, pkg, new_tokens=6):
    cls = Request if pkg == "port" else JRequest
    return [cls(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(setup[4])]


def _record(eng, out, fm=None):
    st = eng.stats
    return {"streams": out,
            "counters": {k: getattr(st, k) for k in COUNTERS},
            "log": [{k: e.get(k) for k in LOG_KEYS}
                    for e in st.injection_log],
            "schedule": fm.schedule if fm is not None else None,
            "trace": st.selection_trace}


def _run(setup, pkg, **kw):
    fm = kw.get("fault_model")
    eng = _engine(setup, pkg, **kw)
    reqs = _reqs(setup, pkg)
    rec = _record(eng, eng.run(reqs), fm)
    rec["errors"] = {r.uid: r.error for r in reqs}
    return rec


CAMPAIGNS = {   # name: (cache, flash, protect, kind, rate)
    "dense_transient": ("dense", False, True, "transient", 0.3),
    "dense_permanent": ("dense", False, True, "permanent", 0.15),
    "dense_off_transient": ("dense", False, False, "transient", 0.3),
    "dense_off_permanent": ("dense", False, False, "permanent", 0.15),
    "paged_transient": ("paged", True, True, "transient", 0.3),
    "paged_permanent": ("paged", True, True, "permanent", 0.15),
    "paged_off_transient": ("paged", False, False, "transient", 0.3),
}


@pytest.mark.parametrize("name", sorted(CAMPAIGNS))
def test_campaign_matches_reference(setup, name):
    cache, flash, protect, kind, rate = CAMPAIGNS[name]
    got = _run(setup, "port", cache=cache, flash=flash, protect=protect,
               fault_model=_fm("port", kind, rate))
    ref = _run(setup, "ref", cache=cache, flash=flash, protect=protect,
               fault_model=_fm("ref", kind, rate))
    assert got["schedule"] == ref["schedule"] and got["schedule"]
    assert got["log"] == ref["log"]
    assert got["counters"] == ref["counters"]
    assert got["streams"] == ref["streams"]
    assert got["errors"] == ref["errors"]
    c = got["counters"]
    assert c["faults_injected"] == (c["faults_corrected"]
                                    + c["faults_uncorrected"]
                                    + c["sdc_faults"] + c["masked_faults"])
    if protect:
        assert c["sdc_faults"] == 0 and c["faults_injected"] > 0
        if kind == "permanent":
            assert c["hard_faults"] > 0 and c["faults_uncorrected"] > 0
    else:
        assert c["sdc_faults"] > 0


def test_fault_at_and_admission_placement_match_reference(setup):
    from repro.core import FaultSpec as JSpec
    from repro.models import ModelFault as JMF
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    recs = []
    for pkg, mf, spec in (("port", ModelFault, FaultSpec),
                          ("ref", JMF, JSpec)):
        eng = _engine(setup, pkg, protect=False)
        eng.classify_injections = True
        f = mf.at(1, "attn_out", spec.value(0, 3, MAG))
        out = eng.run(_reqs(setup, pkg), fault_at=(2, f),
                      admit_fault_at=(1, f))
        recs.append(_record(eng, out))
    assert recs[0]["log"] == recs[1]["log"]
    assert [e["source"] for e in recs[0]["log"]] == ["admit_fault",
                                                     "fault_at"]
    assert recs[0]["streams"] == recs[1]["streams"]


def _lockstep(jeng, teng, jreqs, treqs, each_step):
    jpend, tpend = list(jreqs), list(treqs)
    while tpend or teng.active:
        if tpend and teng.free_slots():
            teng.admit(tpend)
            jeng.admit(jpend)
        teng.step()
        jeng.step()
        each_step()
    assert not jpend and not jeng.active


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_sdc_step_keeps_the_faulted_cells_committed(setup, cache):
    """After every SDC step the port's in-place cache equals the
    reference's committed ``new_cache`` — the faulted cells stay; the
    shadow run's clean cells were scattered away."""
    jeng = _engine(setup, "ref", cache=cache, protect=False,
                   fault_model=_fm("ref", "transient", 0.3))
    teng = _engine(setup, "port", cache=cache, protect=False,
                   fault_model=_fm("port", "transient", 0.3))
    checked = []

    def each_step():
        log = teng.stats.injection_log
        if not log or log[-1]["engine_step"] != teng.stats.steps \
                or log[-1]["outcome"] != "sdc":
            return
        if checked and checked[-1] == teng.stats.steps:
            return
        for layer in range(2):
            for kv in ("k", "v"):
                ref = np.asarray(
                    jeng.cache[0]["pos0"]["attn"][kv][layer])
                got = teng.cache[layer][kv].numpy()
                scale = float(np.abs(ref).max())
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=1e-4 * scale)
        checked.append(teng.stats.steps)

    _lockstep(jeng, teng, _reqs(setup, "ref"), _reqs(setup, "port"),
              each_step)
    assert checked, "the campaign produced no SDC step to check"
    assert any(not e["state_match"] for e in teng.stats.injection_log
               if e["outcome"] == "sdc")


def test_noop_fault_is_masked_and_leaves_the_streams_clean(setup):
    """A fault aimed at a site the model does not have ("router") is a
    physical no-op: every injection is masked with matching cells, and the
    shadow runs' gather/scatter leaves the streams equal to the clean
    run's."""
    clean = _run(setup, "port", protect=False)
    runs = [_run(setup, pkg, protect=False,
                 fault_model=_fm(pkg, "transient", 0.5, sites=("router",)))
            for pkg in ("port", "ref")]
    got, ref = runs
    c = got["counters"]
    assert c["faults_injected"] > 0
    assert c["masked_faults"] == c["faults_injected"]
    assert all(e["state_match"] and e["tokens_match"] for e in got["log"])
    assert got["streams"] == clean["streams"] == ref["streams"]
    assert got["log"] == ref["log"]


def _escalation_view(tel):
    ev = tel.tracer.events
    return ([(e["args"]["level"], e["args"]["direction"]) for e in ev
             if e["name"] == "protection_escalation"],
            [(e["args"]["protection_level"], e["args"]["layer"],
              e["args"]["scheme"]) for e in ev if e["name"] == "plan_row"])


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_adaptive_escalation_matches_reference(setup, cache):
    recs, views = [], []
    for pkg, tel in (("port", EngineTelemetry(trace=True)),
                     ("ref", JTelemetry(trace=True))):
        fm = _fm(pkg, "transient", 0.3)
        eng = _engine(setup, pkg, cache=cache, adaptive=True,
                      fault_model=fm, telemetry=tel)
        recs.append(_record(eng, eng.run(_reqs(setup, pkg)), fm))
        views.append(_escalation_view(tel))
    got, ref = recs
    assert got["counters"]["protection_escalations"] >= 1
    assert got["trace"] == ref["trace"]          # escalation steps
    assert views[0] == views[1]                  # plan_row levels
    assert got["log"] == ref["log"]
    assert got["counters"] == ref["counters"]
    assert got["streams"] == ref["streams"]
    assert {e["scheme"] for e in got["trace"]} == {"block_1s", "global"}


def test_adaptive_quiet_regime_equals_base_policy(setup):
    base = _run(setup, "port")
    quiet = _run(setup, "port", adaptive=True,
                 fault_model=FaultModel(transient_rate=0.0, seed=0))
    ref = _run(setup, "ref", adaptive=True,
               fault_model=JFaultModel(transient_rate=0.0, seed=0))
    assert quiet["streams"] == base["streams"] == ref["streams"]
    assert quiet["trace"] == base["trace"] == ref["trace"]
    assert quiet["counters"]["protection_escalations"] == 0


def test_adaptive_deescalation_resumes_the_base_level(setup):
    """One detected fault escalates (threshold 0.02 per step); the quiet
    steps after it de-escalate after ``deescalate_after`` = 4, at the same
    step as the reference's."""
    from repro.core import FaultSpec as JSpec
    from repro.models import ModelFault as JMF
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    traces = []
    for pkg, mf, spec in (("port", ModelFault, FaultSpec),
                          ("ref", JMF, JSpec)):
        eng = _engine(setup, pkg, adaptive=True)
        out = eng.run(_reqs(setup, pkg), fault_at=(
            2, mf.at(0, "mlp_up", spec.value(0, 5, MAG))))
        traces.append((out, eng.stats.selection_trace,
                       eng.stats.protection_escalations,
                       eng.stats.protection_deescalations,
                       eng.protection_level))
    assert traces[0] == traces[1]
    schemes = [e["scheme"] for e in traces[0][1]]
    assert traces[0][2] == traces[0][3] == 1 and traces[0][4] == 0
    assert "global" in schemes and schemes[-1] == "block_1s"


@pytest.mark.parametrize("kind", ["transient", "permanent"])
def test_bitflip_campaign_holds_the_invariants(setup, kind):
    """f32 exponent bit flips (no magnitude): outcomes are not compared
    with the reference one by one (see the module docstring); the port's
    campaign must account for every injection, replay from its seed, and
    never let a detected fault through."""
    runs = []
    for _ in range(2):
        fm = FaultModel(transient_rate=0.4 if kind == "transient" else 0.0,
                        permanent_rate=0.2 if kind == "permanent" else 0.0,
                        permanent_duration=3, seed=4, layers=2,
                        dtype=torch.float32)
        eng = _engine(setup, "port", fault_model=fm)
        runs.append(_record(eng, eng.run(_reqs(setup, "port")), fm))
    a, b = runs
    assert a == b                                  # replay
    c = a["counters"]
    assert c["faults_injected"] == len(a["log"]) > 0
    assert c["faults_injected"] == (c["faults_corrected"]
                                    + c["faults_uncorrected"]
                                    + c["sdc_faults"] + c["masked_faults"])
    assert c["faults_detected"] >= c["faults_corrected"] + \
        c["faults_uncorrected"]
    assert all(23 <= e["bit"] < 31 for e in a["log"])
    for e in a["log"]:
        if e["outcome"] in ("sdc", "masked"):
            assert e["tokens_match"] == (e["outcome"] == "masked")
