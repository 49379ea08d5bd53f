"""Plan/policy serialization, the profile-guided and error-adaptive
policies and the legacy selector facade of the port against the
reference.  Everything compared here is host logic over the same copied
cost model, so every comparison is EXACT: plan JSON string for string,
validation messages, adaptive decisions and selections."""

import dataclasses
import json

import pytest
import torch

from repro.configs import get_config as jget
from repro.core import hardware as jhw
from repro.core import selector as jsel
from repro.core.intensity import GemmDims as JDims
from repro.core.policy import (
    ErrorAdaptivePolicy as JAdaptive,
    FixedPolicy as JFixed,
    IntensityGuidedPolicy as JGuided,
    PlanValidationError as JPlanError,
    ProfileGuidedPolicy as JProfile,
    ProtectionPlan as JPlan,
    policy_from_json as jpolicy_from_json,
    policy_from_selector as jpolicy_from_selector,
    validate_plan_payload as jvalidate,
)
from repro.core.schemes import BlockShape as JBlocks, Scheme as JScheme
from repro_torch.configs import get_config
from repro_torch.core import hardware as thw
from repro_torch.core import selector
from repro_torch.core.intensity import GemmDims
from repro_torch.core.policy import (
    ErrorAdaptivePolicy,
    FixedPolicy,
    IntensityGuidedPolicy,
    PlanValidationError,
    ProfileGuidedPolicy,
    ProtectionPlan,
    policy_from_json,
    policy_from_selector,
    validate_plan_payload,
)
from repro_torch.core.schemes import BlockShape, Scheme

torch.set_num_threads(1)

HW = {"tpu_v5e": (jhw.TPU_V5E, thw.TPU_V5E),
      "nvidia_t4": (jhw.NVIDIA_T4, thw.NVIDIA_T4)}
# the profile table both packages get: decode-sized attention GEMMs on
# global, everything else from the table or the analytic fallback
TABLE = [((4, 2048, 2048), "global"), ((4, 2048, 512), "global"),
         ((128, 8192, 2048), "block_1s"), ((2048, 2048, 128256), "global")]


def _policies(kind):
    """(port policy, reference policy) of one kind."""
    if kind == "fixed":
        return FixedPolicy(Scheme.GLOBAL), JFixed(JScheme.GLOBAL)
    if kind == "intensity":
        return (IntensityGuidedPolicy(candidates=("block_1s", "global")),
                JGuided(candidates=("block_1s", "global")))
    if kind == "profile":
        return (ProfileGuidedPolicy(
                    table=[(GemmDims(m=m, k=k, n=n), s)
                           for (m, k, n), s in TABLE]),
                JProfile(table=[(JDims(m=m, k=k, n=n), s)
                                for (m, k, n), s in TABLE]))
    return (ErrorAdaptivePolicy(IntensityGuidedPolicy(),
                                detection_threshold=0.02,
                                deescalate_after=4, shrink_chunk=0.5),
            JAdaptive(JGuided(), detection_threshold=0.02,
                      deescalate_after=4, shrink_chunk=0.5))


KINDS = ("fixed", "intensity", "profile", "adaptive")


def _plans(kind, hw, n_tokens):
    tp, jp = _policies(kind)
    jh, th = HW[hw]
    ref = JPlan.for_model(jget("llama3.2-1b"), hw=jh, policy=jp,
                          phase="serve", n_tokens=n_tokens)
    got = ProtectionPlan.for_model(get_config("llama3.2-1b"), hw=th,
                                   policy=tp, phase="serve",
                                   n_tokens=n_tokens)
    return got, ref


@pytest.mark.parametrize("n_tokens", [4, 128, 2048])
@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("kind", KINDS)
def test_plan_json_is_string_equal_to_reference(kind, hw, n_tokens):
    got, ref = _plans(kind, hw, n_tokens)
    assert got.to_json() == ref.to_json()
    assert got.to_json(indent=None) == ref.to_json(indent=None)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_from_json_round_trips(kind):
    got, ref = _plans(kind, "nvidia_t4", 4)
    s = got.to_json()
    back = ProtectionPlan.from_json(s)
    assert back.to_json() == s
    # a reference-written artifact loads into the port unchanged
    assert ProtectionPlan.from_json(ref.to_json()).to_json() == s
    assert [e.selection.scheme_name for e in back.entries] == \
        [e.selection.scheme_name for e in got.entries]
    assert back.policy.to_json() == got.policy.to_json()
    assert policy_from_json(got.policy.to_json()).to_json() == \
        jpolicy_from_json(ref.policy.to_json()).to_json()


@pytest.mark.parametrize("tokens", [1, 4, 60, 512, 4096])
def test_step_intensity_and_modeled_step_time_match(tokens):
    got, ref = _plans("intensity", "tpu_v5e", 4)
    assert got.step_intensity(tokens) == ref.step_intensity(tokens)
    assert got.modeled_step_time(tokens) == ref.modeled_step_time(tokens)


def _mutations():
    """Malformed payloads, each a function of a valid plan payload."""
    def unknown_scheme(d):
        d["layers"][0]["scheme"] = "bogus"

    def duplicate(d):
        d["layers"][1]["name"] = d["layers"][0]["name"]

    def stale_dims(d):
        d["layers"][2]["dims"]["m"] = 0
        d["layers"][3]["dims"]["k"] = "x"

    def bad_count(d):
        d["layers"][0]["count"] = 0

    def policy_scheme(d):
        d["policy"] = {"kind": "fixed", "scheme": "nope"}

    def nested(d):
        d["policy"] = {"kind": "adaptive",
                       "base": {"kind": "intensity",
                                "candidates": ["block_1s", "x"]},
                       "escalated": {"kind": "profile", "table": [
                           {"dims": {}, "scheme": "y"}],
                           "fallback": {"kind": "fixed", "scheme": "z"}}}

    def everything(d):
        for f in (unknown_scheme, duplicate, stale_dims, bad_count,
                  policy_scheme):
            f(d)
    return [unknown_scheme, duplicate, stale_dims, bad_count,
            policy_scheme, nested, everything]


@pytest.mark.parametrize("mutate", _mutations(),
                         ids=lambda f: f.__name__)
def test_validate_plan_payload_rejects_like_reference(mutate):
    got, ref = _plans("intensity", "tpu_v5e", 4)
    dg, dr = json.loads(got.to_json()), json.loads(ref.to_json())
    validate_plan_payload(dg)          # valid before the mutation
    mutate(dg)
    mutate(dr)
    with pytest.raises(JPlanError) as je:
        jvalidate(dr)
    with pytest.raises(PlanValidationError) as te:
        validate_plan_payload(dg)
    assert str(te.value) == str(je.value)
    with pytest.raises(PlanValidationError):
        ProtectionPlan.from_json(dg)


def test_error_adaptive_update_matches_reference_decisions():
    """One recorded snapshot sequence (quiet, dead band, hot, cool
    streaks, hard faults, EWMA-only heat) gives the same level changes."""
    seq = ([{"window_detection_rate": 0.0}] * 3
           + [{"window_detection_rate": 0.03}]            # dead band
           + [{"window_detection_rate": 0.06}]            # hot
           + [{"window_detection_rate": 0.03}] * 3        # dead band
           + [{"window_detection_rate": 0.0}] * 5         # cool streak
           + [{"window_hard_fault_rate": 0.02}]           # hard faults
           + [{"window_detection_rate": 0.01}] * 4
           + [{"ewma_detections_per_step": 0.08}]         # EWMA heat
           + [{}] * 6)
    for kw in (dict(), dict(detection_threshold=0.05, deescalate_after=4),
               dict(clear_factor=1.0, deescalate_after=1)):
        tp, jp = ErrorAdaptivePolicy(**kw), JAdaptive(**kw)
        got = [(tp.update(s), tp.level) for s in seq]
        ref = [(jp.update(s), jp.level) for s in seq]
        assert got == ref
        assert (tp.escalations, tp.deescalations) == \
            (jp.escalations, jp.deescalations)
        assert tp.to_json() == jp.to_json()


def test_error_adaptive_validation_matches_reference():
    for bad in (dict(clear_factor=0.0), dict(deescalate_after=0),
                dict(shrink_chunk=1.5), dict(shrink_draft=0.0)):
        with pytest.raises(ValueError):
            JAdaptive(**bad)
        with pytest.raises(ValueError):
            ErrorAdaptivePolicy(**bad)


SELECTOR_CONFIGS = [
    ("analytic", {}), ("fixed", {"fixed_scheme": "global"}),
    ("profile", {}), ("analytic", {"candidates": ("block_1s",)}),
    ("analytic", {"blocks": (128, 256, 128)}),
]


def _selector_configs(mode, extra):
    tk, jk = {}, {}
    if "fixed_scheme" in extra:
        tk["fixed_scheme"] = Scheme(extra["fixed_scheme"])
        jk["fixed_scheme"] = JScheme(extra["fixed_scheme"])
    if "candidates" in extra:
        tk["candidates"] = jk["candidates"] = extra["candidates"]
    if "blocks" in extra:
        tk["blocks"] = BlockShape(*extra["blocks"])
        jk["blocks"] = JBlocks(*extra["blocks"])
    return (selector.SelectorConfig(mode=mode, **tk),
            jsel.SelectorConfig(mode=mode, **jk))


@pytest.mark.parametrize("mode,extra", SELECTOR_CONFIGS)
@pytest.mark.parametrize("hw", sorted(HW))
def test_selector_facade_matches_reference(mode, extra, hw):
    tc, jc = _selector_configs(mode, extra)
    jh, th = HW[hw]
    dims = [(1, 2048, 8192), (4, 2048, 512), (512, 8192, 2048),
            (4096, 2048, 2048), (8, 64, 64)]
    ttable = {GemmDims(m=4, k=2048, n=512): Scheme.GLOBAL}
    jtable = {JDims(m=4, k=2048, n=512): JScheme.GLOBAL}
    for m, k, n in dims:
        for first in (False, True):
            a = selector.select_scheme(GemmDims(m=m, k=k, n=n), th, tc,
                                       profile_table=ttable,
                                       first_layer=first)
            b = jsel.select_scheme(JDims(m=m, k=k, n=n), jh, jc,
                                   profile_table=jtable, first_layer=first)
            assert a.scheme_name == b.scheme_name
            assert a.modeled_overhead_pct == b.modeled_overhead_pct
            assert (a.arithmetic_intensity, a.cmr, a.reason) == \
                (b.arithmetic_intensity, b.cmr, b.reason)
        for sc in ("global", "block_1s", "none"):
            assert selector.modeled_layer_time(
                GemmDims(m=m, k=k, n=n), Scheme(sc), th) == \
                jsel.modeled_layer_time(JDims(m=m, k=k, n=n), JScheme(sc),
                                        jh)
    rows_t = selector.selection_report(
        {f"l{i}": GemmDims(m=m, k=k, n=n)
         for i, (m, k, n) in enumerate(dims)}, th, tc)
    rows_j = jsel.selection_report(
        {f"l{i}": JDims(m=m, k=k, n=n) for i, (m, k, n) in enumerate(dims)},
        jh, jc)
    assert rows_t == rows_j
    assert policy_from_selector(tc).to_json() == \
        jpolicy_from_selector(jc).to_json()


def test_registry_names_and_json_field_sets():
    from repro.core.policy import default_registry as jreg
    from repro_torch.core.policy import default_registry

    assert default_registry().names() == jreg().names()
    assert "global" in default_registry()
    assert {f.name for f in dataclasses.fields(ProfileGuidedPolicy)} == \
        {"table", "fallback"}


def test_profiler_plumbing_on_the_cpu():
    """``build_profile_table`` on the CPU (plain versions timed with
    ``perf_counter``: the ranking means nothing for the card): every
    shape gets a measured time per candidate and its fastest scheme, and
    the policy built from it serializes like the reference's policy over
    the same table."""
    from repro_torch.core import profiler

    dims = [GemmDims(m=4, k=64, n=32), GemmDims(m=16, k=32, n=48,
                                                 out_dtype_bytes=4)]
    times = {}
    table = profiler.build_profile_table(dims, times=times, device="cpu",
                                         dtype=torch.float32, warmup=1)
    assert set(table) == set(times) == set(dims)
    for d in dims:
        assert set(times[d]) == set(profiler.DEFAULT_CANDIDATES)
        assert all(t > 0 for t in times[d].values())
        assert table[d] == min(times[d], key=times[d].get)
    pol = profiler.build_profile_policy(dims, device="cpu", warmup=1)
    assert isinstance(pol, ProfileGuidedPolicy)
    for d in dims:
        assert pol.select(d).reason == "empirical profile table"
    ref = JProfile(table=[(JDims(**dataclasses.asdict(d)), s)
                          for d, s in pol.table])
    assert pol.to_json() == ref.to_json()
    with pytest.raises(ValueError):
        profiler.profile_layer(dims[0], device="cpu", iters=4)
