"""Protection plans for all ten configs: the port's host logic
(``models/counting.py``, ``ProtectionPlan.for_model``) against the
reference, string for string.

Grid: every config at its published dims, on ``TPU_V5E``, ``NVIDIA_T4``
and the H100 (the reference has no H100 spec, so it gets a
``HardwareSpec`` built from the port's ``NVIDIA_H100_SXM`` fields), for
``model_parallel`` in {1, 2, 4, 8} (per-shard dims) and a guided and a
fixed policy; each case walks decode at 4 tokens, prefill at 128 and at
2048, in bf16 and f32 operands.  Counts, FLOPs and intensities are
host arithmetic on the same integers: exact equality, no tolerance.
"""

import dataclasses

import pytest
import torch

from repro.configs import ALL_ARCHS as JARCHS, get_config as jget
from repro.core import hardware as jhw
from repro.core.policy import (
    FixedPolicy as JFixed,
    IntensityGuidedPolicy as JGuided,
    ProtectionPlan as JPlan,
)
from repro.core.schemes import Scheme as JScheme
from repro.models import counting as jcount
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import hardware as thw
from repro_torch.core.policy import (
    FixedPolicy,
    IntensityGuidedPolicy,
    ProtectionPlan,
)
from repro_torch.core.schemes import Scheme
from repro_torch.models import counting

torch.set_num_threads(1)

HW = {
    "tpu_v5e": (jhw.TPU_V5E, thw.TPU_V5E),
    "nvidia_t4": (jhw.NVIDIA_T4, thw.NVIDIA_T4),
    "h100": (jhw.HardwareSpec(**{
        f.name: getattr(thw.NVIDIA_H100_SXM, f.name)
        for f in dataclasses.fields(thw.NVIDIA_H100_SXM)}),
        thw.NVIDIA_H100_SXM),
}
PHASES = (("decode", 4), ("prefill", 128), ("prefill", 2048))


def _policies(kind):
    if kind == "guided":
        return IntensityGuidedPolicy(), JGuided()
    return FixedPolicy(Scheme.BLOCK_1S), JFixed(JScheme.BLOCK_1S)


def test_registry_matches_reference():
    assert ALL_ARCHS == JARCHS
    assert len(ALL_ARCHS) == 10


@pytest.mark.parametrize("arch", JARCHS)
def test_config_fields_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget(arch))


@pytest.mark.parametrize("kind", ["guided", "fixed"])
@pytest.mark.parametrize("mp", [1, 2, 4, 8])
@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("arch", JARCHS)
def test_plan_json_is_string_equal_to_reference(arch, hw, mp, kind):
    jh, th = HW[hw]
    tpol, jpol = _policies(kind)
    for phase, n in PHASES:
        for db in (2, 4):
            kw = dict(phase=phase, n_tokens=n, dtype_bytes=db,
                      model_parallel=mp)
            want = JPlan.for_model(jget(arch), hw=jh, policy=jpol, **kw)
            got = ProtectionPlan.for_model(get_config(arch), hw=th,
                                           policy=tpol, **kw)
            assert got.to_json() == want.to_json(), (phase, n, db)
            assert got.model_parallel == want.model_parallel == mp
            assert ProtectionPlan.from_json(got.to_json()).to_json() == \
                got.to_json()


@pytest.mark.parametrize("arch", JARCHS)
def test_counts_flops_and_intensity_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for active in (False, True):
        assert counting.count_params(cfg, active_only=active) == \
            jcount.count_params(jcfg, active_only=active)
    assert cfg.param_count() == jcfg.param_count()
    for n, training in ((1, False), (4096, True)):
        assert counting.model_flops(cfg, n, training) == \
            jcount.model_flops(jcfg, n, training)
    for phase, n in PHASES:
        assert counting.aggregate_ai(cfg, n, phase) == \
            jcount.aggregate_ai(jcfg, n, phase)


@pytest.mark.parametrize("mp", [1, 2, 8])
@pytest.mark.parametrize("arch", JARCHS)
def test_layer_specs_and_first_flag_match_reference(arch, mp):
    cfg, jcfg = get_config(arch), jget(arch)
    got = counting.layer_specs(cfg, 128, model_parallel=mp)
    want = jcount.layer_specs(jcfg, 128, model_parallel=mp)
    assert [(s.name, s.count, s.first, dataclasses.astuple(s.dims))
            for s in got] == \
        [(s.name, s.count, s.first, dataclasses.astuple(s.dims))
         for s in want]
    # exactly one first flag, on the mixer projection of layer 0
    first = [s.name for s in got if s.first]
    assert first == [{"attn": "attn.q", "mla": "mla.q_a",
                      "mamba": "ssm.in_z"}[counting.layer_tags(cfg)[0]
                                           .split(":")[0]]]


def test_qwen1_5_32b_size():
    """qwen1.5-32b with MHA (kv = 40) and an untied head: 35.2e9
    parameters, ≈70.4 GB in bf16."""
    n = get_config("qwen1.5-32b").param_count()
    assert 35.1e9 < n < 35.3e9
