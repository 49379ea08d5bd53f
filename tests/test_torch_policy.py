"""Protection-plan parity: the port's copied cost model and policies make
the same selections as the reference for full-width llama3.2-1b on the
hardware specs both packages share (TPU_V5E, NVIDIA_T4), and the
analytic H100 selection the serving slice runs under."""

import dataclasses

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import hardware as jhw
from repro.core.policy import (
    FixedPolicy as JFixed,
    IntensityGuidedPolicy as JGuided,
    ProtectionPlan as JPlan,
)
from repro.core.schemes import Scheme as JScheme
from repro_torch.configs import get_config, scaled_down
from repro_torch.core import hardware as thw
from repro_torch.core.policy import (
    FixedPolicy,
    IntensityGuidedPolicy,
    ProtectionPlan,
)
from repro_torch.core.schemes import Scheme

torch.set_num_threads(1)

HW = [(jhw.TPU_V5E, thw.TPU_V5E), (jhw.NVIDIA_T4, thw.NVIDIA_T4)]
TOKENS = [1, 4, 16, 128, 512, 2048, 8192]


def test_shared_hardware_specs_are_verbatim_copies():
    for j, t in HW:
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("hw_idx", [0, 1])
@pytest.mark.parametrize("n_tokens", TOKENS)
def test_report_rows_match_reference(hw_idx, n_tokens):
    jh, th = HW[hw_idx]
    ref = JPlan.for_model(jax_config("llama3.2-1b"), hw=jh, policy=JGuided(),
                          phase="serve", n_tokens=n_tokens)
    got = ProtectionPlan.for_model(get_config("llama3.2-1b"), hw=th,
                                   policy=IntensityGuidedPolicy(),
                                   phase="serve", n_tokens=n_tokens)
    assert got.report_rows() == ref.report_rows()


@pytest.mark.parametrize("hw_idx", [0, 1])
def test_for_step_matches_reference(hw_idx):
    jh, th = HW[hw_idx]
    ref = JPlan.for_model(jax_config("llama3.2-1b"), hw=jh, policy=JGuided(),
                          phase="serve", n_tokens=4)
    got = ProtectionPlan.for_model(get_config("llama3.2-1b"), hw=th,
                                   policy=IntensityGuidedPolicy(),
                                   phase="serve", n_tokens=4)
    for d, p in [(4, 0), (0, 512), (4, 60), (1, 0), (0, 16384)]:
        a, b = ref.for_step(d, p), got.for_step(d, p)
        assert a.scheme_name == b.scheme_name
        assert a.arithmetic_intensity == b.arithmetic_intensity
        assert a.modeled_overhead_pct == b.modeled_overhead_pct


def test_fixed_policy_matches_reference():
    ref = JPlan.for_model(jax_config("llama3.2-1b"), hw=jhw.TPU_V5E,
                          policy=JFixed(JScheme.GLOBAL), n_tokens=8)
    got = ProtectionPlan.for_model(get_config("llama3.2-1b"),
                                   hw=thw.TPU_V5E,
                                   policy=FixedPolicy(Scheme.GLOBAL),
                                   n_tokens=8)
    assert got.report_rows() == ref.report_rows()


def test_h100_selects_block_1s_for_every_llama_gemm():
    """With data-sheet H100 numbers the copied (TPU-derived) cost model
    makes block_1s the cheapest scheme for every llama3.2-1b GEMM from 1
    to 16384 tokens a step, so ``global`` runs only when forced."""
    for n in [1, 4, 64, 512, 2048, 16384]:
        plan = ProtectionPlan.for_model(get_config("llama3.2-1b"),
                                        hw=thw.NVIDIA_H100_SXM, n_tokens=n)
        assert {r["scheme"] for r in plan.report_rows()} == {"block_1s"}
        assert plan.for_step(n).scheme_name == "block_1s"


def test_h100_is_the_default_and_cmr():
    assert thw.DEFAULT is thw.NVIDIA_H100_SXM
    assert thw.NVIDIA_H100_SXM.cmr == pytest.approx(989e12 / 3.35e12)
    assert thw.get_hardware("nvidia-h100-sxm") is thw.NVIDIA_H100_SXM


def test_unported_architectures_and_sharding_raise():
    """Plans are host logic for every config and mesh width; serving an
    unported architecture or a mesh raises."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("llama3.2-1b")
    assert ProtectionPlan.for_model(cfg, model_parallel=2).model_parallel \
        == 2
    mla = dataclasses.replace(scaled_down(cfg), attention="mla")
    assert ProtectionPlan.for_model(get_config("deepseek-v3-671b")).entries
    Model(get_config("mamba2-1.3b"))
    with pytest.raises(NotImplementedError):
        Model(mla)
    whisper = Model(scaled_down(get_config("whisper-tiny")))
    with pytest.raises(NotImplementedError, match="memory"):
        ServeEngine(whisper, whisper.init_params(0, dtype=torch.float32),
                    slots=1, max_len=16, dtype=torch.float32, device="cpu")
    small = Model(scaled_down(cfg))
    params = small.init_params(0, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        ServeEngine(small, params, slots=1, max_len=16, device="cpu",
                    mesh=2)
    with pytest.raises(KeyError):
        get_config("gpt-2")
