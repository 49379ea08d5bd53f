"""Serving-engine parity: the port's ``ServeEngine`` against the
reference ``ServeEngine`` on scaled-down llama3.2-1b (2 layers, f32, the
reference's parameters through numpy), mixed-length requests.  The
reference runs as its own tests run it on the CPU: ``use_pallas=False``.

Greedy streams, ``faults_detected``/``retries``/``hard_faults``/
``evictions`` and the per-step ``selection_trace`` must be EQUAL, under
the same ``fault_at`` / ``admit_fault_at`` and the same HardwareSpec.

Mirrored caveat (global scheme): ``global_row_check`` ignores
``c_factor`` and uses the default c=16, as the reference does
(``repro/core/checksums.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import (
    FixedPolicy as JFixed,
    IntensityGuidedPolicy as JGuided,
)
from repro.core.protected import ABFTConfig as JABFT
from repro.core.schemes import Scheme as JScheme
from repro.models import ModelFault as JMF, build_model
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import Scheme
from repro_torch.models.layers import ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve import executor
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

torch.set_num_threads(1)

COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "rejections", "steps", "tokens")
# name: (policy, flash, cache, max_retries, fault_at step, admit fault uid)
SCENARIOS = {
    "clean": ("guided", False, "dense", 1, None, None),
    "decode_fault": ("guided", False, "dense", 1, 2, None),
    "decode_evict": ("guided", False, "dense", 0, 2, None),
    "prefill_evict": ("guided", False, "dense", 0, None, 1),
    "global_fault": ("global", False, "dense", 1, 2, None),
    "paged_flash_fault": ("guided", True, "paged", 1, 3, None),
}


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


def _run_ref(setup, name):
    jm, jp, _, _, prompts = setup
    pol, flash, cache, retries, fat, auid = SCENARIOS[name]
    policy = JGuided() if pol == "guided" else JFixed(JScheme.GLOBAL)
    eng = JEngine(jm, jp, slots=2, max_len=64,
                  abft=JABFT.from_policy(policy, use_pallas=False,
                                         hardware=JTPU,
                                         flash_attention=flash),
                  dtype=jnp.float32, cache_kind=cache,
                  policy=JRecovery(max_retries=retries))
    fault = JMF.at(0, "mlp_down", JFault.value(0, 1, 1e5))
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    out = eng.run(reqs, fault_at=None if fat is None else (fat, fault),
                  admit_fault_at=None if auid is None else (auid, fault))
    return out, {k: getattr(eng.stats, k) for k in COUNTERS}, \
        eng.stats.selection_trace, {r.uid: r.error for r in reqs}


def _run_port(setup, name, cache=None):
    _, _, tm, tp, prompts = setup
    pol, flash, kind, retries, fat, auid = SCENARIOS[name]
    policy = IntensityGuidedPolicy() if pol == "guided" \
        else FixedPolicy(Scheme.GLOBAL)
    eng = ServeEngine(tm, tp, slots=2, max_len=64,
                      abft=ABFTConfig.from_policy(policy, hardware=TPU_V5E,
                                                  flash_attention=flash),
                      dtype=torch.float32, device="cpu",
                      cache_kind=cache or kind,
                      policy=RecoveryPolicy(max_retries=retries))
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    out = eng.run(reqs, fault_at=None if fat is None else (fat, fault),
                  admit_fault_at=None if auid is None else (auid, fault))
    return out, {k: getattr(eng.stats, k) for k in COUNTERS}, \
        eng.stats.selection_trace, {r.uid: r.error for r in reqs}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_streams_counters_and_trace_match_reference(setup, name):
    ref, got = _run_ref(setup, name), _run_port(setup, name)
    assert got[0] == ref[0], "greedy streams differ"
    assert got[1] == ref[1], "engine counters differ"
    assert got[2] == ref[2], "selection traces differ"
    assert got[3] == ref[3], "per-request errors differ"


def test_fault_runs_recover_or_evict_as_expected(setup):
    clean = _run_port(setup, "clean")
    fixed = _run_port(setup, "decode_fault")
    assert fixed[1]["faults_detected"] == 1 and fixed[1]["retries"] == 1
    assert fixed[0] == clean[0]        # in-place retry rewrote every cell
    evict = _run_port(setup, "decode_evict")
    assert evict[1]["hard_faults"] == 1 and evict[1]["evictions"] >= 1
    assert "hard_fault:decode" in evict[3].values()
    pre = _run_port(setup, "prefill_evict")
    assert pre[3][1] == "hard_fault:prefill"


@pytest.mark.parametrize("name", ["clean", "decode_fault"])
def test_paged_streams_equal_dense_streams(setup, name):
    dense = _run_port(setup, name, cache="dense")
    paged = _run_port(setup, name, cache="paged")
    assert paged[0] == dense[0] and paged[1] == dense[1]


def test_entry_points_need_cuda_or_an_explicit_cpu(setup, monkeypatch):
    _, _, tm, tp, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServeEngine(tm, tp, slots=1, max_len=16)
    with pytest.raises(RuntimeError):
        executor.resolve_device("cuda")
    assert executor.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("opt", [dict(chunk_tokens="auto"),
                                 dict(chunk_tokens=8),
                                 dict(prefix_sharing=True),
                                 dict(spec_decode="ngram"), dict(mesh=2),
                                 dict(spec_decode="self_draft"),
                                 dict(prefix_sharing=True,
                                      cache_kind="paged")])
def test_unported_options_raise(setup, opt):
    """``mesh`` is not ported and raises ``NotImplementedError``.  Chunked
    prefill, paged prefix sharing and speculative decoding (both
    proposers) are ported, construct and serve; dense prefix sharing
    raises the reference's ``ValueError``.  Speculative decoding on a
    stack with MoE layers is not ported and raises
    ``NotImplementedError``."""
    _, _, tm, tp, _ = setup

    def make():
        return ServeEngine(tm, tp, slots=1, max_len=16, device="cpu", **opt)

    if "spec_decode" in opt:
        moe = Model(scaled_down(get_config("qwen2-moe-a2.7b")))
        with pytest.raises(NotImplementedError, match="MoE"):
            ServeEngine(moe, moe.init_params(0, dtype=torch.float32),
                        slots=1, max_len=16, device="cpu", **opt)

    if "mesh" in opt:
        with pytest.raises(NotImplementedError):
            make()
    elif opt.get("prefix_sharing") and opt.get("cache_kind") != "paged":
        with pytest.raises(ValueError, match="requires cache_kind='paged'"):
            make()
    else:
        eng = make()
        assert eng.run([Request(uid=0, prompt=np.arange(1, 4),
                                max_new_tokens=2)])[0]


def test_ported_options_construct(setup):
    """Sampling, telemetry, fault campaigns and the profile-guided and
    error-adaptive policies no longer raise."""
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.policy import (
        ErrorAdaptivePolicy,
        ProfileGuidedPolicy,
    )
    from repro_torch.obs import EngineTelemetry

    _, _, tm, tp, _ = setup
    for opt in (dict(temperature=0.7, top_k=5),
                dict(telemetry=EngineTelemetry()),
                dict(fault_model=FaultModel(transient_rate=0.1)),
                dict(abft=ABFTConfig(policy=ProfileGuidedPolicy())),
                dict(abft=ABFTConfig(policy=ErrorAdaptivePolicy()))):
        eng = ServeEngine(tm, tp, slots=1, max_len=16, device="cpu", **opt)
        assert eng.run([Request(uid=0, prompt=np.arange(1, 4),
                                max_new_tokens=2)])[0]


def test_cache_stats_and_prompt_too_long(setup):
    _, _, tm, tp, _ = setup
    eng = ServeEngine(tm, tp, slots=2, max_len=32, dtype=torch.float32,
                      device="cpu", cache_kind="paged", block_size=8)
    big = Request(uid=0, prompt=np.arange(1, 31, dtype=np.int32),
                  max_new_tokens=8)
    ok = Request(uid=1, prompt=np.arange(1, 6, dtype=np.int32),
                 max_new_tokens=3)
    res = eng.run([big, ok])
    assert big.error == "prompt_too_long" and eng.stats.rejections == 1
    assert len(res[1]) == 3
    st = eng.cache_stats()
    assert st["kind"] == "paged" and st["blocks_used"] == 0
    # layers x {k, v} x blocks x block_size x kv heads x head_dim x f32
    assert st["bytes_total"] == 2 * 2 * 8 * 8 * 2 * 16 * 4
    eng.pool.check_invariants()


def test_config_dataclass_has_no_pallas_switch():
    fields = {f.name for f in dataclasses.fields(ABFTConfig)}
    assert "use_pallas" not in fields
    assert {"policy", "hardware", "blocks", "c_factor",
            "flash_attention"} <= fields


def test_stats_setter_resets_the_counters_as_the_reference(setup):
    """``eng.stats = EngineStats()`` (the serve sweep's reset after its
    warm-up) replaces the scheduler's stats on both engines; the second
    run's counters and selection trace are then equal."""
    from repro.serve.scheduler import EngineStats as JStats
    from repro_torch.serve.scheduler import EngineStats

    jm, jp, tm, tp, prompts = setup
    jeng = JEngine(jm, jp, slots=2, max_len=64,
                   abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                          hardware=JTPU),
                   dtype=jnp.float32)
    teng = ServeEngine(tm, tp, slots=2, max_len=64,
                       abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                   hardware=TPU_V5E),
                       dtype=torch.float32, device="cpu")
    for eng, req, fresh in ((jeng, JRequest, JStats),
                            (teng, Request, EngineStats)):
        eng.run([req(uid=0, prompt=prompts[0], max_new_tokens=3)])
        assert eng.stats.tokens == 3
        new = fresh()
        eng.stats = new
        assert eng.stats is new and eng.scheduler.stats is new
        eng.run([req(uid=i, prompt=p, max_new_tokens=4)
                 for i, p in enumerate(prompts[1:])])
    assert {k: getattr(teng.stats, k) for k in COUNTERS} == \
        {k: getattr(jeng.stats, k) for k in COUNTERS}
    assert teng.stats.selection_trace == jeng.stats.selection_trace
    assert teng.stats.tokens == 4 * (len(prompts) - 1)


@pytest.mark.parametrize("opt", [dict(hints={"dp": 1}), dict(draft_len=4),
                                 dict(draft_len="auto"),
                                 dict(draft_window=4), dict(draft_units=2),
                                 dict(mesh=2)])
def test_reference_options_raise_not_implemented(setup, opt):
    """Of the reference's options, sharding (``mesh``) and ``hints`` are
    refused with NotImplementedError (not a TypeError).  The draft options
    construct wherever the reference's do: without ``spec_decode`` both
    engines accept and ignore them.  The defaults construct."""
    jm, jp, tm, tp, _ = setup
    if "hints" in opt or "mesh" in opt:
        with pytest.raises(NotImplementedError):
            ServeEngine(tm, tp, slots=1, max_len=16, device="cpu", **opt)
    else:
        jeng = JEngine(jm, jp, slots=1, max_len=16, dtype=jnp.float32, **opt)
        teng = ServeEngine(tm, tp, slots=1, max_len=16, device="cpu", **opt)
        assert jeng.spec is None and teng.spec is None
        assert teng.draft_len == jeng.draft_len == 0
    ServeEngine(tm, tp, slots=1, max_len=16, device="cpu", hints=None,
                mesh=None, draft_len=None, draft_window=8, draft_units=1)
