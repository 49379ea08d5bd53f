"""Speculative decoding on MoE stacks against the reference's, on the CPU
in f32: qwen2-moe-a2.7b at ``scaled_down`` (2 MoE layers, 8 experts,
top 2, shared experts) and deepseek-v3-671b at ``scaled_down`` (one
``mla:dense`` and one ``mla:moe`` layer with the MTP head), params carried
across by ``params_from_reference``.

Under MoE the verify call's row count sets each expert's capacity, so the
port's engine verifies the reference's window: ``draft_len + 1`` tokens a
slot, token 0 in the padding and in inactive slots.  Exact against the
reference: every verify call's width, greedy streams, proposals and
acceptance, flags and every counter, the selection trace, and a verify
fault at an expert GEMM retried in its window.  The reference runs its
block schemes through the XLA emulation (``use_pallas=False``), the port
the K1 plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_mla_model import build_pair as mla_pair
from test_torch_moe_model import build_pair as moe_pair
import torch

from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import ModelFault as JMF
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import ModelFault
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

torch.set_num_threads(1)

COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "steps", "tokens", "draft_proposed", "draft_accepted",
            "verify_retries", "prefix_tokens_shared", "prefill_chunks")
BUILD = {"qwen2-moe-a2.7b": moe_pair, "deepseek-v3-671b": mla_pair}
RUNS = {
    "ngram_dense_k4": dict(spec_decode="ngram", draft_len=4),
    "ngram_paged_k3": dict(spec_decode="ngram", draft_len=3,
                           cache_kind="paged", block_size=4),
    "ngram_dense_auto": dict(spec_decode="ngram", draft_len="auto"),
    "expert_fault": dict(spec_decode="ngram", draft_len=4),
}
_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        _PAIRS[arch] = BUILD[arch]()
    return _PAIRS[arch]


def _prompts(seed=3):
    """Periodic prompts and prompts that repeat a random span: n-gram
    lookup proposes on both."""
    rng = np.random.default_rng(seed)
    out = [np.tile(3 + np.arange(4 + i % 2, dtype=np.int32), 16)[:21 + 2 * i]
           for i in range(2)]
    for n in (5, 9):
        span = rng.integers(1, 256, size=n)
        out.append(np.concatenate(
            [rng.integers(1, 256, size=4), span, rng.integers(1, 256, size=3),
             span]).astype(np.int32))
    return out


def _drive(arch, port, name):
    jm, jp, tm, tp = _pair(arch)
    kw = dict(slots=2, max_len=64, **RUNS[name])
    widths = []
    if port:
        eng = ServeEngine(tm, tp, abft=ABFTConfig.from_policy(
            IntensityGuidedPolicy(), hardware=TPU_V5E), dtype=torch.float32,
            device="cpu", policy=RecoveryPolicy(max_retries=1), **kw)
        for runner in eng._level_runners:
            inner = runner.verify

            def verify(p, toks, *a, _inner=inner):
                widths.append(tuple(toks.shape))
                return _inner(p, toks, *a)

            runner.verify = verify
    else:
        eng = JEngine(jm, jp, abft=JABFT.from_policy(
            JGuided(), use_pallas=False, hardware=JTPU), dtype=jnp.float32,
            policy=JRecovery(max_retries=1), **kw)
        inner = eng._verify

        def verify(p, toks, *a):
            widths.append(tuple(toks.shape))
            return inner(p, toks, *a)

        eng._verify = verify
    cls = Request if port else JRequest
    reqs = [cls(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), (10, 12, 11, 10)))]
    fault_at = None
    if name == "expert_fault":
        fault_at = (2, ModelFault.at(1, "expert_up",
                                     FaultSpec.value(0, 1, 1e5)) if port
                    else JMF.at(1, "expert_up", JFault.value(0, 1, 1e5)))
    out = eng.run(reqs, fault_at=fault_at)
    st = eng.stats
    return {"streams": {u: [int(t) for t in g] for u, g in out.items()},
            "errors": {r.uid: r.error for r in reqs if r.error},
            "counters": {k: getattr(st, k) for k in COUNTERS},
            "trace": st.selection_trace, "widths": widths,
            "draft_len": eng.draft_len}


@pytest.mark.parametrize("name", sorted(RUNS))
@pytest.mark.parametrize("arch", sorted(BUILD))
def test_moe_spec_engine_matches_reference(arch, name):
    got, ref = _drive(arch, True, name), _drive(arch, False, name)
    assert got["widths"] == ref["widths"], "verify window widths differ"
    assert got["streams"] == ref["streams"], "greedy streams differ"
    assert got["counters"] == ref["counters"], "counters differ"
    assert got["trace"] == ref["trace"]
    assert got["errors"] == ref["errors"] == {}
    assert got["draft_len"] == ref["draft_len"]
    c = got["counters"]
    assert 0 < c["draft_accepted"] <= c["draft_proposed"]
    # every window is the reference's draft_len + 1 wide, slots rows deep
    assert {w[0] for w in got["widths"]} == {2}
    if name != "ngram_dense_auto":
        assert {w[1] for w in got["widths"]} == {RUNS[name]["draft_len"]
                                                 + 1}
    if name == "expert_fault":
        assert c["faults_detected"] == c["verify_retries"] == 1
