"""A mixed dense + MoE stack in the port against the reference, on the
CPU: ``scaled_down`` qwen2-moe-a2.7b with ``first_dense_layers=1`` at 13
layers, one dense layer and then 12 MoE layers.  No period of at most 12
layers repeats it, so the reference's ``seg_plan`` takes its case (b):
two segments, (dense x 1) and (moe x 12), each scanned with stacked
params.  ``params_from_reference`` carries the two-segment tree across;
the full forward, prefill and decode on the dense and the paged cache,
and the engine's greedy streams then agree with the reference's.

Tolerances as ``tests/test_torch_moe_model.py`` (f32, sums in another
order): logits within 1e-4 absolute and relative, ``aux_loss`` within
1e-5 relative; flags and greedy streams equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_moe_model import _ctxs, _prefill_decode, build_pair
import torch

from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)

OVER = dict(n_layers=13, first_dense_layers=1)


@pytest.fixture(scope="module")
def stack():
    return ("dense_then_moe",) + build_pair(**OVER)


def test_the_tree_has_two_segments_and_crosses_over(stack):
    _, jm, jp, tm, tp = stack
    assert [(s.unit, s.repeats) for s in tmodel.seg_plan(tm.cfg)] == [
        (("attn:dense:0",), 1), (("attn:moe:0",), 12)]
    assert len(jp["segments"]) == 2
    assert "up" in tp["layers"][0]["ffn"]
    assert all("router" in lp["ffn"] for lp in tp["layers"][1:])
    for r in (0, 5, 11):      # slice r of the MoE segment is layer 1 + r
        want = np.asarray(jp["segments"][1]["pos0"]["ffn"]["w_down"])[r]
        assert np.array_equal(tp["layers"][1 + r]["ffn"]["w_down"].numpy(),
                              want)


@pytest.mark.parametrize("fault", [None, (7, "expert_up")],
                         ids=["clean", "fault"])
def test_forward_matches_reference(stack, fault):
    _, jm, jp, tm, tp = stack
    toks = np.random.default_rng(3).integers(1, 256, size=(2, 16)).astype(
        np.int32)
    jctx, tctx = _ctxs(fault)
    jo = jm.forward(jp, {"tokens": jnp.asarray(toks)}, jctx)
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss),
                               rtol=1e-5)
    assert bool(to.flag) == bool(jo.flag) == (fault is not None)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_prefill_and_decode_match_reference(stack, kind):
    for phase, (jl, tl, jf, tf) in _prefill_decode(stack, kind).items():
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4,
                                   err_msg=phase)
        assert jf is False and tf is False, phase


def test_engine_streams_match_reference(stack):
    _, jm, jp, tm, tp = stack
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 20, size=3)]
    jeng = JEngine(jm, jp, slots=2, max_len=48, dtype=jnp.float32,
                   abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                          hardware=JTPU))
    teng = ServeEngine(tm, tp, slots=2, max_len=48, dtype=torch.float32,
                       device="cpu",
                       abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                   hardware=TPU_V5E))
    want = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    got = teng.run([Request(uid=i, prompt=p, max_new_tokens=4)
                    for i, p in enumerate(prompts)])
    assert got == want
    assert teng.stats.faults_detected == jeng.stats.faults_detected == 0
