"""Sampling of the port's serving engine (``temperature``/``top_k`` with
one ``torch.Generator`` per slot).  The reference draws through JAX's
PRNG, so the two packages cannot agree token for token: the port is held
to the reference's sampling contract in law only — greedy limits, seeded
replay, a retry redrawing the same token, slot independence, and a
chi-square test of the draws against ``softmax(logits / T)`` restricted
to the top k."""

import numpy as np
import pytest
import scipy.stats
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.runner import ModelRunner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 24, size=5)]
    return model, params, prompts


def _serve(small, *, fault_at=None, retries=1, prompts=None, slots=2,
           new_tokens=6, **kw):
    model, params, default = small
    eng = ServeEngine(model, params, slots=slots, max_len=64,
                      dtype=torch.float32, device="cpu",
                      policy=RecoveryPolicy(max_retries=retries), **kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts or default)]
    return eng.run(reqs, fault_at=fault_at), eng


def test_top_k_one_and_vanishing_temperature_equal_greedy(small):
    greedy, _ = _serve(small)
    assert _serve(small, temperature=0.9, top_k=1, seed=3)[0] == greedy
    assert _serve(small, temperature=1e-6, seed=4)[0] == greedy


def test_same_seed_replays_and_seeds_differ(small):
    a, _ = _serve(small, temperature=1.0, top_k=50, seed=0)
    b, _ = _serve(small, temperature=1.0, top_k=50, seed=0)
    c, _ = _serve(small, temperature=1.0, top_k=50, seed=1)
    assert a == b
    assert a != c
    assert all(0 <= t < 256 for s in a.values() for t in s)


@pytest.mark.parametrize("site", ["mlp_down", "qkv"])
def test_retry_redraws_the_same_token(small, site):
    """A detected fault is retried from the saved generator states: the
    streams and the generators end exactly as in the clean run."""
    clean, ce = _serve(small, temperature=0.8, top_k=20, seed=5)
    fault = ModelFault.at(1, site, FaultSpec.value(0, 3, 1e4))
    got, ge = _serve(small, temperature=0.8, top_k=20, seed=5,
                     fault_at=(2, fault))
    assert ge.stats.faults_detected == 1 and ge.stats.retries == 1
    assert got == clean
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(ce.generators, ge.generators))


def test_admission_retry_redraws_the_same_first_token(small):
    model, params, prompts = small
    outs = []
    for fault in (None, ModelFault.at(0, "attn_out",
                                      FaultSpec.value(0, 1, 1e4))):
        eng = ServeEngine(model, params, slots=2, max_len=64,
                          dtype=torch.float32, device="cpu",
                          temperature=0.8, top_k=20, seed=6)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        outs.append(eng.run(reqs, admit_fault_at=(
            None if fault is None else (0, fault))))
        assert eng.stats.retries == (fault is not None)
    assert outs[0] == outs[1]


def test_hard_fault_does_not_advance_the_generators(small):
    """A decode hard fault evicts its victims without consuming their
    draws: the slots' generators are left where the failed step began."""
    model, params, prompts = small
    eng = ServeEngine(model, params, slots=2, max_len=64,
                      dtype=torch.float32, device="cpu", temperature=0.8,
                      seed=7, policy=RecoveryPolicy(max_retries=0))
    pending = [Request(uid=i, prompt=p, max_new_tokens=6)
               for i, p in enumerate(prompts[:2])]
    eng.admit(pending)
    before = [g.get_state() for g in eng.generators]
    out = eng.step(ModelFault.at(0, "mlp_up", FaultSpec.value(0, 0, 1e4)))
    assert out == {} and eng.stats.hard_faults == 1
    assert all(torch.equal(a, g.get_state())
               for a, g in zip(before, eng.generators))


def test_a_slots_draws_depend_only_on_its_own_steps(small):
    """Request 0 in slot 0 draws the same stream whether slot 1 idles or
    serves another request of the same length (inactive slots never
    advance, and an active neighbour has its own generator)."""
    p = small[2][0]
    alone, _ = _serve(small, temperature=1.0, seed=9, prompts=[p])
    other = np.roll(p, 1)
    both, _ = _serve(small, temperature=1.0, seed=9, prompts=[p, other])
    assert alone[0] == both[0]


def test_draws_follow_the_top_k_softmax_in_law():
    """Chi-square goodness of fit of 20000 draws from one row against
    ``softmax(logits / T)`` over its top k, at significance 0.001 (the
    test fails on a sound sampler once in a thousand seeds; this seed is
    fixed, so the verdict is reproducible).  Tokens outside the top k
    must never be drawn."""
    V, T, K, N = 64, 0.7, 12, 20000
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, V)).astype(np.float32)
        * 2.0)
    runner = ModelRunner(model=None, ctx=LayerCtx(), temperature=T,
                         top_k=K)
    g = torch.Generator().manual_seed(123)
    draws = runner.sample(logits.expand(N, V), [g] * N).numpy()
    top = torch.topk(logits[0], K).indices.numpy()
    assert set(np.unique(draws)) <= set(top.tolist())
    p = torch.softmax(logits[0, top] / T, dim=0).double().numpy()
    counts = np.bincount(draws, minlength=V)[top]
    stat, pvalue = scipy.stats.chisquare(counts, p / p.sum() * N)
    assert pvalue > 1e-3, (stat, pvalue)
    # and the greedy limit of the same sampler
    greedy = ModelRunner(None, LayerCtx()).sample(logits, None)
    assert int(greedy[0]) == int(torch.argmax(logits[0]))


def test_top_k_larger_than_vocab_is_no_cutoff():
    logits = torch.tensor([[0.0, 1.0, 2.0]])
    runner = ModelRunner(None, LayerCtx(), temperature=1.0, top_k=1000)
    g = torch.Generator().manual_seed(0)
    draws = runner.sample(logits.expand(3000, 3), [g] * 3000)
    assert set(draws.tolist()) == {0, 1, 2}
    masked = runner.sample(logits.expand(2, 3), [g, None])
    assert int(masked[1]) == -1
