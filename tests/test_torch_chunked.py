"""Chunked prefill and prefix sharing in the port's ``ServeEngine`` against
the reference's, on scaled-down llama3.2-1b and the dense family
(qwen3-14b, stablelm-1.6b, qwen1.5-32b) with 2 layers, f32, the
reference's parameters through numpy.  The reference runs as its own
tests run it on the CPU (``use_pallas=False``).

Both engines are driven through the same admit/step loop (``run()``'s)
with the same traffic: prompts that open with one shared system prefix,
two identical prompts (the copy-on-write of a shared tail), and late
long prompts.  After every iteration the block tables, refcounts and
cursors must be EQUAL, and at the end the greedy streams, the errors,
every ``EngineStats`` counter and the ``selection_trace``.  Exact: this
is host logic, and greedy tokens and ABFT flags agree exactly on short
streams (ROADMAP, "a slice is done").

The port's own chunked and shared streams must also equal its unchunked,
unshared streams, and the KV cells a chunked or shared prefill writes
must equal, bit for bit, the cells the whole-prompt prefill writes
(``chunked_attention(spans=...)``; the plain K1 on the CPU is one
product whatever M).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_shared_runners import shared_runners
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import ModelFault as JMF, build_model
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.scheduler import EngineStats

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``); the port's shared runs are dropped
    with the module."""
    with shared_runners():
        yield
    _PORT_RUNS.clear()


ARCHS = ("llama3.2-1b", "qwen3-14b", "stablelm-1.6b", "qwen1.5-32b")
SLOTS, MAX_LEN, BLOCK = 3, 64, 4
# every int counter of EngineStats (the selection trace is compared apart)
COUNTERS = tuple(f for f, v in EngineStats().__dict__.items()
                 if isinstance(v, int))
# name: (cache, chunk_tokens, prefix_sharing, max_retries, fault step,
#        fault site)
SCENARIOS = {
    "paged": ("paged", None, False, 1, None, None),
    "chunk_dense": ("dense", 8, False, 1, None, None),
    "chunk_paged_odd": ("paged", 5, False, 1, None, None),
    "chunk_auto": ("paged", "auto", False, 1, None, None),
    "share": ("paged", None, True, 1, None, None),
    "share_chunk": ("paged", 8, True, 1, None, None),
    "chunk_fault": ("paged", 8, True, 1, 1, "mlp_down"),
    "chunk_evict": ("paged", 8, True, 0, 1, "mlp_down"),
    "share_decode_evict": ("paged", None, True, 0, 4, "mlp_down"),
}


def _traffic(seed=3):
    """(prompts, budgets): three prompts open with one 9-token system
    prefix (the first stays resident longest), then a long one; the late
    pair is a copy of the first prompt (arriving while it is resident:
    its last block is shared, then copied on write) and a second long
    prompt."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 256, size=9)
    prompts = [np.concatenate([sys_p, rng.integers(1, 256, size=int(n))])
               for n in (3, 6, 2)]
    prompts += [rng.integers(1, 256, size=27), prompts[0].copy(),
                rng.integers(1, 256, size=21)]
    return [p.astype(np.int32) for p in prompts], (16, 3, 5, 5, 5, 5)


def _setup(arch):
    jcfg = jscaled(jget(arch), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config(arch), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module")
def models():
    return {a: _setup(a) for a in ARCHS}


def _engine(port: bool, m, p, cache, chunk, share, retries):
    kw = dict(slots=SLOTS, max_len=MAX_LEN, cache_kind=cache,
              block_size=BLOCK, chunk_tokens=chunk, prefix_sharing=share)
    if port:
        return ServeEngine(
            m, p, abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                              hardware=TPU_V5E),
            dtype=torch.float32, device="cpu",
            policy=RecoveryPolicy(max_retries=retries), **kw)
    return JEngine(m, p, abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                                hardware=JTPU),
                   dtype=jnp.float32, policy=JRecovery(max_retries=retries),
                   **kw)


# the port's runs without hooks, shared by the file's cases (one run of a
# scenario serves the reference match and the port's self-checks)
_PORT_RUNS: dict = {}


def drive(port: bool, models_arch, name, late=True, pre=None, post=None):
    """run()'s loop, with the two long prompts pending from iteration 3
    (``late``) and one fault at iteration ``fault step``; ``pre(eng)`` and
    ``post(eng)`` run around each step.  Returns (streams, errors,
    counters, trace, snapshots, engine); a port run without hooks is run
    once a module (``_PORT_RUNS``)."""
    key = (id(models_arch[2]), name, late)
    if port and pre is None and post is None:
        if key not in _PORT_RUNS:
            _PORT_RUNS[key] = _drive(port, models_arch, name, late)
        return _PORT_RUNS[key]
    return _drive(port, models_arch, name, late, pre, post)


def _drive(port: bool, models_arch, name, late=True, pre=None, post=None):
    jm, jp, tm, tp = models_arch
    cache, chunk, share, retries, fstep, site = SCENARIOS[name]
    eng = _engine(port, tm if port else jm, tp if port else jp, cache,
                  chunk, share, retries)
    R = Request if port else JRequest
    prompts, budgets = _traffic()
    reqs = [R(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    pending = reqs[:4] if late else list(reqs)
    snaps, it = [], 0
    while pending or eng.active or eng._prefill_cursors or it < 3:
        if late and it == 3:
            pending += reqs[4:]
        if pending and eng.free_slots():
            eng.admit(pending)
        fault = None
        if fstep is not None and it == fstep:
            fault = (ModelFault.at(0, site, FaultSpec.value(0, 1, 1e5))
                     if port else
                     JMF.at(0, site, JFault.value(0, 1, 1e5)))
        if pre is not None:
            pre(eng)
        eng.step(fault)
        if post is not None:
            post(eng)
        if eng.pool is not None:
            eng.pool.check_invariants()
            snaps.append((eng.pool.tables.copy(),
                          eng.pool.refcount.copy(),
                          np.asarray(eng.pos).copy(),
                          sorted(eng._prefill_cursors)))
        it += 1
    streams = {r.uid: list(r.generated) for r in reqs}
    errors = {r.uid: r.error for r in reqs}
    counters = {k: getattr(eng.stats, k) for k in COUNTERS}
    return streams, errors, counters, eng.stats.selection_trace, snaps, eng


# llama3.2-1b runs every scenario, the dense family two of them
CASES = [("llama3.2-1b", n) for n in sorted(SCENARIOS)] + [
    (a, n) for a in ARCHS[1:] for n in ("chunk_dense", "share_chunk")]


@pytest.mark.parametrize("arch,name", CASES)
def test_chunked_and_shared_match_reference(models, arch, name):
    ref = drive(False, models[arch], name)
    got = drive(True, models[arch], name)
    assert got[0] == ref[0], "greedy streams differ"
    assert got[1] == ref[1], "errors differ"
    assert got[2] == ref[2], "EngineStats counters differ"
    assert got[3] == ref[3], "selection_trace differs"
    assert len(got[4]) == len(ref[4])
    for a, b in zip(got[4], ref[4]):
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all(), \
            "block tables or refcounts differ"
        assert (a[2] == b[2]).all() and a[3] == b[3], "cursors differ"


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_shared_streams_equal_unchunked(models, arch):
    """The port against itself: chunked (dense, paged, odd and auto
    budgets) and shared streams equal the plain paged engine's."""
    base = drive(True, models[arch], "share", late=True)
    plain = _engine(True, models[arch][2], models[arch][3], "paged", None,
                    False, 1)
    prompts, budgets = _traffic()
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    want = plain.run(reqs)
    assert {u: list(v) for u, v in want.items()} == base[0]
    for name in ("chunk_dense", "chunk_paged_odd", "chunk_auto",
                 "share_chunk"):
        assert drive(True, models[arch], name)[0] == base[0], name


def test_counters_and_sharing_effects(models):
    """What each feature should produce: shared tokens, shared blocks, a
    COW copy for the identical pair, chunks, fewer pool blocks."""
    plain = drive(True, models["llama3.2-1b"], "paged")
    alone = drive(True, models["llama3.2-1b"], "share")
    share = drive(True, models["llama3.2-1b"], "share_chunk")
    c = share[2]
    assert c["prefix_tokens_shared"] > 0 and c["cow_copies"] > 0
    assert c["prefill_chunks"] > 0 and c["blocks_shared_peak"] > 0
    # same admission timing unchunked: sharing holds fewer blocks
    assert alone[2]["blocks_used_sum"] < plain[2]["blocks_used_sum"]
    assert 0 < share[5].stats.prefix_hit_rate < 1
    assert share[5].cache_stats()["prefix_hit_rate"] == \
        share[5].stats.prefix_hit_rate


def test_chunk_fault_retries_only_the_chunk(models):
    """A fault in a chunk re-executes that chunk alone: one chunk retry,
    and the step's decode call is not run again."""
    got = drive(True, models["llama3.2-1b"], "chunk_fault")
    c = got[2]
    assert c["faults_detected"] == 1 and c["retries"] == 1
    assert c["chunk_retries"] == 1 and c["hard_faults"] == 0
    clean = drive(True, models["llama3.2-1b"], "share_chunk")
    assert got[0] == clean[0]


def test_chunk_hard_fault_evicts_only_the_chunk_batch(models):
    """A persistent chunk fault evicts the chunk batch alone; resident
    decodes and every other request finish, blocks a survivor shares
    stay resident, and the pool never leaks."""
    got = drive(True, models["llama3.2-1b"], "chunk_evict")
    errs = got[1]
    evicted = {u for u, e in errs.items() if e is not None}
    assert evicted and all(errs[u] == "hard_fault:prefill" for u in evicted)
    assert len(evicted) < len(errs)
    assert got[2]["hard_faults"] == 1
    budgets = _traffic()[1]
    assert all(len(got[0][u]) == budgets[u] for u in errs
               if u not in evicted)
    pool = got[5].pool
    assert pool.blocks_free == pool.num_blocks
    assert (pool.refcount == 0).all()


def test_decode_hard_fault_keeps_shared_blocks_of_no_one(models):
    """A persistent decode fault with sharers resident evicts every active
    request; refcounts drop to zero and nothing leaks or double-frees."""
    got = drive(True, models["llama3.2-1b"], "share_decode_evict")
    assert got[2]["hard_faults"] == 1
    assert any(e == "hard_fault:decode" for e in got[1].values())
    pool = got[5].pool
    assert pool.blocks_free == pool.num_blocks


def test_long_prompt_does_not_starve_resident_decodes(models):
    """Every step advances every stream resident at its start by one
    token, while the long prompts are chunked in beside them."""
    before = {}
    mixed = []

    def pre(eng):
        before.clear()
        before.update({r.uid: (r, len(r.generated))
                       for r in eng.active.values()})
        mixed.append(bool(before) and bool(eng._prefill_cursors))

    def post(eng):
        for r, n in before.values():
            assert len(r.generated) == n + 1, "a resident stream stalled"

    drive(True, models["llama3.2-1b"], "chunk_paged_odd", pre=pre,
          post=post)
    assert any(mixed), "no step carried decodes beside a parked prompt"


def test_chunk_kv_cells_equal_whole_prompt_cells(models):
    """A prompt prefilled in chunks (odd budget) or as the suffix of a
    shared prefix writes the same KV bits as the whole-prompt prefill."""
    tm, tp = models["llama3.2-1b"][2:]
    prompts = _traffic()[0]

    def cells(chunk, share):
        eng = _engine(True, tm, tp, "paged", chunk, share, 1)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=2)
                for i, p in enumerate(prompts)]
        out = {}

        pending = list(reqs)
        while pending or eng.active or eng._prefill_cursors:
            if pending and eng.free_slots():
                eng.admit(pending)
            for s, r in eng.active.items():
                if r.uid in out:
                    continue
                t = eng.pool.tables[s]
                n = len(r.prompt)
                blk = torch.as_tensor(t[np.arange(n) // BLOCK]).long()
                off = torch.as_tensor(np.arange(n) % BLOCK)
                out[r.uid] = [layer[k][blk, off].clone()
                              for layer in eng.cache for k in ("k", "v")]
            eng.step()
        return out

    whole = cells(None, False)
    for chunk, share in ((5, False), (None, True), (8, True)):
        got = cells(chunk, share)
        for uid, leaves in whole.items():
            for a, b in zip(leaves, got[uid]):
                assert torch.equal(a, b), (chunk, share, uid)


@pytest.mark.parametrize("decode_tokens", [0, 1, 3, 16, 100])
def test_tune_chunk_budget_matches_reference(decode_tokens):
    """``ProtectionPlan.tune_chunk_budget`` on a HardwareSpec both packages
    define (TPU_V5E), for llama3.2-1b and qwen3-14b at full size: exact."""
    for arch in ("llama3.2-1b", "qwen3-14b"):
        jplan = build_model(jget(arch)).protection_plan(
            hw=JTPU, policy=JGuided(), n_tokens=4)
        plan = Model(get_config(arch)).protection_plan(
            hw=TPU_V5E, policy=IntensityGuidedPolicy(), n_tokens=4)
        for hi in (64, 2048):
            assert plan.tune_chunk_budget(decode_tokens, lo=8, hi=hi) == \
                jplan.tune_chunk_budget(decode_tokens, lo=8, hi=hi)
