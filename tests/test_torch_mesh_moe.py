"""Sharded serving of the MoE family on the CPU: the port's
``ServeEngine(mesh=k)`` over k gloo ranks against its local engine and
the reference's unsharded one, on scaled-down qwen2-moe-a2.7b (2 MoE
layers, 8 experts top 2 with shared experts, bf16, the reference's
parameters through numpy).

One pool of ranks a mesh width (k = 2 and 4) runs, on every rank:

- ``top2``: 8 experts divide both widths, so the experts shard over the
  model axis (EP).  Dense; paged + chunked + prefix-shared; an
  ``expert_up`` decode fault and a ``router`` admission fault retried;
  hard-fault eviction; unsped, n-gram and oracle speculation.
- ``tp6``: 6 experts (EP at k = 2; at k = 4 each expert's FFN dim is
  sliced, ``w_up``/``w_gate`` column- and ``w_down`` row-parallel).
  Dense; ``expert_up`` + ``router`` faults; an ``expert_down`` fault.
- ``top4``: 4 experts a token, so a token's EP partials can hold more
  than two terms and their sum need not be exact.  Dense and paged.

Every stream, error and ``EngineStats`` field equals the local run's, on
every rank (the ranks also check each record among themselves), but for
the selection trace's ``intensity``: the engine reads it off the plan that
runs, the per-shard plan at TP=k.  The local top2 and tp6 dense runs equal
the reference's engine in every field (the other scenarios' local runs are
held against the reference by ``tests/test_torch_moe_engine.py`` and
``tests/test_torch_moe_spec.py``).

The routed experts' output alone (the first FFN without its shared
experts) at top 2 under EP equals the local one bit for bit: a token's
two terms land on one rank or two, and an f32 sum of two terms and zeros
is exact.  Expert-FFN TP and top 4 reorder f32 sums before the one
rounding to bf16: held within one bf16 rounding step, ``2**-8`` of the
output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_mesh_worker as W
from test_torch_shared_runners import shared_runners
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.models import build_model
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.core.hardware import HardwareSpec
from repro_torch.distributed import spawn
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``)."""
    with shared_runners():
        yield


# the reference's crafted point (tests/test_sharded_engine.py)
SHARD_HW = dict(name="shard-flip", peak_flops=2.4e13, vpu_flops=1e11,
                hbm_bw=1e12, ici_bw=1e11, hbm_bytes=1 << 34,
                vmem_bytes=1 << 24, fixed_op_overhead_s=1e-7)
VARIANTS = {"top2": {}, "tp6": {"n_experts": 6},
            "top4": {"experts_per_token": 4}}
NAMES = {"top2": W.MOE_NAMES,
         "tp6": ("dense", "moe_faults", "expert_down"),
         "top4": ("dense", "paged")}
CASES = [(v, n) for v in VARIANTS for n in NAMES[v]]
REFERENCE = ("top2", "tp6")      # dense runs held against the reference


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, over in VARIANTS.items():
        jm = build_model(jscaled(jget(W.MOE_ARCH), **over))
        jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        params = params_from_reference(
            W.moe_config(**over), jax.tree_util.tree_map(np.asarray, jp),
            dtype=torch.bfloat16)
        out[name] = (jm, jp, params)
    return out


@pytest.fixture(scope="module")
def local(pairs):
    out = {}
    for name, over in VARIANTS.items():
        model = Model(W.moe_config(**over))
        params = pairs[name][2]
        recs, _ = W.stack_scenarios(model, params, None, NAMES[name],
                                    W.MOE_FAULTS, W.BF16)
        out[name] = {"scenarios": recs,
                     "routed": W.routed_output(model, params, None, W.BF16),
                     "routing": W.routing_log(model, params, None, W.BF16)}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ranks(request, pairs):
    """One gloo pool of k ranks running every variant."""
    k = request.param
    variants = {name: (over, pairs[name][2], NAMES[name])
                for name, over in VARIANTS.items()}
    return k, spawn.run(W.moe_rank, k, k, variants, SHARD_HW, device="cpu")


# ---------------------------------------------------------- the reference
@pytest.mark.parametrize("variant", REFERENCE)
def test_local_dense_equals_reference(pairs, local, variant):
    """The local engine's dense run equals the reference's unsharded
    engine in its streams and every ``EngineStats`` field."""
    import dataclasses

    jm, jp, _ = pairs[variant]
    cfg = W.moe_config(**VARIANTS[variant])
    eng = JEngine(jm, jp, slots=3, max_len=64, dtype=jnp.bfloat16)
    out = eng.run([JRequest(r.uid, r.prompt, r.max_new_tokens)
                   for r in W.reqs(cfg)])
    rec = local[variant]["scenarios"]["dense"]
    assert {int(u): [int(t) for t in s] for u, s in out.items()} == \
        rec["out"]
    assert dataclasses.asdict(eng.stats) == rec["stats"]


# --------------------------------------------------------- mesh = 2, 4
@pytest.mark.parametrize("variant,name", CASES)
def test_mesh_streams_equal_local(ranks, local, variant, name):
    k, recs = ranks
    want = W.comparable(local[variant]["scenarios"][name])
    for r, rec in enumerate(recs):
        assert W.comparable(rec[variant]["scenarios"][name]) == want, \
            (k, r, variant, name)


def test_mesh_scenarios_exercise_their_paths(ranks, local):
    k, recs = ranks
    top2 = recs[0]["top2"]["scenarios"]
    st = {n: rec["stats"] for n, rec in top2.items()}
    assert st["shared_chunked"]["prefix_tokens_shared"] > 0
    assert st["shared_chunked"]["prefill_chunks"] > 0
    assert st["moe_faults"]["faults_detected"] >= 2
    assert st["moe_faults"]["retries"] >= 2
    assert st["moe_faults"]["hard_faults"] == 0
    assert top2["moe_faults"]["streams"] == top2["dense"]["streams"]
    assert st["hard_fault"]["hard_faults"] == 1
    assert st["hard_fault"]["evictions"] >= 1
    # these weights emit no token of the periodic prompts, so the n-gram
    # proposer drafts nothing (its run equals the local one all the same);
    # the oracle's drafts are all accepted: K + 1-row verify windows
    assert st["oracle"]["draft_accepted"] == st["oracle"]["draft_proposed"] \
        > 0
    tp6 = recs[0]["tp6"]["scenarios"]
    for name in ("moe_faults", "expert_down"):
        assert tp6[name]["stats"]["faults_detected"] >= 2
        assert tp6[name]["stats"]["hard_faults"] == 0
        assert tp6[name]["streams"] == tp6["dense"]["streams"]
    assert recs[0]["top4"]["scenarios"]["paged"]["streams"] == \
        recs[0]["top4"]["scenarios"]["dense"]["streams"]


def test_moe_modes_follow_the_rules(ranks):
    """EP wherever the experts divide the axis, else the expert FFN dim
    sliced; either way the shared experts (two levels below the layer)
    are split with their own ``par``."""
    k, recs = ranks
    want = {"top2": "ep", "top4": "ep", "tp6": "ep" if k == 2 else "tp"}
    for rec in recs:
        for variant, mode in want.items():
            assert rec[variant]["moe_mode"] == mode, (k, variant)
            assert {"ffn/w_up", "ffn/w_gate", "ffn/w_down",
                    "ffn/shared/up", "ffn/shared/gate",
                    "ffn/shared/down"} <= set(rec[variant]["sharded"])
            assert "ffn/router" not in rec[variant]["sharded"]


def test_routed_experts_exact_at_top2(ranks, local):
    """At top 2 under EP the routed experts' output equals the local one
    bit for bit on every rank; expert-FFN TP and top 4 within one bf16
    rounding step of the output's scale."""
    k, recs = ranks
    for variant in VARIANTS:
        want = local[variant]["routed"]
        tol = 2.0 ** -8 * float(np.abs(want).max())
        for r, rec in enumerate(recs):
            got = rec[variant]["routed"]
            if variant == "top2":
                assert np.array_equal(got, want), (k, r)
            else:
                assert float(np.abs(got - want).max()) <= tol, (k, r, variant)


def test_every_rank_routes_alike(ranks, local):
    """The router and its softmax stay replicated: every rank's routing
    log (``check_same`` among the ranks) equals the local run's."""
    k, recs = ranks
    for variant in VARIANTS:
        for rec in recs:
            assert rec[variant]["routing"] == local[variant]["routing"]


def test_executed_schemes_equal_the_plan(ranks):
    """On ``SHARD_HW`` each rank's 64-token forward executes, site for
    site, the scheme of the TP=k plan's row: EP keeps each expert's dims
    (the plan counts E/k experts), expert-FFN TP divides N (``w_up``) or
    K (``w_down``)."""
    k, recs = ranks
    for variant, over in VARIANTS.items():
        model = Model(W.moe_config(**over))
        plan = model.protection_plan(hw=HardwareSpec(**SHARD_HW),
                                     n_tokens=64, model_parallel=k)
        rows = {r["layer"]: r for r in plan.report_rows()}
        for rec in recs:
            assert rec[variant]["executed"] == {
                site: [row["scheme"]] for site, row in rows.items()}
        cfg = model.cfg
        up, down = rows["moe.expert_up"], rows["moe.expert_down"]
        if cfg.n_experts % k == 0:
            assert (up["k"], up["n"], down["k"]) == \
                (cfg.d_model, cfg.moe_d_ff, cfg.moe_d_ff)
        else:
            assert (up["n"], down["k"]) == (cfg.moe_d_ff // k,
                                            cfg.moe_d_ff // k)


def test_shard_at_draw_equals_shard_params(ranks):
    k, recs = ranks
    assert all(rec[v]["shard_draw"] for rec in recs for v in VARIANTS)


def test_audit_of_a_served_step(ranks):
    """Each rank's decode step at TP=k: protected fraction 1.0, the TP=k
    plan bijective over its 10 sites, one K1 record a GEMM call (11 a
    layer: q, k, v, o, the router, three batched expert calls and three
    shared-expert GEMMs; the head)."""
    k, recs = ranks
    for rec in recs:
        for variant in VARIANTS:
            a = rec[variant]["audit"]
            assert a["model_parallel"] == k
            assert a["protected_fraction"] == 1.0
            assert a["crosscheck"]["bijective"]
            assert a["crosscheck"]["n_sites"] == 10
            assert a["records"] == {"K1": 2 * 11 + 1, "K2": 0, "K3": 0}
