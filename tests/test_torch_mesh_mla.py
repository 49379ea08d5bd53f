"""Sharded serving of MLA with its MTP head on the CPU: the port's
``ServeEngine(mesh=k)`` over k gloo ranks against its local engine and
the reference's unsharded one, on scaled-down deepseek-v3-671b (2 layers,
1 dense + 1 MoE, 4 MLA heads, 8 experts top 2 with a shared expert, the
MTP head, bf16, the reference's parameters through numpy).

The rules (``distributed/sharding.py``, the reference's): ``wq_b``
column-parallel and ``w_uk``/``w_uv`` split by head, so a rank runs
``4 / k`` heads; ``wq_a``, ``wkv_a``, their norms and the MTP ``proj``
replicated, so every rank computes the same latent and keeps the whole
latent cache; ``wo`` row-parallel; the 8 experts over the model axis (EP,
``8 / k`` a rank), the shared expert column- and row-parallel.

One pool of ranks a mesh width (k = 2 and 4) runs, on every rank:

- ``top2``: dense; paged + chunked + prefix-shared; a ``mla.q_b`` fault
  (site ``qkv``, column 60: rank 1's at k = 2, rank 2's at k = 4) at a
  decode step and an admission; an ``expert_up`` decode fault and a
  ``router`` admission fault; hard-fault eviction; unsped, n-gram and
  oracle speculation.
- ``top4``: 4 experts a token, so a token's EP partials can hold more
  than two terms.  Dense and paged (the executed schemes, the draw and
  the audit, which the routing width does not change, run on top2).

Every stream, error and ``EngineStats`` field equals the local run's on
every rank, but for the selection trace's ``intensity`` (the engine reads
it off the per-shard plan).  The local dense run equals the reference's
engine in every field (in f32: ``test_local_dense_equals_reference``).

Tolerances.  A sharded ``Model.forward``'s logits and ``mtp_logits``, and
the routed experts' output, reorder f32 sums before one rounding to bf16
(the row-parallel ``wo``, ``down`` and shared ``down``; the EP combine):
held within one bf16 rounding step, ``2**-8`` of the output's largest
magnitude, except the routed output at top 2, which is exact (a token's
two terms and zeros sum exactly in f32).  On this CPU they come out
exact all the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_mesh_worker as W
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.models import build_model
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.core.hardware import HardwareSpec
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import Mesh
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.executor import check_shardable

torch.set_num_threads(1)

# the reference's crafted point (tests/test_sharded_engine.py)
SHARD_HW = dict(name="shard-flip", peak_flops=2.4e13, vpu_flops=1e11,
                hbm_bw=1e12, ici_bw=1e11, hbm_bytes=1 << 34,
                vmem_bytes=1 << 24, fixed_op_overhead_s=1e-7)
VARIANTS = {"top2": {}, "top4": {"experts_per_token": 4}}
NAMES = {"top2": W.MLA_NAMES, "top4": ("dense", "paged")}
CASES = [(v, n) for v in VARIANTS for n in NAMES[v]]
# one bf16 rounding step of the output's scale (module docstring)
BF16_STEP = 2.0 ** -8


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, over in VARIANTS.items():
        jm = build_model(jscaled(jget(W.MLA_ARCH), **over))
        jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        params = params_from_reference(
            W.mla_config(**over), jax.tree_util.tree_map(np.asarray, jp),
            dtype=torch.bfloat16)
        out[name] = (jm, jp, params)
    return out


@pytest.fixture(scope="module")
def local(pairs):
    out = {}
    for name, over in VARIANTS.items():
        model = Model(W.mla_config(**over))
        params = pairs[name][2]
        recs, _ = W.stack_scenarios(model, params, None, NAMES[name],
                                    W.MLA_FAULTS, W.BF16)
        out[name] = {"scenarios": recs,
                     "routed": W.routed_output(model, params, None, W.BF16),
                     "routing": W.routing_log(model, params, None, W.BF16),
                     "forward": W.forward_logits(model, params, None,
                                                 W.BF16)}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ranks(request, pairs):
    """One gloo pool of k ranks running every variant."""
    k = request.param
    variants = {name: (over, pairs[name][2], NAMES[name])
                for name, over in VARIANTS.items()}
    return k, spawn.run(W.mla_rank, k, k, variants, SHARD_HW, device="cpu")


def _model_mesh(k):
    return Mesh(grid=np.arange(k).reshape(1, k),
                axis_names=("data", "model"),
                devices=(torch.device("cpu"),) * k)


# ---------------------------------------------------------- the reference
def test_local_dense_equals_reference(pairs):
    """The local engine's dense run equals the reference's unsharded
    engine in its streams and every ``EngineStats`` field, in f32 as
    ``tests/test_torch_mla_engine.py`` holds them (in bf16 XLA and torch
    round the MLA core's intermediates in other places, and a stream of
    these weights parts at a near-tie)."""
    jm, jp16, _ = pairs["top2"]
    # the same bf16 draws held in f32 (one init of the reference, not two)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp16)
    cfg = W.mla_config()
    params = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray,
                                                               jp))
    recs, _ = W.stack_scenarios(Model(cfg), params, None, ("dense",), {},
                                W.F32)
    eng = JEngine(jm, jp, slots=3, max_len=64, dtype=jnp.float32)
    out = eng.run([JRequest(r.uid, r.prompt, r.max_new_tokens)
                   for r in W.reqs(cfg)])
    assert {int(u): [int(t) for t in s] for u, s in out.items()} == \
        recs["dense"]["out"]
    assert dataclasses.asdict(eng.stats) == recs["dense"]["stats"]


# ------------------------------------------------------------ admission
@pytest.mark.parametrize("k", [2, 4])
def test_check_shardable_admits_deepseek(k):
    """deepseek-v3-671b shards over a model axis of 2 and 4, at full size
    and scaled down; its 128 MLA heads over 3 ranks would split a head
    (ROADMAP A.3b-ii)."""
    cfg = get_config(W.MLA_ARCH)
    check_shardable(cfg, _model_mesh(k))
    check_shardable(W.mla_config(), _model_mesh(k))
    with pytest.raises(NotImplementedError, match="MLA heads.*A.3b-ii"):
        check_shardable(cfg, _model_mesh(3))


# --------------------------------------------------------- mesh = 2, 4
@pytest.mark.parametrize("variant,name", CASES)
def test_mesh_streams_equal_local(ranks, local, variant, name):
    k, recs = ranks
    want = W.comparable(local[variant]["scenarios"][name])
    for r, rec in enumerate(recs):
        assert W.comparable(rec[variant]["scenarios"][name]) == want, \
            (k, r, variant, name)


def test_mesh_scenarios_exercise_their_paths(ranks):
    k, recs = ranks
    top2 = recs[0]["top2"]["scenarios"]
    st = {n: rec["stats"] for n, rec in top2.items()}
    assert st["shared_chunked"]["prefix_tokens_shared"] > 0
    assert st["shared_chunked"]["prefill_chunks"] > 0
    for name in ("qkv_faults", "moe_faults"):
        assert st[name]["faults_detected"] >= 2, name
        assert st[name]["retries"] >= 2, name
        assert st[name]["hard_faults"] == 0, name
        assert top2[name]["streams"] == top2["dense"]["streams"], name
    assert st["hard_fault"]["hard_faults"] == 1
    assert st["hard_fault"]["evictions"] >= 1
    assert st["oracle"]["draft_accepted"] == st["oracle"]["draft_proposed"] \
        > 0
    top4 = recs[0]["top4"]["scenarios"]
    assert top4["paged"]["streams"] == top4["dense"]["streams"]


def test_mla_leaves_follow_the_rules(ranks):
    """``wq_b``, ``w_uk``, ``w_uv`` and ``wo`` are split (the rank's 4 / k
    heads), the latent projections and norms are not; the MTP head's
    layer takes the layer rules (its ``mtp/layer`` leaves at their shard
    shapes), its ``proj`` and norm stay whole; the experts shard by EP."""
    k, recs = ranks
    cfg = W.mla_config()
    hl = cfg.n_heads // k
    for rec in recs:
        for variant in VARIANTS:
            r = rec[variant]
            sharded = set(r["sharded"])
            assert {"mixer/wq_b", "mixer/w_uk", "mixer/w_uv", "mixer/wo",
                    "ffn/w_up", "ffn/w_gate", "ffn/w_down", "ffn/shared/up",
                    "ffn/shared/gate", "ffn/shared/down"} <= sharded
            assert not {"mixer/wq_a", "mixer/wkv_a", "mixer/q_a_norm",
                        "mixer/kv_a_norm", "ffn/router"} & sharded
            assert r["moe_mode"] == "ep"
            s = r["mtp_shapes"]
            d, hq = cfg.d_model, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            assert s["proj"] == [2 * d, d] and s["norm/w"] == [d]
            assert s["layer/mixer/wq_a"] == [d, cfg.q_lora_rank]
            assert s["layer/mixer/wq_b"] == [cfg.q_lora_rank, hl * hq]
            assert s["layer/mixer/w_uk"] == [hl, cfg.qk_nope_head_dim,
                                             cfg.kv_lora_rank]
            assert s["layer/mixer/wo"] == [hl * cfg.v_head_dim, d]
            assert s["layer/ffn/w_up"][0] == cfg.n_experts // k


def test_routed_experts_at_top2_and_top4(ranks, local):
    """At top 2 under EP the routed experts' output equals the local one
    bit for bit on every rank; at top 4 within one bf16 rounding step of
    the output's scale."""
    k, recs = ranks
    for variant in VARIANTS:
        want = local[variant]["routed"]
        tol = BF16_STEP * float(np.abs(want).max())
        for r, rec in enumerate(recs):
            got = rec[variant]["routed"]
            if variant == "top2":
                assert np.array_equal(got, want), (k, r)
            else:
                assert float(np.abs(got - want).max()) <= tol, (k, r)


def test_every_rank_routes_alike(ranks, local):
    k, recs = ranks
    for variant in VARIANTS:
        for rec in recs:
            assert rec[variant]["routing"] == local[variant]["routing"]


def test_sharded_forward_and_mtp_logits(ranks, local):
    """A sharded ``Model.forward`` gives the local logits and
    ``mtp_logits`` (B, L, V) on every rank, within one bf16 rounding
    step of their scale, and no flag."""
    k, recs = ranks
    for variant in VARIANTS:
        want = local[variant]["forward"]
        for r, rec in enumerate(recs):
            got = rec[variant]["forward"]
            assert not got["flag"]
            for key in ("logits", "mtp_logits"):
                assert got[key].shape == want[key].shape
                tol = BF16_STEP * float(np.abs(want[key]).max())
                assert float(np.abs(got[key] - want[key]).max()) <= tol, \
                    (k, r, variant, key)


def test_executed_schemes_equal_the_plan(ranks):
    """On ``SHARD_HW`` each rank's 64-token forward executes, site for
    site, the scheme of the TP=k plan's row: ``mla.q_b`` N and
    ``mla.out`` K divided by k, the latent projections whole, E / k
    experts at their own dims.  The MTP head's ``proj`` is no plan site
    (the reference's counting lists none; it runs in the score only)."""
    k, recs = ranks
    for variant, over in (("top2", VARIANTS["top2"]),):
        model = Model(W.mla_config(**over))
        plan = model.protection_plan(hw=HardwareSpec(**SHARD_HW),
                                     n_tokens=64, model_parallel=k)
        rows = {r["layer"]: r for r in plan.report_rows()}
        cfg = model.cfg
        hq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        assert rows["mla.q_b"]["n"] == cfg.n_heads * hq // k
        assert rows["mla.out"]["k"] == cfg.n_heads * cfg.v_head_dim // k
        assert rows["mla.q_a"]["n"] == cfg.q_lora_rank
        assert rows["mla.kv_a"]["n"] == cfg.kv_lora_rank \
            + cfg.qk_rope_head_dim
        for rec in recs:
            executed = dict(rec[variant]["executed"])
            assert executed.pop("mtp.proj")
            assert executed == {site: [row["scheme"]]
                                for site, row in rows.items()}


def test_shard_at_draw_equals_shard_params(ranks):
    """``init_params(mesh=)`` equals ``shard_params`` of the whole tree
    bit for bit, the ``mtp`` subtree included."""
    k, recs = ranks
    assert all(rec["top2"]["shard_draw"] for rec in recs)


def test_audit_of_a_served_step(ranks):
    """Each rank's decode step at TP=k: protected fraction 1.0 with the
    MLA core the known gap, the TP=k plan bijective over its 12 sites,
    one K1 record a GEMM call (7 in the dense layer: q_a, q_b, kv_a, out,
    up, gate, down; 11 in the MoE layer: q_a, q_b, kv_a, out, the router,
    three batched expert calls, three shared-expert GEMMs; the head) and
    no K2 or K3."""
    k, recs = ranks
    for rec in recs:
        a = rec["top2"]["audit"]
        assert a["model_parallel"] == k
        assert a["protected_fraction"] == 1.0
        assert a["coverage"]["known_unprotected"]["mla"]["flops"] > 0
        assert a["crosscheck"]["bijective"]
        assert a["crosscheck"]["n_sites"] == 12
        assert a["records"] == {"K1": 7 + 11 + 1, "K2": 0, "K3": 0}
