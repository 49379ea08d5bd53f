"""Sharded serving of the SSM family on the CPU: the port's
``ServeEngine(mesh=k)`` over k gloo ranks against its local engine and
the reference's unsharded one, on scaled-down mamba2-1.3b (2
``mamba:none:0`` layers) and jamba-v0.1-52b cut to one 8-layer unit
(7 Mamba2 layers, one attention layer, MoE every other layer: 8 experts
top 2, EP at k = 2 and 4), f32, the reference's parameters (seed 1)
through numpy.

One pool of ranks a mesh width (k = 2 and 4) runs, on every rank and for
both stacks: dense; paged; an ``ssm_in`` decode fault at the first column
of ``in_x``'s upper half (rank 1's slice at k = 2, rank 2's at k = 4) and
an ``ssm_out`` fault (row-parallel: rank 0's partial), each retried; and
hard-fault eviction.  Every stream, error and ``EngineStats`` field equals
the local run's, on every rank (the ranks check each record among
themselves), but for the selection trace's ``intensity``, which the
engine reads off the per-shard plan.  The local dense runs equal the
reference's engine in every field (``tests/test_torch_ssm_engine.py``
holds the local faulted and paged runs against it).

The per-slot state commits only after the step's flag on each rank's
shard: a recovered fault leaves every rank's state, step for step, bit
for bit what its clean run leaves, and the step that evicts commits
nothing.  ``gated_rms_norm(tp=)`` of the ranks' slices equals the
unsharded norm within 1e-6 of its scale (f32 sums of squares summed over
the ranks in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_mesh_worker as W
from test_torch_ssm_model import build_pair
import torch

from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.core.hardware import HardwareSpec
from repro_torch.distributed import spawn
from repro_torch.models.layers import gated_rms_norm
from repro_torch.models.model import Model

torch.set_num_threads(1)

SHARD_HW = dict(name="shard-flip", peak_flops=2.4e13, vpu_flops=1e11,
                hbm_bw=1e12, ici_bw=1e11, hbm_bytes=1 << 34,
                vmem_bytes=1 << 24, fixed_op_overhead_s=1e-7)
ARCHS = tuple(W.SSM_ARCHS)
CASES = [(a, n) for a in ARCHS for n in W.SSM_NAMES]


def _norm_inputs():
    rng = np.random.default_rng(2)
    x, z = (torch.from_numpy(rng.standard_normal((3, 2, 128)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32))
    return x, z, w


@pytest.fixture(scope="module")
def pairs():
    return {arch: build_pair(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def local(pairs):
    out = {}
    for arch in ARCHS:
        model, params = pairs[arch][2], pairs[arch][3]
        out[arch] = W.stack_scenarios(model, params, None, W.SSM_NAMES,
                                      W.ssm_faults(model.cfg), W.F32)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ranks(request, pairs):
    """One gloo pool of k ranks running both stacks and the norm."""
    k = request.param
    stacks = {arch: pairs[arch][3] for arch in ARCHS}
    return k, spawn.run(W.ssm_rank, k, k, stacks, SHARD_HW, _norm_inputs(),
                        device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_local_dense_equals_reference(pairs, local, arch):
    jm, jp, model, _ = pairs[arch]
    eng = JEngine(jm, jp, slots=3, max_len=64, dtype=jnp.float32)
    out = eng.run([JRequest(r.uid, r.prompt, r.max_new_tokens)
                   for r in W.reqs(model.cfg)])
    rec = local[arch][0]["dense"]
    assert {int(u): [int(t) for t in s] for u, s in out.items()} == \
        rec["out"]
    assert dataclasses.asdict(eng.stats) == rec["stats"]


@pytest.mark.parametrize("arch,name", CASES)
def test_mesh_streams_equal_local(ranks, local, arch, name):
    k, recs = ranks
    want = W.comparable(local[arch][0][name])
    for r, rec in enumerate(recs):
        assert W.comparable(rec[arch]["scenarios"][name]) == want, \
            (k, r, arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_scenarios_exercise_their_paths(ranks, arch):
    k, recs = ranks
    sc = recs[0][arch]["scenarios"]
    for name in ("ssm_in", "ssm_out"):
        st = sc[name]["stats"]
        assert st["faults_detected"] >= 1 and st["retries"] >= 1, name
        assert st["hard_faults"] == 0
        assert sc[name]["streams"] == sc["dense"]["streams"]
    assert sc["paged"]["streams"] == sc["dense"]["streams"]
    assert sc["hard_fault"]["stats"]["hard_faults"] == 1
    assert sc["hard_fault"]["stats"]["evictions"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_recovered_state_bit_equal_on_every_rank(ranks, arch):
    """Each rank's state digest after every step: a retried ``ssm_in``
    (dense) or ``ssm_out`` (paged) fault equals the clean dense run's, and
    the evicting step leaves the state as it found it."""
    k, recs = ranks
    for r, rec in enumerate(recs):
        st = rec[arch]["states"]
        clean = [after for _, after, _ in st["dense"]]
        for name in ("paged", "ssm_in", "ssm_out"):
            assert [after for _, after, _ in st[name]] == clean, \
                (k, r, name)
        steps = st["hard_fault"]
        evicting = [i for i, (_, _, ev) in enumerate(steps)
                    if ev > (steps[i - 1][2] if i else 0)]
        assert evicting
        for i in evicting:
            assert steps[i][0] == steps[i][1], (k, r, i)
    # the ranks hold different shards of the state
    assert len({rec[arch]["states"]["dense"][-1][1] for rec in recs}) == k


@pytest.mark.parametrize("arch", ARCHS)
def test_executed_schemes_equal_the_plan(ranks, arch):
    """On ``SHARD_HW`` each rank's 64-token forward executes, site for
    site, the scheme of the TP=k plan's row (``in_z``/``in_x``/``in_dt``
    at N / k, ``out_proj`` at K / k, ``in_bc`` whole)."""
    k, recs = ranks
    model = Model(W.ssm_config(arch))
    plan = model.protection_plan(hw=HardwareSpec(**SHARD_HW), n_tokens=64,
                                 model_parallel=k)
    rows = {r["layer"]: r for r in plan.report_rows()}
    for rec in recs:
        assert rec[arch]["executed"] == {
            site: [row["scheme"]] for site, row in rows.items()}
    cfg = model.cfg
    assert rows["ssm.in_x"]["n"] == cfg.d_inner // k
    assert rows["ssm.out"]["k"] == cfg.d_inner // k
    assert rows["ssm.in_bc"]["n"] == 2 * cfg.ssm_state


@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_leaves_split_by_the_rules(ranks, arch):
    k, recs = ranks
    sharded = set(recs[0][arch]["sharded"])
    assert {"mixer/in_z", "mixer/in_x", "mixer/in_dt", "mixer/conv_x_w",
            "mixer/conv_x_b", "mixer/A_log", "mixer/D", "mixer/dt_bias",
            "mixer/out_norm", "mixer/out_proj"} <= sharded
    assert not {"mixer/in_bc", "mixer/conv_bc_w"} & sharded


def test_shard_at_draw_equals_shard_params(ranks):
    k, recs = ranks
    assert all(rec[a]["shard_draw"] for rec in recs for a in ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_audit_of_a_served_step(ranks, arch):
    """Each rank's decode step at TP=k: protected fraction 1.0, the TP=k
    plan bijective, one K1 record a GEMM call (mamba2: 5 a mixer and the
    head; jamba: 5 a mixer, 4 a GQA layer, 3 a dense FFN, 4 an MoE FFN
    (the router and three batched calls), the head)."""
    k, recs = ranks
    want = {"mamba2-1.3b": 2 * 5 + 1,
            "jamba-v0.1-52b": 7 * 5 + 4 + 4 * 3 + 4 * 4 + 1}[arch]
    for rec in recs:
        a = rec[arch]["audit"]
        assert a["model_parallel"] == k
        assert a["protected_fraction"] == 1.0
        assert a["crosscheck"]["bijective"]
        assert a["records"] == {"K1": want, "K2": 0, "K3": 0}


def test_gated_norm_over_the_ranks(ranks):
    """The ranks' slices of ``gated_rms_norm(tp=)``, side by side, equal
    the unsharded norm of the whole width."""
    k, recs = ranks
    x, z, w = _norm_inputs()
    want = gated_rms_norm(x, z, w, 1e-5).numpy()
    got = np.concatenate([rec["norm"] for rec in recs], axis=-1)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-6 * float(
        np.abs(want).max())
