"""Data-parallel serving on the CPU: the port's ``ServeEngine`` over a
``(data=2, model=1)`` and a ``(data=2, model=2)`` mesh of gloo ranks
(``repro_torch.distributed.spawn``, one spawn a mesh, every scenario of
the mesh inside it) against its local engine and the reference's own
``(2, 2)`` engine, on scaled-down llama3.2-1b (2 layers, bf16, the reference's
parameters through numpy) and qwen2-moe-a2.7b (2 MoE layers, its own
seeded draw: the MoE stack is held to the port's local twin).

Four slots divide the data axis, so data rank r holds slots 2r and
2r + 1 of the dense cache and a decode step runs them alone (two rows a
rank, one MoE dispatch group), its logits gathered over ``data``.  Every
stream, error and counter equals the local run's on every rank: dense,
paged, chunked, chunked + prefix shared across the data ranks (request
4 in data rank 1's slot 2 shares the prefix request 0 prefilled from
slot 0), a decode fault on logical row 3 (data rank 1's row 1) and an
admission fault retried, hard-fault eviction, unsped and n-gram
speculation (two slots, one a rank).  The MoE stack's local twin runs
with ``ShardingHints(dp_size=2)``, the reference's group count at
data = 2.

Every cell a prefix match can read (each registered block's prompt
cells) is held equal over the data ranks after every step: prompt cells
are written by prefills, which run whole on every data rank, and a
split decode writes only past a prompt (``PrefixIndex.add`` registers a
prompt's blocks, and a match reads at most their prompt tokens), so no
shared read meets a cell only one data rank wrote.

The plan is the one that runs: on ``SPLIT_HW`` a decode GEMM of 2 rows
takes ``global`` where one of 4 takes ``block_1s``, and each rank's
decode step executes the plan at ``n_tokens = slots // data``.  The
reference caveat: its executor plans ``n_tokens = slots`` at any data
width (``src/repro/serve/executor.py:85-91``).

The reference's engine serves at ``(2, 2)`` under a mesh from its own
``build_mesh`` (``jax.sharding.Mesh``: auto axes), equal to the port's
``(2, 2)`` streams; under ``jax.make_mesh((2, 2), ("data", "model"))``
(explicit axes on this jax) its embedding lookup raises a
``ShardingTypeError``: a reference caveat, recorded here.

FSDP (``sharding.FSDP_THRESHOLD`` lowered below the scaled model's
count, in the rank processes only): each rank draws only its shard, bit
for bit ``shard_params``' (a quarter of each weight at (2, 2), half at
(2, 1)); each leaf gathered over ``data`` equals its model shard; the
FSDP-served streams equal the unsharded ones (a gather is exact).

The split decode's MoE dispatch: 32 rows, data rank 0's one token
repeated (its two experts over capacity, 16 tokens dropped), rank 1's
distinct (no drop); the ranks' routed outputs, concatenated, equal the
reference's ``moe_forward`` at ``dp_size = 2`` on the reference's
``init_moe`` weights (f32, 1e-5 absolute and relative:
``tests/test_torch_hints.py``'s tolerance).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_data_worker as WD
import test_torch_mesh_worker as W
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import HardwareSpec as JHardwareSpec
from repro.models import build_model, moe as jmoe
from repro_torch.core.hardware import HardwareSpec
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import Mesh
from repro_torch.models.counting import count_params
from repro_torch.models.layers import LayerCtx, ShardingHints
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)

# a decode GEMM of 2 rows and one of 4 take different schemes here
SPLIT_HW = dict(name="split-flip", peak_flops=1e11, vpu_flops=1e10,
                hbm_bw=1e11, ici_bw=1e11, hbm_bytes=1 << 34,
                vmem_bytes=1 << 24, fixed_op_overhead_s=1e-7)
MESHES = [(2, 1), (2, 2)]
NAMES = ("dense", "paged", "chunked", "shared", "fault", "hard", "unsped",
         "sped")
MOE_NAMES = ("dense", "paged", "fault")
# (2, 1) runs the scenarios that split a call differently from (2, 2)'s
# (the suite's time: every scenario runs at (2, 2))
RUNS = {(2, 1): (("dense", "shared", "fault", "sped"), ("dense",)),
        (2, 2): (NAMES, MOE_NAMES)}

# the reference's engine at (data=2, model=2) over four XLA host devices:
# its dense streams under its own build_mesh, and what jax.make_mesh's
# explicit-axis mesh raises
REFERENCE_22 = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, scaled_down
from repro.distributed.mesh import build_mesh
from repro.models import build_model
from repro.serve.engine import Request, ServeEngine
cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
model = build_model(cfg)
params = model.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
rng = np.random.default_rng(0)
reqs = [(i, rng.integers(1, cfg.vocab_size, size=rng.integers(4, 20))
         .astype(np.int32)) for i in range(6)]
def run(mesh):
    eng = ServeEngine(model, params, slots=4, max_len=64,
                      dtype=jnp.bfloat16, mesh=mesh)
    res = eng.run([Request(uid=u, prompt=p, max_new_tokens=5)
                   for u, p in reqs])
    return np.array([list(res[u]) for u, _ in reqs])
streams = run(build_mesh(model=2, data=2))
try:
    run(jax.make_mesh((2, 2), ("data", "model")))
    err = "served"
except Exception as e:
    err = type(e).__name__
np.savez(sys.argv[1], streams=streams, make_mesh=np.array(err))
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # the reference's (2, 2) run starts first and runs beside the ranks
    path = tmp_path_factory.mktemp("ref22") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_22, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jp = build_model(jcfg).init_params(jax.random.PRNGKey(0),
                                       dtype=jnp.bfloat16)
    llama = params_from_reference(W.small_config(), jax.tree_util.tree_map(
        np.asarray, jp), dtype=torch.bfloat16)
    # the MoE stack's served runs hold the port against itself (its own
    # seeded draw: the reference's whole-model init costs 8 s here); the
    # routed layer of the split decode is the reference's ``init_moe``
    moe = Model(W.moe_config()).init_params(1, dtype=torch.bfloat16)
    jlayer = jmoe.init_moe(_routed_cfg(), jax.random.PRNGKey(4),
                           jnp.float32)
    layer = {k: torch.from_numpy(np.array(v)) for k, v in jlayer.items()}
    # the two pools run one after the other on a thread of their own, while
    # this process runs the local twins (the ``local`` fixture)
    thr = count_params(W.small_config()) - 1
    pool = ThreadPoolExecutor(1)
    runs = {(d, k): pool.submit(
        spawn.run, WD.data_rank, d * k, d, k, llama, moe, layer, SPLIT_HW,
        thr, *RUNS[(d, k)], device="cpu") for d, k in MESHES}
    yield {"llama": llama, "moe": moe, "moe_j": jlayer, "ref": (proc, path),
           "runs": runs}
    pool.shutdown(wait=True)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def local(setup):
    llama = Model(W.small_config())
    moe = Model(W.moe_config())
    return {"llama": WD.data_scenarios(llama, setup["llama"], None),
            "moe": WD.data_scenarios(moe, setup["moe"], None,
                                     hints=ShardingHints(dp_size=2),
                                     names=MOE_NAMES)}


@pytest.fixture(scope="module", params=MESHES, ids=["d2k1", "d2k2"])
def ranks(request, setup, local):
    """One gloo pool a mesh running every scenario (started by
    ``setup``)."""
    return request.param, setup["runs"][request.param].result()


def _routed_cfg():
    return jscaled(jget(W.MOE_ARCH), n_shared_experts=0)


def _without(rec, *keys):
    return {k: v for k, v in rec.items() if k not in keys}


# --------------------------------------------------------- the scenarios
@pytest.mark.parametrize("name", NAMES)
def test_streams_equal_local(ranks, local, name):
    mesh, recs = ranks
    if name not in RUNS[mesh][0]:
        assert name not in recs[0]["llama"]
        return
    want = _without(local["llama"][name], "slots")
    for r, rec in enumerate(recs):
        got = _without(rec["llama"][name], "slots", "index_cells")
        assert got == want, (mesh, r, name)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_streams_equal_local_at_dp_groups(ranks, local, name):
    mesh, recs = ranks
    if name not in RUNS[mesh][1]:
        assert name not in recs[0]["moe"]
        return
    for r, rec in enumerate(recs):
        assert _without(rec["moe"][name], "slots") == \
            _without(local["moe"][name], "slots"), (mesh, r, name)
    assert recs[0]["moe_dp_size"] == 2


def test_ranks_agree_and_split_the_slots(ranks):
    (d, k), recs = ranks
    keys = ("llama", "plan", "executed", "audit", "moe", "fsdp")
    assert all({key: rec[key] for key in keys}
               == {key: recs[0][key] for key in keys} for rec in recs)
    for rec in recs:
        r = rec["data_rank"]
        assert rec["layout"] == {"rows": [2 * r, 2], "kv_rows": 2}


def test_scenarios_exercise_their_paths(ranks, local):
    _, recs = ranks
    rec = local["llama"]
    st = {n: rec[n]["stats"] for n in NAMES}
    # request 4 in data rank 1's slot 2 shares a full block (8 tokens) of
    # request 0's prompt, prefilled from data rank 0's slot 0
    got = recs[0]["llama"]["shared"]
    assert got["slots"][0] == 0 and got["slots"][4] == 2
    assert st["shared"]["prefix_tokens_shared"] == 8
    assert got["index_cells"] > 0
    assert st["chunked"]["prefill_chunks"] > 0
    assert st["fault"]["faults_detected"] >= 2
    assert st["fault"]["hard_faults"] == 0
    assert rec["fault"]["streams"] == rec["paged"]["streams"]
    assert st["hard"]["hard_faults"] == 1 and st["hard"]["evictions"] >= 1
    assert st["sped"]["draft_accepted"] > 0
    assert rec["sped"]["streams"] == rec["unsped"]["streams"]
    assert local["moe"]["fault"]["stats"]["faults_detected"] >= 2


def test_row_fault_lands_on_its_owner_only():
    """A fault at logical row 3 of a split 4-row call: data rank 1 (rows
    2, 3) takes it at its local row 1, rank 0 nowhere; the plain path's
    (B, L, k) fault row is the position, on every rank."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import FixedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.schemes import Scheme
    from repro_torch.models.layers import _row_fault

    f = FaultSpec.value(3, 1, 1.0)
    x, w = torch.zeros(2, 1, 64), torch.zeros(64, 64)
    block = ABFTConfig(policy=FixedPolicy(Scheme.BLOCK_1S))
    r1 = LayerCtx(abft=block, rows=(2, 2))
    r0 = LayerCtx(abft=block, rows=(0, 2))
    assert _row_fault(f, x, w, r1, torch.float32) == f._replace(row=1)
    assert _row_fault(f, x, w, r0, torch.float32) is None
    assert _row_fault(f, x, w, LayerCtx(abft=block), torch.float32) == f
    plain = LayerCtx(abft=ABFTConfig(policy=FixedPolicy(Scheme.GLOBAL)),
                     rows=(2, 2))
    assert _row_fault(f, x, w, plain, torch.float32) == f
    # a verify call's (B, T) rows: row b * T + t
    assert _row_fault(FaultSpec.value(9, 1, 1.0), torch.zeros(2, 3, 64), w,
                      r1, torch.float32) == FaultSpec.value(3, 1, 1.0)


# ------------------------------------------------ the plan that runs
def test_executed_schemes_equal_the_split_plan(ranks):
    """Each rank's decode step on ``SPLIT_HW`` executes, site for site,
    the plan at ``n_tokens = slots // data`` (2 rows), which differs from
    the 4-row plan on this hardware."""
    (d, k), recs = ranks
    model = Model(W.small_config())
    hw = HardwareSpec(**SPLIT_HW)
    two = {r["layer"]: r["scheme"] for r in model.protection_plan(
        hw=hw, n_tokens=2, model_parallel=k).report_rows()}
    four = {r["layer"]: r["scheme"] for r in model.protection_plan(
        hw=hw, n_tokens=4, model_parallel=k).report_rows()}
    assert any(two[s] != four[s] for s in two)
    for rec in recs:
        assert rec["plan"] == two and rec["plan_m"] == [2]
        assert rec["executed"] == {s: [two[s]] for s in two}


def test_reference_plans_every_slot(ranks):
    """The reference caveat: its executor passes ``n_tokens=slots`` at any
    data width, so on ``SPLIT_HW`` its (2, k) plan names the 4-row
    schemes where a rank runs 2 rows."""
    (d, k), recs = ranks
    jm = build_model(jscaled(jget("llama3.2-1b"), n_layers=2))
    ref = {r["layer"]: r["scheme"] for r in jm.protection_plan(
        hw=JHardwareSpec(**SPLIT_HW), n_tokens=4,
        model_parallel=k).report_rows()}
    assert any(ref[s] != recs[0]["executed"][s][0] for s in ref)


def test_served_step_audit(ranks):
    _, recs = ranks
    for rec in recs:
        assert rec["audit"] == {"protected_fraction": 1.0,
                                "bijective": True}


# ------------------------------------------------ the reference at (2, 2)
def test_reference_engine_at_2x2(setup, local):
    """The reference's (2, 2) engine serves under its own ``build_mesh``,
    its streams equal to the port's (2, 2) dense run (and so to the
    local one) on the same weights and traffic; ``jax.make_mesh``'s
    explicit-axis mesh makes it raise (the caveat)."""
    recs = setup["runs"][(2, 2)].result()
    proc, path = setup["ref"]
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out.decode()[-2000:]
    ref = np.load(path)
    got = recs[0]["llama"]["dense"]["streams"]
    assert np.array_equal(ref["streams"],
                          np.array([got[u] for u in range(6)]))
    assert str(ref["make_mesh"]) == "ShardingTypeError"


# ------------------------------------------------ MoE groups on a split decode
def test_split_decode_groups_drop_differently(setup, ranks):
    (d, k), recs = ranks
    from repro.core.hardware import TPU_V5E as JTPU
    from repro.core.protected import ABFTConfig as JABFT
    from repro.models import LayerCtx as JCtx
    from repro.models.layers import ShardingHints as JHints

    parts = {}
    for rec in recs:
        r = rec["routed"]
        parts.setdefault(r["lo"], r)
    assert [parts[lo]["drops"] for lo in sorted(parts)] == [16, 0]
    got = np.concatenate([parts[lo]["y"] for lo in sorted(parts)])
    jcfg = _routed_cfg()
    p = setup["moe_j"]
    ctx = JCtx(abft=JABFT(use_pallas=False, hardware=JTPU),
               hints=JHints(dp=("data",), dp_size=2))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    x = WD.routed_inputs(jcfg.d_model)
    with jax.set_mesh(mesh):
        want, _, _ = jax.jit(lambda x, p: jmoe.moe_forward(
            x, p, jcfg, ctx))(jnp.asarray(x), p)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- FSDP
def test_fsdp_draw_gather_and_streams(ranks, local):
    (d, k), recs = ranks
    for rec in recs:
        fs = rec["fsdp"]
        assert fs["draw_equal"] and fs["gathers_equal"]
        assert fs["gathered"] == len(fs["shares"]) > 0
        assert {"mixer/wq", "mixer/wo", "ffn/up", "ffn/down",
                "embed"} <= set(fs["fsdp_paths"])
        # a weight split over both axes: a quarter at (2, 2), half at (2, 1)
        assert fs["shares"]["layers/0/mixer/wq"] == d * k
        assert fs["shares"]["embed"] == d * k
        assert fs["fsdp_gathers"] > 0
        assert fs["dense"] == local["llama"]["dense"]


def test_check_shardable_admits_data():
    """``check_shardable`` admits a (2, 2) mesh and a (pod, data, model)
    one (``tests/test_torch_mesh_pod.py`` serves it); an MLA head split
    still raises, naming ROADMAP A.3b-ii."""
    from repro_torch.serve.executor import check_shardable

    cpu = (torch.device("cpu"),) * 4
    check_shardable(W.small_config(), Mesh(
        grid=np.arange(4).reshape(2, 2), axis_names=("data", "model"),
        devices=cpu))
    pod = Mesh(grid=np.arange(4).reshape(2, 1, 2),
               axis_names=("pod", "data", "model"), devices=cpu)
    check_shardable(W.small_config(), pod)
    with pytest.raises(NotImplementedError, match="MLA heads.*A.3b-ii"):
        check_shardable(W.mla_config(n_heads=3), pod)


def test_draw_transient_at_published_widths():
    """``init_params(mesh=)`` holds one leaf's draw beside the shard:
    under FSDP the data axis splits a leaf's second dim, which the draw
    now cuts slice by slice: a weight of more than ``DRAW_SLICE``
    elements costs one f32 slice (at most 4 GiB), one of at most that many
    is drawn whole, 6 bytes an element (its f32 draw beside its bf16
    cast), so no config's transient exceeds 6 GiB."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import DRAW_SLICE

    sizes = {}
    for arch in ("llama3.2-1b", "qwen1.5-32b", "qwen2-moe-a2.7b",
                 "deepseek-v3-671b", "jamba-v0.1-52b", "qwen3-14b"):
        nbytes, path = Model(get_config(arch)).draw_transient()
        sizes[arch] = (nbytes, path)
        assert nbytes <= 6 * DRAW_SLICE
    assert sizes["qwen1.5-32b"] == (152064 * 5120 * 6, "lm_head")
