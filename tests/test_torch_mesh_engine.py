"""Sharded serving on the CPU: the port's ``ServeEngine(mesh=k)`` over k
gloo ranks (``repro_torch.distributed.spawn``) against the local engine,
on scaled-down llama3.2-1b (2 layers, bf16, the reference's parameters
through numpy) and the reference's ``_reqs``.

One pool of ranks a mesh width (k = 2 and 4) runs every scenario of the
reference's ``tests/test_sharded_engine.py::TestMeshEquivalence`` (dense;
paged + chunked + prefix-shared; faults at a decode step and an admission
retried; hard-fault eviction) and ``tests/test_spec_decode.py``'s mesh
case (n-gram speculation against the unsped run), plus a column-parallel
``qkv`` fault; every stream and ``EngineStats`` counter must equal the
local run's, on every rank (the ranks also check each record among
themselves).  ``mesh=1`` is the local engine and the reference's.  At
k = 4 the scaled model's 2 kv heads do not divide the axis: the rules
split a kv head, the ranks gather k and v whole and keep every kv head
(``models/attention.py``).

The per-shard plan is what runs: on the reference's ``SHARD_HW`` the
schemes ``protected_matmul`` resolves at TP=4 equal the TP=4 plan's rows.
The reference caveat: its ``protected_matmul`` resolves on the logical
(TP=1) GEMM shapes at trace time, so at mesh=4 it would execute the TP=1
schemes on the sites where the plans diverge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_mesh_worker as W
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import HardwareSpec as JHardwareSpec
from repro.core.intensity import GemmDims as JGemmDims
from repro.core.protected import ABFTConfig as JABFT
from repro.models import build_model
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro_torch.core.hardware import DEFAULT, HardwareSpec
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import build_mesh
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.executor import LocalExecutor, MeshExecutor

torch.set_num_threads(1)

# the reference's crafted point (tests/test_sharded_engine.py)
SHARD_HW = dict(name="shard-flip", peak_flops=2.4e13, vpu_flops=1e11,
                hbm_bw=1e12, ici_bw=1e11, hbm_bytes=1 << 34,
                vmem_bytes=1 << 24, fixed_op_overhead_s=1e-7)


@pytest.fixture(scope="module")
def setup():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    cfg = W.small_config()
    params = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, jp), dtype=torch.bfloat16)
    return jm, jp, Model(cfg), params


@pytest.fixture(scope="module")
def local(setup):
    _, _, model, params = setup
    return W.scenarios(model, params, None)


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ranks(request, setup):
    """One gloo pool of k ranks running every scenario."""
    _, _, _, params = setup
    k = request.param
    return k, spawn.run(W.mesh_scenarios, k, k, params, SHARD_HW,
                        device="cpu")


@pytest.fixture(scope="module")
def family_local():
    return W.family_scenarios(None)


# ------------------------------------------------------------- mesh = 1
def test_mesh1_streams_equal_local_and_reference(setup, local):
    jm, jp, model, params = setup
    cfg = model.cfg
    ref = JEngine(jm, jp, slots=3, max_len=64, dtype=jnp.bfloat16).run(
        [JRequest(r.uid, r.prompt, r.max_new_tokens) for r in W.reqs(cfg)])
    loc = local["dense"]["out"]
    eng = ServeEngine(model, params, slots=3, max_len=64,
                      dtype=torch.bfloat16, device="cpu", mesh=1)
    assert eng.model_parallel == 1 and eng.mesh.shape == \
        {"data": 1, "model": 1}
    assert eng.run(W.reqs(cfg)) == loc == ref


def test_mesh1_executor_matches_local(setup):
    _, _, model, params = setup
    from repro_torch.core.protected import ABFTConfig

    dev = torch.device("cpu")
    loc = LocalExecutor(model, params, dtype=torch.bfloat16, device=dev)
    m1 = MeshExecutor(model, params, mesh=1, dtype=torch.bfloat16,
                      device=dev)
    assert m1.model_parallel == 1 and m1.tp is None
    assert loc.protection_plan(ABFTConfig(), slots=4).to_json() == \
        m1.protection_plan(ABFTConfig(), slots=4).to_json()
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(loc.params),
        jax.tree_util.tree_leaves(m1.params)))


def test_mesh_executor_rejects_meshless_axis(setup):
    _, _, model, params = setup
    mesh = build_mesh(model=1, data=1)
    mesh.axis_names = ("x", "y")
    with pytest.raises(ValueError, match="model"):
        MeshExecutor(model, params, mesh=mesh, dtype=torch.bfloat16,
                     device=torch.device("cpu"))


# --------------------------------------------------------- mesh = 2, 4
SCENARIOS = ("dense", "paged", "shared_chunked", "faulted", "qkv_fault",
             "hard_fault", "unsped", "sped")


@pytest.mark.parametrize("name", SCENARIOS)
def test_mesh_streams_equal_local(ranks, local, name):
    k, recs = ranks
    for r, rec in enumerate(recs):
        assert rec[name] == local[name], (k, r, name)


def test_mesh_scenarios_exercise_their_paths(ranks, local):
    k, recs = ranks
    rec = recs[0]
    st = {n: rec[n]["stats"] for n in SCENARIOS}
    assert st["shared_chunked"]["prefix_tokens_shared"] > 0
    assert st["shared_chunked"]["prefill_chunks"] > 0
    assert rec["shared_chunked"]["blocks_used"] == 0
    assert st["faulted"]["faults_detected"] >= 2
    assert st["faulted"]["retries"] >= 2
    assert st["faulted"]["hard_faults"] == 0
    assert st["qkv_fault"]["faults_detected"] >= 1
    assert st["hard_fault"]["hard_faults"] == 1
    assert st["hard_fault"]["evictions"] >= 1
    assert st["sped"]["draft_accepted"] > 0
    assert rec["sped"]["streams"] == rec["unsped"]["streams"]
    assert rec["faulted"]["streams"] == local["paged"]["streams"]


# the local runs of these three are held against the reference's in
# tests/test_torch_family.py
FAMILY_SHARDED = {"qwen1.5-32b": {"mixer/bq", "mixer/bk", "mixer/bv"},
                  "qwen3-14b": set(), "stablelm-1.6b": set()}


@pytest.mark.parametrize("arch", W.FAMILY)
def test_dense_family_at_mesh2_equals_local(ranks, family_local, arch):
    """qwen1.5-32b's column-sharded q/k/v biases, qwen3-14b's per-head
    q/k norm on a shard and stablelm-1.6b's LayerNorm and partial rotary
    serve at k = 2 and 4, dense and paged, equal to their local runs on
    every rank."""
    k, recs = ranks
    want = family_local[arch]
    assert want["dense"]["stats"]["tokens"] > 0
    assert want["dense"]["streams"] == want["paged"]["streams"]
    for r, rec in enumerate(recs):
        got = rec["family"][arch]
        assert got["dense"] == want["dense"], (k, r, arch)
        assert got["paged"] == want["paged"], (k, r, arch)
    sharded = set(recs[0]["family"][arch]["sharded"])
    assert {"mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo", "ffn/up",
            "ffn/down"} | FAMILY_SHARDED[arch] <= sharded


def test_ranks_agree_and_report_the_mesh(ranks):
    k, recs = ranks
    assert all(rec == recs[0] for rec in recs)
    rec = recs[0]
    assert rec["model_parallel"] == k
    assert rec["mesh_shape"] == {"data": 1, "model": k}
    assert rec["backend"] == "gloo"


def test_plan_rows_carry_model_parallel(ranks, setup):
    k, recs = ranks
    _, _, model, _ = setup
    rows = recs[0]["plan_rows"]
    plan = model.protection_plan(hw=DEFAULT, n_tokens=2, model_parallel=k)
    assert [r["layer"] for r in rows] == \
        [r["layer"] for r in plan.report_rows()]
    for row, want in zip(rows, plan.report_rows()):
        assert row["model_parallel"] == k
        assert (row["n"], row["k"], row["scheme"]) == \
            (want["n"], want["k"], want["scheme"])


# ------------------------------------------------ the per-shard plan runs
def _shard_plans(model):
    return {k: model.protection_plan(hw=HardwareSpec(**SHARD_HW),
                                     n_tokens=64, model_parallel=k)
            for k in (1, 2, 4)}


def test_executed_schemes_equal_the_plan(ranks, setup):
    """Each rank's 64-token forward on ``SHARD_HW`` executes, site for
    site, the scheme of the TP=k plan's row."""
    k, recs = ranks
    plans = _shard_plans(setup[2])
    rows = {r["layer"]: r["scheme"] for r in plans[k].report_rows()}
    for rec in recs:
        assert rec["executed"] == {site: [rows[site]] for site in rows}
    if k == 4:
        r1 = {r["layer"]: r["scheme"] for r in plans[1].report_rows()}
        # the crafted point flips at least one site between the widths
        assert any(r1[s] != rows[s] for s in rows)


def test_reference_resolves_logical_shapes(setup):
    """The reference caveat: at trace time its ``protected_matmul`` sees
    GSPMD's logical (unsharded) GEMM, so it selects the TP=1 scheme where
    the TP=4 plan reports another."""
    plans = _shard_plans(setup[2])
    hw = JHardwareSpec(**SHARD_HW)
    r1 = {r["layer"]: r for r in plans[1].report_rows()}
    r4 = {r["layer"]: r for r in plans[4].report_rows()}
    diverged = [s for s in r1 if r1[s]["scheme"] != r4[s]["scheme"]]
    assert diverged
    for s in diverged:
        logical = JGemmDims(m=r1[s]["m"], k=r1[s]["k"], n=r1[s]["n"])
        assert JABFT(hardware=hw).resolve(logical).value == \
            r1[s]["scheme"] != r4[s]["scheme"]


# ------------------------------------------------------------ refusals
def _model_mesh(k):
    from repro_torch.distributed.mesh import Mesh

    return Mesh(grid=np.arange(k).reshape(1, k),
                axis_names=("data", "model"),
                devices=(torch.device("cpu"),) * k)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_unported_stacks_raise_at_model_gt_1(arch):
    """Encoder-decoder and vision (cross-attention) stacks refuse a model
    axis wider than 1, saying that the engine serves them at no width (as
    the reference's cannot); a mesh with data > 1 is admitted
    (``tests/test_torch_mesh_data.py`` serves it), and on it an unpadded
    split q head still raises naming ROADMAP A.3b-ii."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.serve.executor import check_shardable

    mesh = _model_mesh(2)
    with pytest.raises(NotImplementedError, match="at no width"):
        check_shardable(scaled_down(get_config(arch)), mesh)

    def dp(k):
        return Mesh(grid=np.arange(2 * k).reshape(2, k),
                    axis_names=("data", "model"),
                    devices=(torch.device("cpu"),) * (2 * k))

    check_shardable(W.small_config(), dp(2))
    # the scaled llama's 4 q heads over model = 8 would split one
    with pytest.raises(NotImplementedError, match="split a q head.*A.3b-ii"):
        check_shardable(W.small_config(), dp(8))
    check_shardable(W.small_config(), mesh)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "mamba2-1.3b", "jamba-v0.1-52b"])
def test_moe_and_ssm_stacks_shard(arch, k):
    """The MoE family, MLA with its MTP head, the SSM family and the
    hybrid serve over a model axis of 2 and 4, at full size and scaled
    down (``tests/test_torch_mesh_moe.py``, ``tests/test_torch_mesh_mla.py``,
    ``tests/test_torch_mesh_ssm.py`` run them)."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.serve.executor import check_shardable

    check_shardable(get_config(arch), _model_mesh(k))
    check_shardable(scaled_down(get_config(arch)), _model_mesh(k))


def test_serve_cli_mesh_flag(capsys):
    """``--mesh 1`` serves through the mesh executor in this process and
    reports the mesh in the stats line; ``--mesh 2`` serves the MoE
    family and MLA with its MTP head over two ranks; ``--mesh N`` on a
    layout the port does not shard (8 ranks over the smoke llama's 4 q
    heads would split one) or a stack the engine serves at no width exits
    with the ``NotImplementedError`` message before any rank starts."""
    import json

    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--mesh", "1", "--requests", "2",
                       "--new-tokens", "3", "--inject-faults"]) == 0
    out = capsys.readouterr().out
    line = next(json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{"))
    assert line["model_parallel"] == 1 and line["ranks_per_device"] == 1
    assert [r["layer"] for r in line["shard_plan"]] == [
        "attn.q", "attn.k", "attn.v", "attn.o", "mlp.up", "mlp.down",
        "lm_head"]
    for arch, site in (("qwen2-moe-a2.7b", "moe.expert_up"),
                       ("deepseek-v3-671b", "mla.q_b")):
        assert serve.main(["--device", "cpu", "--mesh", "2", "--arch",
                           arch, "--requests", "2",
                           "--new-tokens", "3"]) == 0
        line = next(json.loads(ln) for ln in capsys.readouterr().out
                    .splitlines() if ln.startswith("{"))
        assert line["model_parallel"] == 2 and line["tokens"] == 6
        assert site in [r["layer"] for r in line["shard_plan"]]
    with pytest.raises(SystemExit, match="split a q head.*A.3b-ii"):
        serve.main(["--device", "cpu", "--mesh", "8"])
    with pytest.raises(SystemExit, match="at no width"):
        serve.main(["--device", "cpu", "--mesh", "2", "--arch",
                    "whisper-tiny"])


# ---------------------------------------- stream equality across widths
# The reference's engine at mesh=1 and mesh=2 over two XLA host devices
# (tests/test_sharded_engine.py's set-up), its decode logits logged, under
# its CPU emulation of the block schemes (``use_pallas=False``, the setting
# the port's parity tests compare with).
REFERENCE_WIDTHS = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, scaled_down
from repro.core.protected import ABFTConfig
from repro.models import build_model
from repro.serve.engine import Request, ServeEngine
D = int(sys.argv[1])
cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2, d_model=D,
                  d_ff=4 * D, head_dim=D // 4)
model = build_model(cfg)
params = model.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
rng = np.random.default_rng(0)
reqs = [(i, rng.integers(1, cfg.vocab_size, size=rng.integers(4, 20))
         .astype(np.int32)) for i in range(6)]
out = {}
for k in (1, 2):
    log, decode = [], model.decode
    def logged(*a, **kw):
        lg, c, f = decode(*a, **kw)
        jax.debug.callback(lambda x: log.append(np.asarray(x)), lg)
        return lg, c, f
    model.decode = logged
    try:
        eng = ServeEngine(model, params, slots=3, max_len=64,
                          dtype=jnp.bfloat16, mesh=k,
                          abft=ABFTConfig(use_pallas=False))
        res = eng.run([Request(uid=u, prompt=p, max_new_tokens=5)
                       for u, p in reqs])
    finally:
        model.decode = decode
    out[f"logits{k}"] = np.stack(log)
    out[f"streams{k}"] = np.array([list(res[u]) for u, _ in reqs])
np.savez(sys.argv[2], **out)
"""
WIDE_D = 1024


def test_tp_widths_part_at_near_ties(tmp_path):
    """The reference's executor docstring says greedy bf16 streams are
    byte-identical at any TP width (``src/repro/serve/executor.py:33-38``).
    On a 2-layer llama at d_model 1024 its own engine's decode logits
    part between mesh=1 and mesh=2 under its CPU emulation: GSPMD sums
    the row-parallel GEMMs' f32 partials over the devices, in another
    order, and a bf16 rounding at a near-tie tips.  So the claim holds
    only away from near-ties, a reference caveat; the streams here agree
    on both sides.  The port's k = 2 logits on the same weights part from
    its k = 1 logits no more than the reference's do."""
    import os
    import subprocess
    import sys

    path = tmp_path / "widths.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", REFERENCE_WIDTHS, str(WIDE_D),
                    str(path)], env=env, check=True, capture_output=True)
    ref = np.load(path)
    assert (ref["logits1"] != ref["logits2"]).any()
    ref_gap = float(np.abs(ref["logits1"] - ref["logits2"]).max())
    assert np.array_equal(ref["streams1"], ref["streams2"])

    jm = build_model(jscaled(jget("llama3.2-1b"), n_layers=2, d_model=WIDE_D,
                             d_ff=4 * WIDE_D, head_dim=WIDE_D // 4))
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    params = params_from_reference(W.wide_config(WIDE_D),
                                   jax.tree_util.tree_map(np.asarray, jp),
                                   dtype=torch.bfloat16)
    local = W.decode_logits(WIDE_D, params, None)
    ranks = spawn.run(W.decode_logits, 2, WIDE_D, params, 2, device="cpu")
    assert np.array_equal(local[1], ref["streams1"])
    for logits, streams in ranks:
        assert np.array_equal(streams, local[1])
        assert float(np.abs(logits - local[0]).max()) <= ref_gap


def test_spawn_reports_every_failed_rank():
    """A rank that raises fails the run with its own traceback, even where
    its peer, blocked in a collective, fails too and reports first."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 "
                       "fails first"):
        spawn.run(W.failing_rank, 2, device="cpu")
