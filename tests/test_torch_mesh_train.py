"""Sharded training on the CPU: the port's train step, optimizer, trainer
and checkpoint over a ``(data=2, model=2)`` mesh of four gloo ranks
(``repro_torch.distributed.spawn``; one spawn runs every scenario,
workers in ``tests/test_torch_train_worker.py``) against the reference's
unsharded train step on the same parameters and batches.

The dense stack is scaled-down llama3.2-1b (2 layers, f32, the
reference's own parameters through numpy); each rank holds its model
shard, takes its two rows of each global batch of 4 x 16 and keeps its
ZeRO-1 shard of the moments.  Its runs: three AdamW steps, one step with
``grad_clip`` binding, one with ``microbatches=2``, one with
``compress_grads=True`` (one step: from the second on, the int8
rounding of the carried residual turns f32 noise into whole quanta) and
one under FSDP (``sharding.FSDP_THRESHOLD``
lowered in the ranks: every weight split over ``data`` too).  The
tolerances are ``tests/test_torch_train.py``'s, the same f32 arithmetic
with sums in another order: loss within 1e-5 relative, ``grad_norm``
within 1e-5 relative, each gathered gradient within 1e-4 of its leaf's
largest magnitude, params after steps 1 and 3 within 1e-5 absolute.

The reference's own sharded test
(``tests/test_flash_backend_integration.py::test_sharded_train_step_executes_on_8_devices``,
which fails on this jax) trains scaled qwen2-moe (2 layers, 4 experts,
d_model 64, vocab 128) DP+TP+EP with ``ShardingHints(dp_size=2,
moe_mode="ep")``: here at (2, 2) (two experts a rank) against the
reference's step with the same hints, jitted inside a one-device
``("data", "model")`` mesh (``jax.set_mesh``, as
``tests/test_torch_hints.py``): losses fall and no flag rises (the
reference test's own assertions), and each step's loss is within 1e-5
relative of the reference's.

Rank invariants: replicated leaves' gradients are equal on every rank;
the moments are ``shard_shape`` of ``opt_state_specs`` (a quarter of a
two-axis leaf); a fault at logical batch row 3 fires on data rank 1
alone, raises the flag on all four ranks and the retried step equals the
clean run's bit for bit.  Checkpoints: the (2, 2) trainer saves whole
leaves; ``restore(shardings=)`` reshards them onto (1, 2) (ranks 0 and
1 of the same world) and (1, 1), and the reference's ``Checkpointer``
reads them.  The CLI: ``launch/train.py --distributed`` under two ranks'
launcher environment prints the one-process CLI's losses.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_train_worker as TW
import torch

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import build_model
from repro.models.layers import ShardingHints as JHints
from repro.train import optimizer as jopt
from repro.train.train_step import (
    TrainConfig as JTrainConfig,
    make_loss_fn as jloss_fn,
    make_train_step as jstep_fn,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (
    map_with_path,
    opt_state_specs,
    param_specs,
    shard_shape,
    shard_slices,
)
from repro_torch.models.counting import count_params
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_KW = dict(n_layers=2, n_experts=4, d_model=64, vocab_size=128)
CLI_ARGS = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq",
            "16"]
# the (2, 2) geometry the parent assembles shards with
GEOM = Mesh(grid=np.arange(4).reshape(2, 2), axis_names=("data", "model"),
            devices=(torch.device("cpu"),) * 4)


def _jab():
    return JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_flat(cfg, jtree) -> dict:
    return TW.flat(params_from_reference(cfg, _np(jtree)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_procs(tmp) -> list:
    """``launch/train.py --distributed`` on two ranks, each with its
    launcher environment."""
    port = _free_port()
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS,
         "--distributed", "--ckpt-dir", str(tmp / f"cli{r}")],
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    cli = _cli_procs(tmp)
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, _np(jp))
    jmcfg = jscaled(jget("qwen2-moe-a2.7b"), **MOE_KW)
    jmm = build_model(jmcfg)
    jpm = jmm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    mcfg = scaled_down(get_config("qwen2-moe-a2.7b"), **MOE_KW)
    tpm = params_from_reference(mcfg, _np(jpm))
    ckpt = tmp / "ckpt"
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn.run, TW.train_rank, 4, cfg, tp, mcfg, tpm,
                      str(ckpt), count_params(cfg) - 1, device="cpu")
    yield {"cfg": cfg, "jm": jm, "jp": jp, "tp": tp, "mcfg": mcfg,
           "jmm": jmm, "jpm": jpm, "ckpt": ckpt, "fut": fut, "cli": cli,
           "tmp": tmp}
    pool.shutdown(wait=True)
    for p in cli:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def ref(setup):
    """The reference's unsharded steps on the same batches (while the
    ranks run): each dense run's losses, grad norms, params and first
    moments after every step, the first step's gradients, and the MoE
    run under the reference test's hints."""
    cfg, jm, jp = setup["cfg"], setup["jm"], setup["jp"]
    jab = _jab()
    out = {}
    for name, (ocfg, mb, steps) in TW.DENSE_RUNS.items():
        if name == "fsdp":
            continue
        jtc = JTrainConfig(opt=jopt.OptConfig(lr=3e-4, **ocfg),
                           microbatches=mb)
        jstep = jax.jit(jstep_fn(jm, jab, jtc))
        p, st = jp, jopt.init_opt_state(jp, jtc.opt)
        rec = {"loss": [], "grad_norm": [], "params": {}, "mu": {}}
        for s, b in enumerate(TW.batches(steps)):
            p, st, met = jstep(p, st, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            rec["loss"].append(float(met["loss"]))
            rec["grad_norm"].append(float(met["grad_norm"]))
            rec["params"][s] = _port_flat(cfg, p)
            rec["mu"][s] = _port_flat(cfg, st.mu)
        out[name] = rec
    (_, _), g = jax.jit(jax.value_and_grad(
        jloss_fn(jm, jab, JTrainConfig()), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in TW.batches(1)[0].items()})
    out["grads"] = _port_flat(cfg, g)
    out["fsdp"] = {k: v for k, v in out["adamw"].items()}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    jtc = JTrainConfig(opt=jopt.OptConfig(lr=TW.MOE_LR))
    hints = JHints(dp=("data",), dp_size=2, moe_mode="ep")
    moe = {"loss": [], "grad_norm": [], "flag": []}
    with jax.set_mesh(mesh):
        jstep = jax.jit(jstep_fn(setup["jmm"], jab, jtc, hints=hints))
        p, st = setup["jpm"], jopt.init_opt_state(setup["jpm"], jtc.opt)
        for b in TW.batches(TW.MOE_STEPS, vocab=setup["mcfg"].vocab_size,
                            seed=1):
            p, st, met = jstep(p, st, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            moe["loss"].append(float(met["loss"]))
            moe["grad_norm"].append(float(met["grad_norm"]))
            moe["flag"].append(bool(met["abft_flag"]))
    out["moe"] = moe
    return out


@pytest.fixture(scope="module")
def ranks(setup, ref):
    return setup["fut"].result()


def _specs(cfg, fsdp=None, opt=False) -> dict:
    shapes = Model(cfg).param_shapes()
    tree = (opt_state_specs(cfg, shapes, GEOM) if opt
            else param_specs(cfg, shapes, GEOM, fsdp=fsdp))
    out = {}
    map_with_path(lambda ps, sp: out.__setitem__(ps, sp), tree)
    return out


def _assemble(cfg, shards: list, specs: dict) -> dict:
    """Whole leaves from every rank's (coords, {path: shard}); ranks that
    hold the same part must hold the same bits."""
    full_shapes = _full_shapes(cfg)
    out = {}
    for coords, flat in shards:
        for k, a in flat.items():
            if k not in out:
                out[k] = np.full(full_shapes[k], np.nan, dtype=a.dtype)
            idx = shard_slices(specs[k], full_shapes[k], GEOM, coords)
            seen = out[k][idx]
            assert np.isnan(seen).all() or np.array_equal(seen, a), k
            out[k][idx] = a
    for k, v in out.items():
        assert not np.isnan(v).any(), k
    return out


def _full_shapes(cfg) -> dict:
    out = {}
    map_with_path(lambda ps, t: out.__setitem__(ps, tuple(t.shape)),
                  Model(cfg).param_shapes())
    return out


def _close(got: dict, want: dict, *, atol=None, rel_to_max=None):
    assert got.keys() == want.keys()
    for k in want:
        if rel_to_max is not None:
            assert np.abs(got[k] - want[k]).max() <= rel_to_max * max(
                np.abs(want[k]).max(), 1e-30), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)


def _dense(ranks, name, what, s):
    return [(r["coords"], r["dense"][name][what][s]) for r in ranks]


# ------------------------------------------------------------ dense stack
@pytest.mark.parametrize("name", list(TW.DENSE_RUNS))
def test_losses_and_grad_norms_match_reference(ranks, ref, name):
    want = ref[name]
    for r in ranks:
        got = r["dense"][name]
        n = len(got["loss"])
        np.testing.assert_allclose(got["loss"], want["loss"][:n], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"][:n],
                                   rtol=1e-5)
        assert not any(got["flag"])
    if name == "clip":
        # the clip binds: the unclipped norm is far above it
        assert want["grad_norm"][0] > 100 * TW.DENSE_RUNS["clip"][0][
            "grad_clip"]


@pytest.mark.parametrize("name", [n for n in TW.DENSE_RUNS if n != "int8"])
def test_params_after_first_and_last_step_match(setup, ranks, ref, name):
    cfg = setup["cfg"]
    specs = _specs(cfg, fsdp=name == "fsdp")
    steps = len(ranks[0]["dense"][name]["loss"])
    for s in sorted({0, steps - 1}):
        got = _assemble(cfg, _dense(ranks, name, "params", s), specs)
        _close(got, ref[name]["params"][s], atol=1e-5)


def test_int8_update_from_identical_gradients(setup, ranks):
    """``compress_grads``: the sharded update (each leaf's int8 amax over
    every rank's shard, the residuals sharded like their params, ZeRO-1)
    against the unsharded optimizer on the same gradients, gathered:
    params, residuals and moments within 1e-6 absolute
    (``tests/test_torch_train.py``'s tolerance for updates from identical
    gradients).  The reference's own run is held to the loss and the
    grad norm only: a gradient that differs in its last f32 bits can
    round to another int8 level, which AdamW turns into a step of up to
    lr."""
    from repro_torch.train import optimizer as topt

    cfg = setup["cfg"]
    pspecs = _specs(cfg)
    grads = _assemble(cfg, [(r["coords"], r["dense"]["int8"]["grads"])
                            for r in ranks], pspecs)
    params = setup["tp"]
    ocfg = topt.OptConfig(lr=3e-4, compress_grads=True)
    g = map_with_path(lambda ps, _: torch.from_numpy(grads[ps]), params)
    p1, st, _ = topt.update(g, topt.init_opt_state(params, ocfg), params,
                            ocfg)
    _close(_assemble(cfg, _dense(ranks, "int8", "params", 0), pspecs),
           TW.flat(p1), atol=1e-6)
    _close(_assemble(cfg, _dense(ranks, "int8", "mu", 0),
                     _specs(cfg, opt=True)), TW.flat(st.mu), atol=1e-6)
    _close(_assemble(cfg, [(r["coords"], r["dense"]["int8"]["err"])
                           for r in ranks], pspecs),
           {k: v.float().numpy() for k, v in
            zip(TW.flat(p1), _leaves(st.err))}, atol=1e-6)


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves

    return tree_leaves(tree)


def test_gathered_gradients_match_reference(setup, ranks, ref):
    cfg = setup["cfg"]
    got = _assemble(cfg, [(r["coords"], r["dense"]["adamw"]["grads"])
                          for r in ranks], _specs(cfg))
    _close(got, ref["grads"], rel_to_max=1e-4)


def test_replicated_gradients_equal_on_every_rank(ranks):
    digests = {r["dense"]["adamw"]["replicated_grads"] for r in ranks}
    assert len(digests) == 1


@pytest.mark.parametrize("name", ["adamw", "int8", "fsdp"])
def test_moments_are_zero1_shards(setup, ranks, name):
    """Each rank's ``mu``/``nu`` are its ``opt_state_specs`` shard (a
    quarter of a two-axis leaf at (2, 2)), and they assemble to the
    reference's moments; the error-feedback residuals shard like their
    params."""
    cfg = setup["cfg"]
    ospecs = _specs(cfg, opt=True)
    pspecs = _specs(cfg, fsdp=name == "fsdp")
    full = _full_shapes(cfg)
    for r in ranks:
        rec = r["dense"][name]
        for k, shape in rec["mu_shapes"].items():
            assert tuple(shape) == shard_shape(ospecs[k], full[k], GEOM), k
        for k, shape in rec["err_shapes"].items():
            want = (shard_shape(pspecs[k], full[k], GEOM) if name == "int8"
                    else ())
            assert tuple(shape) == want, k
    wq = full["layers/0/mixer/wq"]
    assert tuple(ranks[0]["dense"][name]["mu_shapes"][
        "layers/0/mixer/wq"]) == (wq[0] // 2, wq[1] // 2)


@pytest.mark.parametrize("name", ["adamw", "fsdp"])
def test_moments_assemble_to_the_references(setup, ranks, ref, name):
    """The ZeRO-1 shards of ``mu`` after the run's last step, gathered,
    against the reference's (``tests/test_torch_train.py``'s 1e-4 of
    each leaf's largest magnitude)."""
    cfg = setup["cfg"]
    s = len(ranks[0]["dense"][name]["loss"]) - 1
    got = _assemble(cfg, _dense(ranks, name, "mu", s), _specs(cfg, opt=True))
    _close(got, ref[name]["mu"][s], rel_to_max=1e-4)


def test_collectives_of_the_step(ranks):
    """Every kind of the train step's collectives ran, the same number
    on every rank."""
    counts = ranks[0]["counts"]
    assert all(r["counts"] == counts for r in ranks)
    for kind in ("model_sum", "model_max", "model_grad", "data_sum",
                 "grad_sum", "zero_gather", "world", "flag", "fsdp_gather",
                 "fsdp_grad"):
        assert counts[kind] > 0, kind
    # the loss is vocab-parallel: no logits are gathered over ``model``
    assert counts["model_gather"] == 0


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_vocab_parallel_loss_matches_the_gathered_loss(ranks, mesh):
    """The vocab-parallel loss (each rank's vocab slice of the logits and
    the MTP head's; the row max, the sum of exponentials and the label's
    logit reduced over ``model``) against the one-process loss over whole
    logits, on llama with an MTP head: loss, NLL and MTP NLL within 1e-5
    relative, each rank's gradient shards within 1e-4 of their leaf's
    largest magnitude (this file's tolerances) of the one-process
    gradients cut to the rank's shards.  The vocab-parallel step gathers
    no logits and takes one row max a head."""
    recs = [r["vocab"][mesh] for r in ranks if mesh in r["vocab"]]
    assert len(recs) == (2 if mesh == "1x2" else 4)
    for rec in recs:
        vp, whole = rec["vocab"], rec["whole"]
        for k in ("loss", "nll", "mtp"):
            np.testing.assert_allclose(vp[k], whole[k], rtol=1e-5)
        _close(vp["grads"], whole["grads"], rel_to_max=1e-4)
        assert vp["counts"]["model_gather"] == 0
        assert vp["counts"]["model_max"] == 2


# ------------------------------------------------------------ trainer
def test_row_fault_flags_every_rank_and_the_retry_is_clean(ranks):
    for r in ranks:
        tr = r["trainer"]
        assert [h[2] for h in tr["history"]] == [0, 1, 0]
        assert tr["events"] == [["abft_retry", 1], ["checkpoint", 1],
                                ["checkpoint", 2]]
        # logical row 3 L + 5 is data rank 1's local row L + 5
        want = [TW.L + 5] if r["coords"]["data"] == 1 else [None]
        assert tr["fault_rows"] == want
        clean = r["dense"]["adamw"]
        assert [h[1] for h in tr["history"]] == clean["loss"]
        for k, a in tr["params"].items():
            assert np.array_equal(a, clean["params"][2][k]), k
        for k, a in tr["mu"].items():
            assert np.array_equal(a, clean["mu"][2][k]), k


def test_checkpoint_restores_onto_1x2_and_1x1(setup, ranks):
    """The (2, 2) trainer's checkpoints reshard onto (1, 2) (its latest
    through ``Trainer.maybe_restore``) and (1, 1): every leaf bit-equal
    to the (2, 2) state assembled whole."""
    cfg = setup["cfg"]
    pspecs, ospecs = _specs(cfg), _specs(cfg, opt=True)
    for s, restored in ((2, [r["restore"]["latest"] for r in ranks[:2]]),
                        (1, [ranks[0]["restore"]["whole"]])):
        want_p = _assemble(cfg, _dense(ranks, "adamw", "params", s), pspecs)
        want_mu = _assemble(cfg, _dense(ranks, "adamw", "mu", s), ospecs)
        if len(restored) == 1:
            got_p, got_mu = restored[0]["params"], restored[0]["mu"]
        else:
            geo = [({"data": 0, "model": m}, rec) for m, rec in
                   enumerate(restored)]
            got_p = _assemble(cfg, [(c, rec["params"]) for c, rec in geo],
                              pspecs)
            # at data = 1 every moment is its param's model shard
            got_mu = _assemble(cfg, [(c, rec["mu"]) for c, rec in geo],
                               pspecs)
            assert all(rec["step"] == 3 for rec in restored)
        for k in want_p:
            assert np.array_equal(got_p[k], want_p[k]), k
            assert np.array_equal(got_mu[k], want_mu[k]), k


def test_restored_step_continues_the_run(ranks):
    want = ranks[0]["dense"]["adamw"]["loss"][2]
    for r in ranks[:2]:
        (step, loss), = r["restore"]["step3"]
        assert step == 2
        np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_reference_checkpointer_reads_the_sharded_save(setup, ranks):
    cfg = setup["cfg"]
    want = _assemble(cfg, _dense(ranks, "adamw", "params", 1), _specs(cfg))
    like = {"params": map_with_path(
        lambda ps, t: np.zeros(t.shape, np.float32),
        Model(cfg).param_shapes())}
    got, step = JCheckpointer(setup["ckpt"]).restore(like, step=1)
    assert step == 1
    flat = {}
    map_with_path(lambda ps, a: flat.__setitem__(ps, np.asarray(a)),
                  got["params"])
    for k, a in want.items():
        assert np.array_equal(flat[k], a), k


# ------------------------------------------------------------ MoE (EP)
def test_reference_sharded_moe_test_at_2x2(ranks, ref):
    want = ref["moe"]
    for r in ranks:
        got = r["moe"]
        assert not any(got["flag"]) and not any(want["flag"])
        assert got["loss"][-1] < got["loss"][0]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert got["experts_here"] == 2 and got["router_shape"] == [64, 4]


# ------------------------------------------------------------ CLI
def test_train_cli_distributed_prints_the_one_process_losses(setup,
                                                             capsys):
    from repro_torch.launch import train

    assert train.main([*CLI_ARGS, "--ckpt-dir",
                       str(setup["tmp"] / "cli")]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    outs = []
    for p in setup["cli"]:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]
        outs.append(out)
    rec = json.loads(outs[0].strip().splitlines()[-1])
    assert rec["world"] == 2 and rec["steps"] == 3
    np.testing.assert_allclose(rec["losses"], one["losses"], rtol=1e-5)
    # rank 1 trains beside rank 0 and prints no record
    assert not [ln for ln in outs[1].splitlines() if ln.startswith("{")]
