"""Training parity: the port's loss, gradients, optimizers, data, trainer
and checkpoints against the reference on scaled-down llama3.2-1b (2
layers, f32, the reference's own parameters converted through numpy).

The reference differentiates its XLA emulation of the block schemes
(``use_pallas=False``, as its train CLI does); the port differentiates K1's
plain version through K1's autograd wrapper, whose backward is plain
matmuls.  Tolerances (f32, sums in another order):

* loss within 1e-5 relative; gradients within 1e-4 relative of each
  leaf's largest magnitude; grad norm within 1e-5 relative;
* params after AdamW/SGD steps within 1e-5 absolute, lr / 30 (a step of
  lr = 3e-4 moves a param by at most ~lr; AdamW's normalization
  g / (|g| + eps) turns the gradients' rounding noise into up to ~1% of lr
  where |g| is within a few hundred eps);
* optimizer updates from identical gradients (compression included)
  within 1e-6 absolute: same arithmetic, f32 rounding only.

Checkpointer and runtime tests mirror ``tests/test_fault_tolerance.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.data.pipeline import (
    DataConfig as JData,
    MemmapCorpus as JMemmap,
    SyntheticLM as JSynth,
)
from repro.models import build_model
from repro.train import optimizer as jopt
from repro.train.train_step import (
    TrainConfig as JTrainConfig,
    make_loss_fn as jloss_fn,
    make_train_step as jstep_fn,
)
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JRCfg
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import (
    DataConfig,
    MemmapCorpus,
    Prefetcher,
    SyntheticLM,
)
from repro_torch.models.model import Model, params_from_reference
from repro_torch.runtime.elastic import ElasticState, plan_remesh, rescale_batch
from repro_torch.runtime.heartbeat import HeartbeatMonitor, StragglerPolicy
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (
    TrainConfig,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

B, L = 2, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jm, jp, Model(cfg), tp


def _abft(flash=False):
    return (JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU),
            ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E,
                                   flash_attention=flash))


def _batch(step=0):
    return JSynth(JData(global_batch=B, seq_len=L, vocab_size=256)).batch(
        step)


def _to_port(cfg, jtree):
    return params_from_reference(cfg, jax.tree_util.tree_map(np.asarray,
                                                             jtree))


def _close_trees(cfg, got, jtree, rtol=None, atol=None, rel_to_max=None):
    want = _to_port(cfg, jtree)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().numpy(), w.numpy()
        if rel_to_max is not None:
            assert np.abs(g - w).max() <= rel_to_max * max(
                np.abs(w).max(), 1e-30)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------------ loss / grads

def test_loss_and_gradients_match_reference(setup):
    cfg, jm, jp, tm, tp = setup
    jab, tab = _abft()
    batch = _batch()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        jloss_fn(jm, jab, JTrainConfig()), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (tl, tmet), tg = value_and_grad(
        make_loss_fn(tm, tab, TrainConfig(), device="cpu"))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert bool(tmet["abft_flag"]) is False and bool(jmet["abft_flag"]) is \
        False
    _close_trees(cfg, tg, jg, rel_to_max=1e-4)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-5)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_params_after_one_and_three_steps_match(setup, name):
    cfg, jm, jp, tm, tp = setup
    jab, tab = _abft()
    ocfg = dict(name=name, lr=3e-4)
    jstep = jax.jit(jstep_fn(jm, jab, JTrainConfig(opt=jopt.OptConfig(
        **ocfg))))
    tstep = make_train_step(tm, tab, TrainConfig(opt=topt.OptConfig(**ocfg)),
                            device="cpu")
    jstate = jopt.init_opt_state(jp, jopt.OptConfig(**ocfg))
    tstate = topt.init_opt_state(tp, topt.OptConfig(**ocfg))
    jpar, tpar = jp, tp
    for s in range(3):
        batch = _batch(s)
        jpar, jstate, jmet = jstep(jpar, jstate,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tpar, tstate, tmet = tstep(tpar, tstate,
                                   {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        if s in (0, 2):
            _close_trees(cfg, tpar, jpar, rtol=0, atol=1e-5)
    assert int(tstate.step) == int(jstate.step) == 3
    _close_trees(cfg, tstate.mu, jstate.mu, rel_to_max=1e-4)


@pytest.mark.parametrize("ocfg", [
    dict(), dict(compress_grads=True), dict(name="sgd"),
    dict(moment_dtype="bfloat16"), dict(weight_decay=0.0, grad_clip=1e-3)],
    ids=["adamw", "int8", "sgd", "bf16_moments", "clip"])
def test_optimizer_updates_from_identical_gradients(ocfg):
    rng = np.random.default_rng(4)
    shapes = {"w": (8, 16), "b": (16,), "emb": (32, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jc, tc = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    for _ in range(3):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jc)
        tp, ts, tm = topt.update({k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts, tp, tc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
    if tc.compress_grads:
        for k in shapes:
            assert ts.err[k].dtype == torch.bfloat16
            np.testing.assert_allclose(
                ts.err[k].float().numpy(),
                np.asarray(js.err[k].astype(jnp.float32)), atol=1e-6)


def test_weight_decay_follows_the_references_stacked_layout(setup):
    """The reference decays leaves of >= 2 dims of its scan-stacked tree:
    every per-layer leaf (norm gains included), never the final norm."""
    cfg, jm, jp, tm, tp = setup
    mask = topt.decayed(tp)
    assert mask["embed"] and not mask["final_norm"]["w"]
    for layer in mask["layers"]:
        assert all(tree_leaves(layer))
    assert np.asarray(jp["segments"][0]["pos0"]["mixer_norm"]["w"]).ndim \
        == 2


def test_lr_schedule_matches_reference():
    for s in (0, 50, 100, 5000, 10000, 20000):
        np.testing.assert_allclose(
            float(topt.lr_schedule(s, 3e-4)),
            float(jopt.lr_schedule(jnp.asarray(s), 3e-4)), rtol=1e-6)


def test_microbatched_step_matches_reference(setup):
    cfg, jm, jp, tm, tp = setup
    jab, tab = _abft()
    jstep = jax.jit(jstep_fn(jm, jab, JTrainConfig(microbatches=2)))
    tstep = make_train_step(tm, tab, TrainConfig(microbatches=2),
                            device="cpu")
    batch = _batch(1)
    jpar, _, jmet = jstep(jp, jopt.init_opt_state(jp, jopt.OptConfig()),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tpar, _, tmet = tstep(tp, topt.init_opt_state(tp, topt.OptConfig()),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _close_trees(cfg, tpar, jpar, rtol=0, atol=1e-5)


def test_flash_attention_under_autograd_raises(setup):
    cfg, jm, jp, tm, tp = setup
    _, tab = _abft(flash=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(NotImplementedError):
        value_and_grad(make_loss_fn(tm, tab, TrainConfig(), device="cpu"))(
            tp, batch)


def test_faulted_step_raises_the_flag_and_leaves_state_alone(setup):
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    cfg, jm, jp, tm, tp = setup
    _, tab = _abft()
    step = make_train_step(tm, tab, TrainConfig(), device="cpu")
    state = topt.init_opt_state(tp, topt.OptConfig())
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    snap = [p.clone() for p in tree_leaves(tp)]
    _, _, met = step(tp, state, batch, fault=ModelFault.at(
        0, "mlp_down", FaultSpec.value(0, 1, 1e5)))
    assert bool(met["abft_flag"]) is True
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(tp)))
    p1, _, m1 = step(tp, state, batch)
    p2, _, m2 = step(tp, state, batch)
    assert bool(m1["abft_flag"]) is False
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


# ------------------------------------------------------------ data

def test_synthetic_and_memmap_batches_are_the_references(tmp_path):
    for cfg_kw in (dict(global_batch=4, seq_len=32, vocab_size=500),
                   dict(global_batch=2, seq_len=8, vocab_size=50, seed=3)):
        for step in (0, 1, 7):
            a = SyntheticLM(DataConfig(**cfg_kw)).batch(step)
            b = JSynth(JData(**cfg_kw)).batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
            h = SyntheticLM(DataConfig(**cfg_kw)).batch(step, 1, 2)
            np.testing.assert_array_equal(
                h["tokens"], JSynth(JData(**cfg_kw)).batch(step, 1, 2)[
                    "tokens"])
    pf = Prefetcher(SyntheticLM(DataConfig(**cfg_kw)), start_step=3)
    try:
        for step in (3, 4):
            got_step, got = pf.next()
            assert got_step == step
            np.testing.assert_array_equal(
                got["tokens"], JSynth(JData(**cfg_kw)).batch(step)["tokens"])
    finally:
        pf.close()
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 1000, size=5000).astype(
        np.int32).tofile(path)
    dc = dict(global_batch=3, seq_len=16, vocab_size=1000)
    for step in (0, 5):
        a = MemmapCorpus(str(path), DataConfig(**dc)).batch(step)
        b = JMemmap(str(path), JData(**dc)).batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ trainer

def test_trainer_history_and_restart_match_reference(setup, tmp_path):
    cfg, jm, jp, tm, tp = setup
    jab, tab = _abft()
    dcfg = dict(global_batch=B, seq_len=L, vocab_size=256)
    steps = 6
    jt = JTrainer(jm, jp, JTrainConfig(), JData(**dcfg),
                  JRCfg(steps=steps, ckpt_every=4,
                        ckpt_dir=str(tmp_path / "j")), abft=jab)
    tt = Trainer(tm, tp, TrainConfig(), DataConfig(**dcfg),
                 TrainerConfig(steps=steps, ckpt_every=4,
                               ckpt_dir=str(tmp_path / "t")),
                 abft=tab, device="cpu")
    jh, th = jt.run(), tt.run()
    assert len(th) == len(jh) == steps
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    assert [h["retries"] for h in th] == [0] * steps
    assert tt.events == jt.events == [("checkpoint", 4)]
    # restart: both resume AT the saved step (which already holds its own
    # update) with the saved state
    jt2 = JTrainer(jm, jp, JTrainConfig(), JData(**dcfg),
                   JRCfg(steps=steps, ckpt_dir=str(tmp_path / "j")),
                   abft=jab)
    tt2 = Trainer(tm, tp, TrainConfig(), DataConfig(**dcfg),
                  TrainerConfig(steps=steps, ckpt_dir=str(tmp_path / "t")),
                  abft=tab, device="cpu")
    assert jt2.maybe_restore() and tt2.maybe_restore()
    assert tt2.step == jt2.step == 4
    _close_trees(cfg, tt2.params, jt2.params, rtol=0, atol=1e-5)
    assert int(tt2.opt_state.step) == int(jt2.opt_state.step) == 5


def test_trainer_needs_cuda_or_an_explicit_cpu(setup, monkeypatch):
    cfg, jm, jp, tm, tp = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tm, tp, TrainConfig(), DataConfig(2, 8, 256),
                TrainerConfig(steps=1))


def test_trainer_retries_flagged_steps_then_records_a_hard_fault(
        setup, tmp_path):
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    cfg, jm, jp, tm, tp = setup
    _, tab = _abft()
    tr = Trainer(tm, tp, TrainConfig(), DataConfig(B, L, 256),
                 TrainerConfig(steps=2, max_retries=2,
                               ckpt_dir=str(tmp_path)),
                 abft=tab, device="cpu")
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    base = tr.step_fn

    def faulty(params, opt, batch):
        return base(params, opt, batch, fault=fault if tr.step == 1 else None)

    tr.step_fn = faulty
    hist = tr.run()
    assert [h["retries"] for h in hist] == [0, 2]
    assert tr.events == [("abft_retry", 1), ("abft_retry", 1),
                         ("abft_hard_fault", 1)]


# ------------------------------------------------------------ checkpoint

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {
            "w": torch.from_numpy(r.standard_normal((8, 16)).astype(
                np.float32)),
            "b": torch.from_numpy(r.standard_normal((16,)).astype(
                np.float32)),
            "h": torch.from_numpy(r.standard_normal((4, 4)).astype(
                np.float32)).bfloat16(),
        },
        "opt": topt.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                               mu=[torch.ones(3)], nu=[torch.zeros(3)],
                               err=[torch.zeros(())]),
    }


def test_checkpoint_roundtrip_with_a_bf16_leaf(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(5, tree)
    restored, step = ck.restore(tree)
    assert step == 5
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"], tree["params"]["h"])
    assert isinstance(restored["opt"], topt.AdamWState)
    assert int(restored["opt"].step) == 7
    assert restored["opt"].step.dtype == torch.int32


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    path = ck.save(1, tree)
    blob = sorted(path.glob("leaf_*.npy"))[0]
    raw = bytearray(blob.read_bytes())
    raw[-1] ^= 0xFF
    blob.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum mismatch"):
        ck.restore(tree)


def test_checkpoint_atomic_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_000000003", "step_000000004"]
    assert ck.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_*"))


def test_checkpoint_async_overlap_snapshots_the_tree(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    want = tree["params"]["w"].clone()
    ck.save_async(10, tree)
    tree["params"]["w"].add_(1.0)       # a later in-place write
    ck.wait()
    restored, step = ck.restore(tree)
    assert step == 10
    assert torch.equal(restored["params"]["w"], want)


def test_checkpoint_reshard_waits_for_sharding(tmp_path):
    """Reshard-on-restore at a one-rank mesh (no process group): every
    leaf comes back whole and bit-equal under any spec, the sharded
    save in one process is the plain one, and specs that split a leaf
    over an axis keep that axis' part at the rank's coordinates (a
    (1, 2) geometry seen from model rank 1)."""
    from repro_torch.distributed.mesh import Mesh, build_mesh
    from repro_torch.distributed.sharding import P, make_sharding

    ck = Checkpointer(tmp_path)
    tree = _tree()
    specs = {"params": {"w": P(None, "model"), "b": P("model"),
                        "h": P("data", None)},
             "opt": topt.AdamWState(step=P(), mu=[P(None)],
                                    nu=[P(None)], err=[P()])}
    one = build_mesh(data=1, model=1, devices=[torch.device("cpu")])
    ck.save(2, tree, shardings=make_sharding(one, specs))
    restored, step = ck.restore(tree, shardings=make_sharding(one, specs))
    assert step == 2
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    half = Mesh(grid=np.arange(2).reshape(1, 2), axis_names=("data",
                                                             "model"),
                devices=(torch.device("cpu"),) * 2, rank=1)
    like = dict(tree, params={"w": tree["params"]["w"][:, 8:],
                              "b": tree["params"]["b"][8:],
                              "h": tree["params"]["h"]})
    got, _ = ck.restore(like, shardings=make_sharding(half, specs))
    assert torch.equal(got["params"]["w"], tree["params"]["w"][:, 8:])
    assert torch.equal(got["params"]["b"], tree["params"]["b"][8:])
    assert torch.equal(got["params"]["h"], tree["params"]["h"])
    assert int(got["opt"].step) == 7
    assert torch.equal(got["opt"].mu[0], tree["opt"].mu[0])


# ------------------------------------------------------------ runtime

def test_plan_remesh_and_rescale_batch():
    plan = plan_remesh(512, model_parallel=16)
    assert plan.shape == (32, 16)
    plan = plan_remesh(500, model_parallel=16)
    assert plan.shape == (31, 16)
    assert plan.devices_idle == 500 - 31 * 16
    with pytest.raises(RuntimeError):
        plan_remesh(8, model_parallel=16)
    r = rescale_batch(256, old_data=16, new_data=15)
    assert r["per_replica"] * 15 >= 256
    assert r["pad"] == r["padded_global"] - 256
    assert 0 < r["grad_scale"] <= 1.0


def test_elastic_and_heartbeat_control_plane():
    st = ElasticState(model_parallel=4, spares=[f"s{i}" for i in range(4)],
                      active=[f"w{i}" for i in range(16)])
    plan = st.on_failure(["w3", "w7"])
    assert len(st.active) % 4 == 0 and plan.data == len(st.active) // 4
    now = [0.0]
    hb = HeartbeatMonitor(["a", "b"], timeout_s=5.0, clock=lambda: now[0])
    now[0] = 3.0
    hb.beat("a")
    now[0] = 6.0
    assert hb.check() == ["b"] and hb.alive == ["a"]
    sp = StragglerPolicy(threshold=1.5, window=4, min_samples=2)
    for _ in range(3):
        sp.record("fast", 1.0)
        sp.record("fast2", 1.0)
        sp.record("slow", 3.0)
    assert sp.stragglers() == ["slow"]


def test_train_cli_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train

    assert train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    rec = json.loads(out)
    assert rec["steps"] == 2 and np.isfinite(rec["last_loss"])
    assert rec["losses"][-1] == rec["last_loss"] and rec["world"] == 1
    # --distributed joins the launcher's process group: without its
    # environment it exits naming what is missing
    for key in train.LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit, match="RANK, WORLD_SIZE, MASTER_ADDR, "
                       "MASTER_PORT not set"):
        train.main(["--device", "cpu", "--distributed"])


def test_dataclass_configs_mirror_the_reference():
    for ours, theirs in ((topt.OptConfig, jopt.OptConfig),
                         (TrainConfig, JTrainConfig),
                         (DataConfig, JData)):
        a = {f.name for f in dataclasses.fields(ours)}
        b = {f.name for f in dataclasses.fields(theirs)}
        assert a == b
