"""Rank-side workers of ``tests/test_torch_mesh_train.py`` (no tests of
their own): functions a spawned rank of a ``(data=2, model=2)`` mesh
imports by name.  Each rank runs every training scenario of its mesh and
returns its records and its shards (numpy, by path), which the parent
assembles and holds against the reference."""

import hashlib

import torch

from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import collectives, sharding
from repro_torch.models import layers
from repro_torch.models.layers import ModelFault
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (
    TrainConfig,
    make_grad_fn,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig, state_shardings

B, L, VOCAB = 4, 16, 256
# the dense stack's runs: optimizer overrides, microbatches, steps
DENSE_RUNS = {"adamw": (dict(), 1, 3),
              "clip": (dict(grad_clip=1e-3), 1, 1),
              "micro": (dict(), 2, 1),
              "int8": (dict(compress_grads=True), 1, 1),
              "fsdp": (dict(), 1, 1)}
MOE_STEPS, MOE_LR = 3, 1e-3
# mlp_down at row 3 L + 5 of a block scheme's flattened (row, position)
# rows: logical batch row 3, data rank 1's row 1 at data = 2
ROW_FAULT = ModelFault.at(0, "mlp_down", FaultSpec.value(3 * L + 5, 1, 1e5))


def abft():
    return ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)


def batches(n: int, vocab: int = VOCAB, seed: int = 0) -> list:
    data = SyntheticLM(DataConfig(global_batch=B, seq_len=L,
                                  vocab_size=vocab, seed=seed))
    return [data.batch(s) for s in range(n)]


def flat(tree) -> dict:
    """{path: numpy} of a tensor tree (``"layers/0/mixer/wq"``)."""
    return {"/".join(str(k) for k in path): t.detach().cpu().numpy()
            for path, t in tree_leaves_with_path(tree)}


def _t(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def mesh_of(d: int, k: int, n: int | None = None):
    from repro_torch.distributed.mesh import build_mesh, rank_devices

    devs = rank_devices("cpu")
    return build_mesh(data=d, model=k, devices=devs[:n] if n else devs)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def dense_run(model, params, mesh, name: str) -> dict:
    """One of ``DENSE_RUNS`` at ``mesh``: every step's loss, grad norm and
    flag, the first step's gradients (summed over ``data``; adamw and
    int8), the int8 run's error-feedback residuals, the params
    and the first moments (ZeRO-1 shards) after every step, the moments'
    and the error-feedback residuals' shapes."""
    ocfg, mb, steps = DENSE_RUNS[name]
    tcfg = TrainConfig(opt=topt.OptConfig(lr=3e-4, **ocfg), microbatches=mb)
    step = make_train_step(model, abft(), tcfg, mesh=mesh, device="cpu")
    pl = step.placement
    params = model.shard_params(params, mesh)
    state = topt.init_opt_state(params, tcfg.opt, pl.shards)
    rec = {"loss": [], "grad_norm": [], "flag": [], "params": {}}
    for s, batch in enumerate(batches(steps)):
        if s == 0 and name in ("adamw", "int8"):
            grad_fn = make_grad_fn(model, abft(), tcfg, mesh=mesh,
                                   device="cpu")
            _, _, grads = grad_fn(params, _t(batch), ModelFault.none())
            rec["grads"] = flat(grads)
            specs = _specs(model, mesh)
            rec["replicated_grads"] = _digest(
                [g for k, g in sorted(rec["grads"].items())
                 if "model" not in sharding_axes(specs[k])])
        params, state, met = step(params, state, _t(batch))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        rec["flag"].append(bool(met["abft_flag"]))
        rec["params"][s] = flat(params)
        rec.setdefault("mu", {})[s] = flat(state.mu)
    rec["mu_shapes"] = {k: list(v.shape)
                        for k, v in flat(state.mu).items()}
    rec["err_shapes"] = {"/".join(str(k) for k in path): list(t.shape)
                         for path, t in tree_leaves_with_path(state.err)}
    if tcfg.opt.compress_grads:
        rec["err"] = {"/".join(str(k) for k in path): t.float().numpy()
                      for path, t in tree_leaves_with_path(state.err)}
    return rec


def sharding_axes(spec) -> set:
    out = set()
    for e in spec:
        out |= set(e) if isinstance(e, tuple) else ({e} if e else set())
    return out


def _specs(model, mesh) -> dict:
    """{path: spec} of the model's params on ``mesh``."""
    out = {}
    sharding.map_with_path(lambda ps, sp: out.__setitem__(ps, sp),
                           sharding.param_specs(model.cfg,
                                                model.param_shapes(), mesh))
    return out


def _faulty_trainer(model, params, mesh, ckpt_dir) -> Trainer:
    """A (data, model) ``Trainer`` of three AdamW steps saving after
    every step, whose step 1 is faulted on its first attempt
    (``ROW_FAULT``)."""
    tr = Trainer(model, params, TrainConfig(opt=topt.OptConfig(lr=3e-4)),
                 DataConfig(global_batch=B, seq_len=L, vocab_size=VOCAB),
                 TrainerConfig(steps=3, ckpt_every=1, ckpt_dir=ckpt_dir),
                 abft=abft(), device="cpu", mesh=mesh)
    base, tries = tr.step_fn, []

    def step(p, o, batch):
        first = tr.step == 1 and not tries
        if tr.step == 1:
            tries.append(1)
        return base(p, o, batch, fault=ROW_FAULT if first else None)

    tr.step_fn = step
    return tr


def trainer_run(model, params, mesh, ckpt_dir) -> dict:
    """The faulted (2, 2) trainer (``_faulty_trainer``): its history,
    events and final state, and the local row the fault landed on at
    each call of the faulted site on this rank (None: not this rank's
    row)."""
    log, row_fault = [], layers._row_fault

    def logged(fault, *a, **k):
        out = row_fault(fault, *a, **k)
        if fault is not None:
            log.append(None if out is None else int(out.row))
        return out

    layers._row_fault = logged
    try:
        tr = _faulty_trainer(model, params, mesh, ckpt_dir)
        hist = tr.run()
    finally:
        layers._row_fault = row_fault
    return {"history": [(h["step"], h["loss"], h["retries"]) for h in hist],
            "events": [list(e) for e in tr.events],
            "fault_rows": sorted(set(log), key=str),
            "params": flat(tr.params), "mu": flat(tr.opt_state.mu),
            "step": int(tr.opt_state.step)}


def restore_runs(model, params, ckpt_dir, rank: int) -> dict:
    """Reshard-on-restore: the (2, 2) checkpoints onto a (1, 2) mesh of
    ranks 0 and 1 (``Trainer.maybe_restore`` of the last, then the
    one after step 2 restored and step 3 run from it) and onto a (1, 1)
    mesh of rank 0."""
    mesh12 = mesh_of(1, 2, n=2)      # every rank takes part in its groups
    out = {}
    if rank < 2:
        tcfg = TrainConfig(opt=topt.OptConfig(lr=3e-4))
        dcfg = DataConfig(global_batch=B, seq_len=L, vocab_size=VOCAB)
        tr = Trainer(model, model.init_params(5, dtype=torch.float32,
                                              mesh=mesh12),
                     tcfg, dcfg, TrainerConfig(steps=3, ckpt_dir=ckpt_dir),
                     abft=abft(), device="cpu", mesh=mesh12)
        assert tr.maybe_restore() and tr.step == 2
        out["latest"] = {"params": flat(tr.params), "mu": flat(
            tr.opt_state.mu), "step": int(tr.opt_state.step)}
        state, step = tr.ckpt.restore(
            {"params": tr.params, "opt": tr.opt_state}, step=1,
            shardings=tr.shardings)
        tr.params, tr.opt_state, tr.step = state["params"], state["opt"], 2
        hist = tr.run()
        out["step3"] = [(h["step"], h["loss"]) for h in hist]
    if rank == 0:
        mesh11 = mesh_of(1, 1, n=1)
        from repro_torch.checkpoint.checkpoint import Checkpointer

        like = {"params": model.init_params(5, dtype=torch.float32),
                "opt": topt.init_opt_state(
                    model.init_params(5, dtype=torch.float32),
                    topt.OptConfig())}
        state, _ = Checkpointer(ckpt_dir).restore(
            like, step=1, shardings=state_shardings(model, mesh11))
        out["whole"] = {"params": flat(state["params"]),
                        "mu": flat(state["opt"].mu)}
    return out


def moe_run(model, params, mesh) -> dict:
    """The reference's own sharded test at (2, 2): DP+EP with its hints,
    three AdamW steps at lr 1e-3."""
    from repro_torch.models.layers import ShardingHints

    tcfg = TrainConfig(opt=topt.OptConfig(lr=MOE_LR))
    hints = ShardingHints(dp=("data",), dp_size=2, moe_mode="ep")
    step = make_train_step(model, abft(), tcfg, hints=hints, mesh=mesh,
                           device="cpu")
    params = model.shard_params(params, mesh)
    state = topt.init_opt_state(params, tcfg.opt, step.placement.shards)
    rec = {"loss": [], "grad_norm": [], "flag": [], "aux": []}
    for batch in batches(MOE_STEPS, vocab=model.cfg.vocab_size, seed=1):
        params, state, met = step(params, state, _t(batch))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        rec["flag"].append(bool(met["abft_flag"]))
    rec["router_shape"] = list(params["layers"][0]["ffn"]["router"].shape)
    rec["experts_here"] = int(params["layers"][0]["ffn"]["w_up"].shape[0])
    return rec


def train_rank(llama_cfg, llama_params, moe_cfg, moe_params, ckpt_dir,
               fsdp_thr) -> dict:
    """Every scenario of the (2, 2) mesh on this rank."""
    from repro_torch.models.model import Model

    mesh = mesh_of(2, 2)
    rank = mesh.rank
    model = Model(llama_cfg)
    out = {"coords": mesh.coords(), "dense": {}}
    collectives.reset_counts()
    for name in DENSE_RUNS:
        if name == "fsdp":
            sharding.FSDP_THRESHOLD = fsdp_thr
        try:
            out["dense"][name] = dense_run(model, llama_params, mesh, name)
        finally:
            sharding.FSDP_THRESHOLD = 20e9
    out["counts"] = dict(collectives.COUNTS)
    out["trainer"] = trainer_run(model, llama_params, mesh, ckpt_dir)
    out["restore"] = restore_runs(model, llama_params, ckpt_dir, rank)
    out["moe"] = moe_run(Model(moe_cfg), moe_params, mesh)
    collectives.check_same([out["dense"]["adamw"]["loss"],
                            out["trainer"]["history"], out["moe"]["loss"]],
                           collectives.world_group(), "train records")
    return out
