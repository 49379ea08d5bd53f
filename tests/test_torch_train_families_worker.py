"""Rank-side workers of ``tests/test_torch_mesh_train_families.py`` (no
tests of their own): functions a spawned rank of a ``(data=2, model=2)``
mesh imports by name.  Each rank trains every family of the file on its
shard and returns its records and its shards (numpy, by path), which the
parent assembles and holds against the reference."""

import hashlib

import numpy as np
import torch

from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import collectives, sharding
from repro_torch.models.layers import ModelFault
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (
    TrainConfig,
    make_grad_fn,
    make_train_step,
)

B, L, STEPS, LR = 4, 16, 2, 3e-4
# the family whose sharded state is saved at (2, 2) and restored onto
# (1, 2), with bf16 moments under ZeRO-1 (the reference's dry run keeps
# deepseek's moments in bf16)
CKPT_FAMILY = "vision"


def abft():
    return ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)


def opt_config(name: str) -> topt.OptConfig:
    return topt.OptConfig(lr=LR, moment_dtype="bfloat16"
                          if name == CKPT_FAMILY else "float32")


def batches(cfg, seed: int) -> list:
    """``STEPS`` global batches of B x L tokens and labels (numpy from
    ``seed``), with the config's memory input: whisper's ``audio`` (2 x
    ``enc_seq_len`` mel frames, through the conv stem), the vision
    model's ``images``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, (B, L + 1))
        b = {"tokens": t[:, :-1].astype(np.int32),
             "labels": t[:, 1:].astype(np.int32)}
        if cfg.is_encoder_decoder:
            b["audio"] = rng.standard_normal(
                (B, 2 * cfg.enc_seq_len, cfg.n_mels)).astype(np.float32)
        if cfg.vision_dim:
            b["images"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
        out.append(b)
    return out


def flat(tree) -> dict:
    """{path: numpy} of a tensor tree (``"layers/0/mixer/wq"``)."""
    return {"/".join(str(k) for k in path): t.detach().float().cpu().numpy()
            for path, t in tree_leaves_with_path(tree)}


def _t(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def mesh_of(d: int, k: int, n: int | None = None):
    from repro_torch.distributed.mesh import build_mesh, rank_devices

    devs = rank_devices("cpu")
    return build_mesh(data=d, model=k, devices=devs[:n] if n else devs)


def model_split(model, mesh) -> dict:
    """{path: whether the rules split the leaf over ``model``}."""
    out = {}

    def one(ps, sp):
        axes = set()
        for e in sp:
            axes |= set(e) if isinstance(e, tuple) else ({e} if e else set())
        out[ps] = "model" in axes

    sharding.map_with_path(one, sharding.param_specs(
        model.cfg, model.param_shapes(), mesh))
    return out


def family_run(name, cfg, params, seed, mesh, ckpt_dir) -> dict:
    """One family at (2, 2): the first batch's gradients (summed over
    ``data``) and a sha256 of each replicated leaf's, then ``STEPS``
    AdamW steps, each step's metrics and the params after it (the rank's
    shards); for ``CKPT_FAMILY`` the state after the last step saved
    whole (``Checkpointer.save(shardings=)``) and the moments' dtype."""
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import state_shardings

    model = Model(cfg)
    tcfg = TrainConfig(opt=opt_config(name))
    step = make_train_step(model, abft(), tcfg, mesh=mesh, device="cpu")
    params = model.shard_params(params, mesh)
    bs = batches(cfg, seed)
    grad_fn = make_grad_fn(model, abft(), tcfg, mesh=mesh, device="cpu")
    _, _, grads = grad_fn(params, _t(bs[0]), ModelFault.none())
    rec = {"grads": flat(grads), "steps": [],
           "shapes": {k: list(v.shape) for k, v in flat(params).items()}}
    split = model_split(model, mesh)
    rec["replicated"] = {k: hashlib.sha256(g.tobytes()).hexdigest()
                         for k, g in rec["grads"].items() if not split[k]}
    state = topt.init_opt_state(params, tcfg.opt, step.placement.shards)
    for b in bs:
        params, state, met = step(params, state, _t(b))
        rec["steps"].append({
            "metrics": {k: (bool(v) if k == "abft_flag" else float(v))
                        for k, v in met.items()},
            "params": flat(params)})
    if name == CKPT_FAMILY:
        from repro_torch.checkpoint.checkpoint import Checkpointer

        Checkpointer(ckpt_dir).save(
            STEPS, {"params": params, "opt": state},
            shardings=state_shardings(model, mesh))
        rec["mu"] = flat(state.mu)
        rec["mu_dtype"] = str(next(iter(
            t for _, t in tree_leaves_with_path(state.mu))).dtype)
    return rec


def restore_run(cfg, ckpt_dir, rank: int) -> dict | None:
    """The saved (2, 2) state restored onto a (1, 2) mesh of ranks 0 and
    1 (every rank takes part in its groups): the rank's params and first
    moments."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import state_shardings

    mesh12 = mesh_of(1, 2, n=2)
    if rank >= 2:
        return None
    model = Model(cfg)
    params = model.init_params(5, dtype=torch.float32, mesh=mesh12)
    step = make_train_step(model, abft(), TrainConfig(), mesh=mesh12,
                           device="cpu")
    like = {"params": params, "opt": topt.init_opt_state(
        params, opt_config(CKPT_FAMILY), step.placement.shards)}
    state, got = Checkpointer(ckpt_dir).restore(
        like, step=STEPS, shardings=state_shardings(model, mesh12))
    return {"step": got, "coords": mesh12.coords(),
            "params": flat(state["params"]), "mu": flat(state["opt"].mu)}


def families_rank(cases: dict, ckpt_dir: str) -> dict:
    """Every family of ``cases`` ({name: (cfg, full params, batch seed)})
    trained at (2, 2) on this rank, then (with ``CKPT_FAMILY`` among
    them) its checkpoint restored onto (1, 2); the records checked equal
    over the world."""
    mesh = mesh_of(2, 2)
    out = {"coords": mesh.coords(), "families": {}}
    collectives.reset_counts()
    for name, (cfg, params, seed) in cases.items():
        out["families"][name] = family_run(name, cfg, params, seed, mesh,
                                           ckpt_dir)
    out["counts"] = dict(collectives.COUNTS)
    if CKPT_FAMILY in cases:
        out["restore"] = restore_run(cases[CKPT_FAMILY][0], ckpt_dir,
                                     mesh.rank)
    collectives.check_same(
        {n: [s["metrics"] for s in f["steps"]]
         for n, f in out["families"].items()},
        collectives.world_group(), "family records")
    return out
