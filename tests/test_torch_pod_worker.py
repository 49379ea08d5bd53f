"""Rank-side workers of ``tests/test_torch_mesh_pod.py`` (no tests of
their own): functions a spawned rank of a world of four imports by name.
Each rank builds every mesh of the file (collectively, in the same
order), runs every scenario on it and returns its records."""

import dataclasses

import numpy as np
import test_torch_data_worker as WD
import test_torch_mesh_worker as W
import test_torch_train_families_worker as FW
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.distributed import collectives, sharding
from repro_torch.models.model import Model
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

BF16, F32 = torch.bfloat16, torch.float32
# the served scenarios held bit for bit between (2, 1, 2) and (2, 2); the
# fault's logical row 3 is pod rank 1's at (2, 1, 2), data rank 1's at
# (2, 2)
SERVE_NAMES = ("dense", "paged", "fault", "sped")
TRAIN_STEPS = 2
# 6 q and 6 kv heads of 16 over model = 4: the rules would split a head,
# so the executor and the train step pad them to 8 / 8 by default
PAD_HEADS = 8


def mesh(**shape):
    from repro_torch.distributed.mesh import build_mesh, rank_devices

    devs = rank_devices("cpu")
    n = int(np.prod(list(shape.values())))
    return build_mesh(devices=devs[:n], **shape)


def group_ranks(g, world: int = 4) -> list:
    """The ranks of a ``TPGroup``'s process group (None: the world)."""
    import torch.distributed as dist

    if g is None:
        return []
    if g.group is None:
        return list(range(world))
    return sorted(dist.get_process_group_ranks(g.group))


def pad_config():
    """A 6-head stack (qwen1.5-32b's biases, 6 kv heads, head dim 16)."""
    return scaled_down(get_config("qwen1.5-32b"), n_heads=6, n_kv_heads=6,
                       head_dim=16)


def whisper_config():
    """Scaled whisper-tiny with whisper-tiny's own 6 q and 6 kv heads."""
    return scaled_down(get_config("whisper-tiny"), n_heads=6, n_kv_heads=6,
                       head_dim=16)


def explicit(cfg):
    return dataclasses.replace(cfg, pad_heads_to=PAD_HEADS,
                               pad_kv_heads_to=PAD_HEADS)


def train_run(cfg, params, mesh, batches) -> dict:
    """``len(batches)`` AdamW steps at ``mesh`` (None: one process): each
    step's loss, grad norm and flag, the params after the last step (the
    rank's shards, numpy by path), the moments' shapes and the groups'
    ranks."""
    model = Model(cfg)
    tcfg = TrainConfig(opt=topt.OptConfig(lr=3e-4))
    step = make_train_step(model, FW.abft(), tcfg, mesh=mesh, device="cpu")
    pl = step.placement
    if mesh is not None:
        params = pl.model.shard_params(params, mesh)
    state = topt.init_opt_state(params, tcfg.opt,
                                pl.shards if pl is not None else None)
    rec = {"loss": [], "grad_norm": [], "flag": []}
    for b in batches:
        params, state, met = step(params, state, FW._t(b))
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        rec["flag"].append(bool(met["abft_flag"]))
    rec["params"] = FW.flat(params)
    rec["mu_shapes"] = {k: list(v.shape) for k, v in
                        FW.flat(state.mu).items()}
    if pl is not None:
        rec["groups"] = {n: group_ranks(getattr(pl, n))
                         for n in ("dp", "bp", "pp")}
        rec["fsdp"] = sorted(pl.dp.sharded) if pl.dp is not None else []
        rec["wq"] = list(params["layers"][0]["mixer"]["wq"].shape)
    return rec


def llama_batches(seed: int = 0) -> list:
    return FW.batches(W.small_config(), seed)[:TRAIN_STEPS]


def whisper_batches() -> list:
    return FW.batches(whisper_config(), 2)[:1]


def pod_rank(llama_bf16, llama_f32, pad_params, whisper_params,
             fsdp_thr) -> dict:
    """Every scenario of ``tests/test_torch_mesh_pod.py`` on this rank:
    llama's ``SERVE_NAMES`` at (data=2, model=2) and (pod=2, data=1,
    model=2); a one-slot dense run at (pod=2, data=2, model=1) (the cache
    sequence-sharded over ``data``) and at (data=2, model=1) on ranks 0
    and 1; llama trained at (2, 2, 1) with ZeRO-1 and with FSDP
    (``sharding.FSDP_THRESHOLD`` lowered to ``fsdp_thr``, this process
    only); the 6-head stack served and whisper trained at (1, 4), each
    with its heads padded by default and with an explicit
    ``pad_heads_to``."""
    import torch.distributed as dist

    rank = dist.get_rank()
    m22 = mesh(data=2, model=2)
    mpod = mesh(pod=2, data=1, model=2)
    mtr = mesh(pod=2, data=2, model=1)
    m14 = mesh(data=1, model=4)
    m21 = mesh(data=2, model=1)
    out = {"coords": {"m22": m22.coords(), "pod": mpod.coords(),
                      "train": mtr.coords()}}
    llama = Model(W.small_config())
    out["serve22"] = WD.data_scenarios(llama, llama_bf16, m22,
                                       names=SERVE_NAMES)
    out["servepod"] = WD.data_scenarios(llama, llama_bf16, mpod,
                                        names=SERVE_NAMES)
    eng = ServeEngine(llama, llama_bf16, slots=4, max_len=32, dtype=BF16,
                      device="cpu", mesh=mpod)
    ex = eng.executor
    out["pod_layout"] = {"rows": list(ex.rows),
                         "kv_rows": int(eng.cache[0]["k"].shape[0]),
                         "bp": group_ranks(ex.bp), "dp": group_ranks(ex.dp)}
    # one slot: the cache splits its positions over data, pods replicate
    def one_slot(m):
        rs = W.reqs(llama.cfg, n=3, seed=7, new_tokens=6)
        eng = ServeEngine(llama, llama_bf16, slots=1, max_len=64,
                          dtype=BF16, device="cpu", mesh=m)
        return eng, W._record(eng, rs, eng.run(rs))

    eng, rec = one_slot(mtr)
    sp = eng.executor.cache_split
    out["seq"] = {"split": [sp.kind, sp.lo, sp.n],
                  "dp": group_ranks(eng.executor.dp), "record": rec}
    if m21.holds(rank):
        out["seq21"] = one_slot(m21)[1]
    # training over pod x data
    out["train"] = train_run(W.small_config(), llama_f32, mtr,
                             llama_batches())
    sharding.FSDP_THRESHOLD = fsdp_thr
    try:
        out["train_fsdp"] = train_run(W.small_config(), llama_f32, mtr,
                                      llama_batches())
    finally:
        sharding.FSDP_THRESHOLD = 20e9
    # default head padding against an explicit pad_heads_to
    base = pad_config()
    recs = {}
    for name, cfg in (("default", base), ("explicit", explicit(base))):
        eng = ServeEngine(Model(cfg), pad_params, slots=3, max_len=64,
                          dtype=BF16, device="cpu", mesh=m14)
        rs = W.reqs(base, n=4, seed=1, new_tokens=5)
        rec = W._record(eng, rs, eng.run(rs, fault_at=(
            2, W.PAD_FAULTS["qkv"])))
        rec["heads"] = [eng.model.cfg.eff_heads, eng.model.cfg.eff_kv_heads]
        rec["wq"] = list(eng.executor.params["layers"][0]["mixer"]["wq"]
                         .shape)
        recs[name] = rec
    out["pad_serve"] = recs
    wcfg = whisper_config()
    out["pad_train"] = {
        name: train_run(cfg, whisper_params, m14, whisper_batches())
        for name, cfg in (("default", wcfg), ("explicit", explicit(wcfg)))}
    for key in ("serve22", "servepod", "pad_serve"):
        collectives.check_same(out[key], collectives.world_group(), key)
    collectives.check_same(out["seq"]["record"], collectives.world_group(),
                           "seq")
    return out
