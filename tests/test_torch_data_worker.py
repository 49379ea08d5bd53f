"""Rank-side workers of ``tests/test_torch_mesh_data.py`` and
``tests/test_torch_seq_shard.py`` (no tests of their own): functions a
spawned rank of a ``(data, model)`` mesh imports by name.  Each rank runs
every scenario of its mesh, checks that every rank holds the same record
(``collectives.check_same`` over the world) and returns the records."""

import numpy as np
import test_torch_mesh_worker as W
import torch

from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import ABFTConfig
from repro_torch.distributed import collectives, sharding
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, _cut
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

BF16 = torch.bfloat16
F32 = torch.float32
# mlp_down at logical row 3 of a 4-slot decode: data rank 1's row 1 at
# data = 2 (its slots 2 and 3), rank 0 runs no row of it
ROW3 = ModelFault.at(0, "mlp_down", FaultSpec.value(3, 1, 1e5))
SLOTS = 4
STATS = W.STATS + ("cow_copies",)


def mesh_of(d: int, k: int):
    from repro_torch.distributed.mesh import build_mesh, rank_devices

    return build_mesh(data=d, model=k, devices=rank_devices("cpu"))


def cross_share_reqs(cfg):
    """Five requests on four slots: request 2 finishes first, so request
    4, which opens with request 0's first 12 tokens, takes slot 2 (data
    rank 1's at data = 2) and shares the prefix that request 0 (slot 0,
    data rank 0's) prefilled."""
    rs = W.reqs(cfg, n=5, seed=3, new_tokens=6)
    rs[0].prompt = np.concatenate([rs[0].prompt, rs[1].prompt])[:18]
    rs[2].max_new_tokens = 2
    rs[4].prompt = np.concatenate([rs[0].prompt[:12],
                                   rs[4].prompt]).astype(np.int32)
    return rs


def _fresh(rs):
    return [Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in rs]


def _record(eng, rs, out) -> dict:
    rec = W._record(eng, rs, out)
    rec["stats"] = {k: getattr(eng.stats, k) for k in STATS}
    return rec


def _slot_log(eng) -> dict:
    """Wrap ``eng.admit``: {uid: slot} of every admitted request."""
    slots, admit = {}, eng.admit

    def logged(*a, **k):
        out = admit(*a, **k)
        for s, req in eng.active.items():
            slots.setdefault(int(req.uid), int(s))
        for s, cur in eng._prefill_cursors.items():
            slots.setdefault(int(cur.req.uid), int(s))
        return out

    eng.admit = logged
    return slots


def _index_cells_agree(eng, dp) -> list:
    """Wrap ``eng.step``: after every step, every cell a prefix match can
    read (each registered block's first ``len(tokens)`` cells, of every
    pool) digested and checked equal over the data axis; returns the
    number of cells checked a step."""
    import hashlib

    seen, step = [], eng.step

    def checked(*a, **k):
        r = step(*a, **k)
        idx = eng.index
        ents = [e for e in idx._full.values()] + [
            e for cand in idx._partial.values() for e in cand]
        h = hashlib.sha256()
        for blk, toks in sorted(ents):
            for layer in eng.cache:
                for leaf in layer.values():
                    h.update(leaf[blk, :len(toks)].float().numpy()
                             .tobytes())
        collectives.check_same(h.hexdigest(), dp, "prefix cells")
        seen.append(sum(len(t) for _, t in ents))
        return r

    eng.step = checked
    return seen


def data_scenarios(model, params, mesh, hints=None, names=None) -> dict:
    """The served scenarios of one stack at ``mesh`` (None: local) on
    four slots (two under speculation): dense, paged, chunked + prefix
    shared across the data ranks, a decode fault on logical row 3 and
    an admission fault retried, hard-fault eviction, unsped and n-gram
    speculation."""
    cfg = model.cfg
    kw = dict(dtype=BF16, device="cpu", mesh=mesh, hints=hints)
    paged = dict(cache_kind="paged", block_size=8)
    spec = dict(slots=2, max_len=64, cache_kind="paged", num_blocks=24,
                abft=ABFTConfig())
    hard = RecoveryPolicy(max_retries=0, evict_on_hard_fault=True)
    table = {
        "dense": (W.reqs(cfg), None, dict(slots=SLOTS, max_len=64)),
        "paged": (W.reqs(cfg), None, dict(slots=SLOTS, max_len=64,
                                           **paged)),
        "chunked": (W.reqs(cfg), None, dict(slots=SLOTS, max_len=64,
                                             chunk_tokens=8)),
        "shared": (cross_share_reqs(cfg), None, dict(
            slots=SLOTS, max_len=64, prefix_sharing=True, chunk_tokens=12,
            **paged)),
        "fault": (W.reqs(cfg), {"fault_at": (2, ROW3),
                                "admit_fault_at": (1, W.FAULT)},
                  dict(slots=SLOTS, max_len=64, **paged)),
        "hard": (W.reqs(cfg, n=4, seed=5), {"fault_at": (1, ROW3)},
                 dict(slots=SLOTS, max_len=64, policy=hard)),
        "unsped": (W.periodic_reqs(), None, spec),
        "sped": (W.periodic_reqs(), None, dict(spec_decode="ngram",
                                                draft_len=3, **spec)),
    }
    recs = {}
    for name in names or table:
        rs, run_kw, ekw = table[name]
        rs = _fresh(rs)
        eng = ServeEngine(model, params, **kw, **ekw)
        slots = _slot_log(eng)
        cells = (_index_cells_agree(eng, eng.executor.dp)
                 if name == "shared" and mesh is not None else None)
        rec = _record(eng, rs, eng.run(rs, **(run_kw or {})))
        if name == "shared":
            rec["slots"] = slots
            if cells is not None:
                rec["index_cells"] = max(cells)
        recs[name] = rec
    return recs


def _executed_decode(eng) -> dict:
    """{site: schemes} ``protected_matmul`` resolves in one decode step of
    ``eng`` (after an admission)."""
    from repro_torch.core import protected

    eng.admit(W.reqs(eng.model.cfg, n=SLOTS, new_tokens=4))
    seen, scope = {}, protected.protection_scope

    def record(scheme, site):
        seen.setdefault(site, set()).add(scheme)
        return scope(scheme, site)

    protected.protection_scope = record
    try:
        eng.step()
    finally:
        protected.protection_scope = scope
    return {site: sorted(s) for site, s in seen.items()}


def _audit(model, params, mesh) -> dict:
    from repro_torch.analysis.audit import audit_served_step

    eng = ServeEngine(model, params, slots=SLOTS, max_len=32, dtype=BF16,
                      device="cpu", mesh=mesh)
    eng.admit(W.reqs(model.cfg, n=SLOTS, new_tokens=4))
    a = audit_served_step(eng, eng.step)
    return {"protected_fraction": a.coverage.protected_fraction,
            "bijective": a.crosscheck.bijective}


def _model_only(spec) -> tuple:
    return tuple(None if e == "data" else
                 (tuple(a for a in e if a != "data") or None)
                 if isinstance(e, tuple) else e for e in spec)


def fsdp_checks(model, mesh, dp) -> dict:
    """FSDP on the rank: ``init_params(mesh=)`` equal bit for bit to
    ``shard_params`` of the whole tree; each FSDP leaf's quarter (or half)
    the whole leaf's size over the mesh; and each gathered over ``data``
    equal to the leaf's model shard of the whole tree."""
    def flat(tree):
        out = {}
        sharding.map_with_path(lambda ps, t: out.__setitem__(ps, t), tree)
        return out

    full = model.init_params(4, dtype=BF16)
    a = flat(model.init_params(4, dtype=BF16, mesh=mesh))
    b = flat(model.shard_params(full, mesh))
    equal = list(a) == list(b) and all(
        a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]) for p in a)
    specs, whole_tree = {}, flat(full)
    sharding.map_with_path(lambda ps, sp: specs.__setitem__(ps, sp),
                           sharding.param_specs(model.cfg, full, mesh))
    coords = mesh.coords()
    gathered, shares = [], {}
    for ps, t in a.items():
        sp = specs[ps]
        dims = [i for i, e in enumerate(sp)
                if e == "data" or isinstance(e, tuple) and "data" in e]
        if not dims:
            continue
        whole = collectives.fsdp_gather(t, dp, dims[0])
        want = _cut(whole_tree[ps], sharding.shard_slices(
            _model_only(sp), whole_tree[ps].shape, mesh, coords))
        gathered.append(torch.equal(whole, want))
        shares[ps] = whole_tree[ps].numel() // t.numel()
    return {"draw_equal": equal, "gathers_equal": all(gathered),
            "gathered": len(gathered), "shares": shares}


def data_rank(d, k, llama_params, moe_params, routed_layer, hw, thr, names,
              moe_names) -> dict:
    """One rank of ``tests/test_torch_mesh_data.py`` at (data=d, model=k):
    llama's scenarios, its executed decode schemes on the hardware
    ``hw`` with the plan that runs, a served step's audit (``names``,
    ``moe_names``: the scenarios this mesh runs); the MoE stack's
    scenarios and a split decode's routed experts on crafted rows
    (``routed_layer``, the reference's f32 layer); and, with
    ``sharding.FSDP_THRESHOLD`` lowered to ``thr`` (this process only),
    FSDP's draw, gathers and streams."""
    from repro_torch.core.hardware import HardwareSpec

    mesh = mesh_of(d, k)
    llama = Model(W.small_config())
    out = {"llama": data_scenarios(llama, llama_params, mesh, names=names)}
    eng = ServeEngine(llama, llama_params, slots=SLOTS, max_len=32,
                      dtype=BF16, device="cpu", mesh=mesh,
                      abft=ABFTConfig(hardware=HardwareSpec(**hw)))
    world = eng.executor.world
    out["plan"] = {r["layer"]: r["scheme"] for r in eng.plan.report_rows()}
    out["plan_m"] = sorted({r["m"] for r in eng.plan.report_rows()})
    out["executed"] = _executed_decode(eng)
    out["audit"] = _audit(llama, llama_params, mesh)
    layout = {"rows": list(eng.executor.rows),
              "kv_rows": eng.cache[0]["k"].shape[0]}
    moe = Model(W.moe_config())
    out["moe"] = data_scenarios(moe, moe_params, mesh, names=moe_names)
    out["moe_dp_size"] = ServeEngine(moe, moe_params, slots=SLOTS,
                                     max_len=16, dtype=BF16, device="cpu",
                                     mesh=mesh).executor.hints.dp_size
    for key, val in out.items():
        collectives.check_same(val, world, key)
    out["layout"] = layout
    out["routed"] = split_routed(moe, moe_params, routed_layer, mesh)
    sharding.FSDP_THRESHOLD = thr
    eng = ServeEngine(llama, llama_params, slots=SLOTS, max_len=64,
                      dtype=BF16, device="cpu", mesh=mesh)
    fs = fsdp_checks(llama, mesh, eng.executor.dp)
    fs["fsdp_paths"] = sorted(eng.executor.dp.sharded)
    collectives.reset_counts()
    fs["dense"] = data_scenarios(llama, llama_params, mesh,
                                 names=("dense",))["dense"]
    fs["fsdp_gathers"] = collectives.COUNTS["fsdp_gather"]
    collectives.check_same(fs, world, "fsdp")
    out["fsdp"] = fs
    out["data_rank"] = mesh.data_rank
    return out


# ------------------------------------------------ the MoE split decode
# 32 rows, 16 a data rank: rank 0's rows are one token repeated (every
# row routed to the same two experts, over their capacity of 8), rank 1's
# are distinct
ROUTED_ROWS = 32


def routed_inputs(d_model: int) -> np.ndarray:
    rng = np.random.default_rng(21)
    x = rng.standard_normal((ROUTED_ROWS, 1, d_model)).astype(np.float32)
    x[:ROUTED_ROWS // 2] = x[0]
    return x


def split_routed(model, params, layer, mesh) -> dict:
    """A routed MoE FFN (``layer``: the whole f32 layer, no shared
    experts) on a split decode's rows of this data rank: ``moe_forward``
    at ``rows`` (lo, n) with one dispatch group, as ``ModelRunner.decode``
    runs it, on the rank's experts (EP over ``model``), and the experts'
    drops in the group.  Returns the rank's output rows and drops."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.serve.executor import MeshExecutor

    cfg = dataclasses.replace(model.cfg, n_shared_experts=0)
    ex = MeshExecutor(model, params, mesh=mesh, dtype=BF16,
                      device=torch.device("cpu"))
    d = mesh.shape["data"]
    n = ROUTED_ROWS // d
    lo = mesh.data_rank * n
    ctx = LayerCtx(abft=ABFTConfig(), hints=ex.hints, tp=ex.tp, dp=ex.dp,
                   rows=(lo, n), moe_groups=1)
    x = torch.from_numpy(routed_inputs(cfg.d_model)[lo:lo + n])
    el = cfg.n_experts // mesh.shape["model"]
    e0 = mesh.model_rank * el
    p = {key: (v if key == "router" else v[e0:e0 + el])
         for key, v in layer.items()}
    drops = []
    top_k = moe.top_k

    def logged(probs, k):
        vals, idx = top_k(probs, k)
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
        drops.append(int((counts - moe.capacity(cfg, idx.shape[0]))
                         .clamp_min(0).sum()))
        return vals, idx

    moe.top_k = logged
    try:
        with torch.no_grad():
            y, _, _ = moe.moe_forward(x, p, cfg, ctx)
    finally:
        moe.top_k = top_k
    return {"y": y.numpy(), "drops": drops[0], "lo": lo}


# ------------------------------------------- sequence-sharded caches
# (tests/test_torch_seq_shard.py)

def long_reqs(cfg, n_new=6):
    """One request a run: a 40-token prompt, crossing the data ranks'
    position shards (32 a rank at max_len 64)."""
    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab_size, size=40 - 7 * i).astype(np.int32),
        max_new_tokens=n_new) for i in range(2)]


def seq_scenarios(model, params, mesh, flash: bool) -> dict:
    """One slot, max_len 64: a dense run (prompts of 40 and 33 tokens
    prefilled whole) and a chunked run (chunks of 24: the second chunk
    starts in data rank 0's shard and ends in rank 1's, and reads rank
    0's cells), with flash attention on or off."""
    cfg = model.cfg
    out = {}
    for name, kw in (("dense", {}), ("chunked", {"chunk_tokens": 24})):
        rs = long_reqs(cfg)
        eng = ServeEngine(model, params, slots=1, max_len=64, dtype=F32,
                          device="cpu", mesh=mesh,
                          abft=ABFTConfig(flash_attention=flash), **kw)
        rec = _record(eng, rs, eng.run(rs))
        if mesh is not None:
            sp = eng.executor.cache_split
            rec["shard"] = [sp.kind, sp.lo, sp.n,
                            list(eng.model.kv_leaf(eng.cache).shape)]
        out[name] = rec
    return out


def seq_rank(params) -> dict:
    """One rank of ``tests/test_torch_seq_shard.py`` at (data=2,
    model=1): llama (flash on and off) and deepseek's MLA latent served
    on one slot, each rank holding half the positions; and the K3 plain
    version's partials on the rank's shard."""
    mesh = mesh_of(2, 1)
    collectives.reset_counts()
    recs = {"llama": seq_scenarios(Model(W.small_config()), params["llama"],
                                   mesh, flash=True)}
    recs["counts"] = dict(collectives.COUNTS)
    recs["llama_plain"] = seq_scenarios(Model(W.small_config()),
                                        params["llama"], mesh, flash=False)
    recs["mla"] = seq_scenarios(Model(W.mla_config()), params["mla"], mesh,
                                flash=False)
    # every record but each rank's own shard must agree
    collectives.check_same(
        {k: {r: {f: x for f, x in rec.items() if f != "shard"}
             for r, rec in v.items()} if k != "counts" else v
         for k, v in recs.items()}, collectives.world_group(), "seq")
    return recs
