"""Rank-side workers of ``tests/test_torch_mesh_engine.py`` (no tests of
its own): functions a spawned rank imports by name.  Each rank runs every
scenario of the reference's ``tests/test_sharded_engine.py::
TestMeshEquivalence`` and ``tests/test_spec_decode.py``'s mesh case on its
shard, checks that every rank holds the same record
(``collectives.check_same``) and returns the records."""

import numpy as np
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import ABFTConfig
from repro_torch.distributed import collectives
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model
from repro_torch.obs import EngineTelemetry
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

BF16 = torch.bfloat16
F32 = torch.float32
FAULT = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
# a column-parallel fault: logical column 40 of q, k and v (rank 1's at
# TP=2 for k and v, rank 2's of q at TP=4)
QKV_FAULT = ModelFault.at(1, "qkv", FaultSpec.value(0, 40, 1e5))
FAMILY = ("qwen1.5-32b", "qwen3-14b", "stablelm-1.6b")
STATS = ("faults_detected", "retries", "hard_faults", "evictions",
         "rejections", "steps", "tokens", "prefix_tokens_shared",
         "prefill_chunks", "draft_proposed", "draft_accepted",
         "verify_retries")


def small_config():
    return scaled_down(get_config("llama3.2-1b"), n_layers=2)


def reqs(cfg, n=6, seed=0, new_tokens=5):
    """The reference's ``_reqs``."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i,
                    prompt=rng.integers(
                        1, cfg.vocab_size,
                        size=rng.integers(4, 20)).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i in range(n)]


def shared_reqs(cfg):
    """The reference's prefix-shared traffic: requests 3.. open with
    request 0's first 12 tokens."""
    rs = reqs(cfg, n=6, seed=3)
    for r in rs[3:]:
        r.prompt = np.concatenate([rs[0].prompt[:12],
                                   r.prompt]).astype(np.int32)
    return rs


def periodic_reqs(n=3, budget=6):
    """``tests/test_spec_decode.py``'s ``_periodic_reqs``."""
    return [Request(uid=i,
                    prompt=np.tile(3 + np.arange(4 + i % 2, dtype=np.int32),
                                   16)[:21 + 2 * i],
                    max_new_tokens=budget + i % 3)
            for i in range(n)]


def _record(eng, rs, out=None) -> dict:
    st = eng.stats
    return {"streams": {int(r.uid): [int(t) for t in r.generated]
                        for r in rs},
            "out": ({int(u): [int(t) for t in s] for u, s in out.items()}
                    if out is not None else None),
            "errors": {int(r.uid): r.error for r in rs if r.error},
            "stats": {k: getattr(st, k) for k in STATS},
            "blocks_used": (eng.pool.blocks_used
                            if eng.pool is not None else None)}


def scenarios(model, params, mesh, device="cpu") -> dict:
    """Every scenario on one engine configuration each; ``mesh`` None is
    the local baseline."""
    cfg = model.cfg
    eng_kw = dict(dtype=BF16, device=device, mesh=mesh)
    recs = {}

    def run(name, rs, run_kw=None, **kw):
        eng = ServeEngine(model, params, **{**eng_kw, **kw})
        out = eng.run(rs, **(run_kw or {}))
        recs[name] = _record(eng, rs, out)
        return eng

    run("dense", reqs(cfg), slots=3, max_len=64)
    run("paged", reqs(cfg), slots=3, max_len=64, cache_kind="paged",
        block_size=8)
    run("shared_chunked", shared_reqs(cfg), slots=3, max_len=64,
        cache_kind="paged", block_size=8, prefix_sharing=True,
        chunk_tokens=12)
    run("faulted", reqs(cfg),
        {"fault_at": (2, FAULT), "admit_fault_at": (1, FAULT)},
        slots=3, max_len=64, cache_kind="paged", block_size=8)
    run("qkv_fault", reqs(cfg), {"fault_at": (2, QKV_FAULT)},
        slots=3, max_len=64)
    run("hard_fault", reqs(cfg, n=4, seed=5), {"fault_at": (1, FAULT)},
        slots=2, max_len=64,
        policy=RecoveryPolicy(max_retries=0, evict_on_hard_fault=True))
    spec_kw = dict(slots=2, max_len=64, cache_kind="paged", num_blocks=24,
                   abft=ABFTConfig())
    run("unsped", periodic_reqs(), **spec_kw)
    run("sped", periodic_reqs(), spec_decode="ngram", draft_len=3,
        **spec_kw)
    return recs


def family_scenarios(mesh) -> dict:
    """The rest of the dense family, scaled down to 2 layers (seed 0,
    bf16): qwen1.5-32b (q/k/v biases, column-sharded with their GEMMs),
    qwen3-14b (per-head q/k norm on a shard) and stablelm-1.6b (LayerNorm,
    25% partial rotary), dense and paged at ``mesh`` (None: local), with
    the leaves the rules split."""
    recs = {}
    for arch in FAMILY:
        model = Model(scaled_down(get_config(arch), n_layers=2))
        params = model.init_params(0, dtype=BF16, device="cpu")
        rec = {}
        for kind in ("dense", "paged"):
            eng = ServeEngine(model, params, slots=3, max_len=64, dtype=BF16,
                              device="cpu", mesh=mesh, cache_kind=kind,
                              block_size=8)
            rs = reqs(model.cfg, n=3, new_tokens=4)
            rec[kind] = _record(eng, rs, eng.run(rs))
        tp = eng.executor.tp if mesh is not None else None
        rec["sharded"] = sorted(tp.sharded) if tp is not None else []
        recs[arch] = rec
    return recs


def mesh_scenarios(k: int, params, hw: dict) -> dict:
    """Rank side: the scenarios at ``mesh=k``, the plan rows of a traced
    engine and the schemes a forward executes on the hardware ``hw``
    (``executed_schemes``) and the rest of the dense family
    (``family_scenarios``).  Every record is checked equal across the
    ranks."""
    model = Model(small_config())
    recs = scenarios(model, params, k)
    recs["family"] = family_scenarios(k)
    recs["executed"] = executed_schemes(k, params, hw)
    tel = EngineTelemetry(trace=True)
    eng = ServeEngine(model, params, slots=2, max_len=32, dtype=BF16,
                      device="cpu", mesh=k, telemetry=tel)
    recs["plan_rows"] = [e["args"] for e in tel.tracer.events
                         if e["name"] == "plan_row"]
    recs["model_parallel"] = eng.model_parallel
    recs["mesh_shape"] = eng.mesh.shape
    recs["backend"] = eng.executor.tp.backend
    for name, rec in recs.items():
        collectives.check_same(rec, eng.executor.tp, name)
    return recs


def executed_schemes(k: int, params, hw_fields: dict) -> dict:
    """Rank side: {site: scheme} that ``protected_matmul`` resolved in a
    64-token forward of this rank's shard on the hardware ``hw_fields``
    (the shapes of a ``n_tokens=64`` plan)."""
    return executed_stack_schemes(Model(small_config()), params, k,
                                  hw_fields, BF16)


def card_streams(k: int) -> dict:
    """``tests/test_torch_cuda.py``'s TP run: a 2-layer llama3.2-1b at full
    width (bf16, seed 0, flash decode on) at ``mesh=k`` on the card, four
    slots, six prompts of 20-120 tokens, eight new tokens each."""
    import dataclasses as dc

    from repro_torch.core.hardware import NVIDIA_H100_SXM

    cfg = dc.replace(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(0, dtype=BF16, device="cuda")
    rng = np.random.default_rng(7)
    rs = [Request(uid=i, prompt=rng.integers(
        1, cfg.vocab_size, size=int(n)).astype(np.int32), max_new_tokens=8)
        for i, n in enumerate(rng.integers(20, 121, size=6))]
    eng = ServeEngine(model, params, slots=4, max_len=256, dtype=BF16,
                      device="cuda", mesh=k,
                      abft=ABFTConfig(hardware=NVIDIA_H100_SXM,
                                      flash_attention=True))
    return {int(u): [int(t) for t in s] for u, s in eng.run(rs).items()}


# ------------------------------------------------------ MoE and SSM stacks
# (tests/test_torch_mesh_moe.py, tests/test_torch_mesh_ssm.py)

MOE_ARCH = "qwen2-moe-a2.7b"
# expert_up at FFN column 9: rank 0's of a sliced expert FFN at k = 2
# (16 columns a rank), rank 1's at k = 4 (8); in every local expert under
# EP.  expert_down (row-parallel when sliced: rank 0's partial) and the
# replicated router at column 1.
MOE_FAULTS = {
    "expert_up": ModelFault.at(0, "expert_up", FaultSpec.value(0, 9, 1e5)),
    "expert_down": ModelFault.at(1, "expert_down",
                                 FaultSpec.value(0, 1, 1e5)),
    "router": ModelFault.at(1, "router", FaultSpec.value(0, 1, 1e5)),
}
SSM_ARCHS = {"mamba2-1.3b": {}, "jamba-v0.1-52b": {"n_layers": 8}}
SSM_LAYER = {"mamba2-1.3b": 1, "jamba-v0.1-52b": 3}


def moe_config(**over):
    """Scaled-down qwen2-moe-a2.7b: 2 MoE layers, 8 experts top 2 with
    shared experts (``over``: the mode cases' changes)."""
    return scaled_down(get_config(MOE_ARCH), **over)


def ssm_config(arch):
    return scaled_down(get_config(arch), **SSM_ARCHS[arch])


def ssm_faults(cfg) -> dict:
    """``ssm_in`` at the first column of the upper half of ``in_x`` (and
    ``in_z``): rank 1's at k = 2, rank 2's at k = 4; ``ssm_out``
    (row-parallel: rank 0's partial)."""
    return {"ssm_in": ModelFault.at(0, "ssm_in", FaultSpec.value(
                0, cfg.d_inner // 2, 1e5)),
            "ssm_out": ModelFault.at(1, "ssm_out",
                                     FaultSpec.value(0, 1, 1e5))}


class OracleProposer:
    """Drafts a reference run's own next tokens (``streams`` by uid)."""

    name = "oracle"

    def __init__(self, streams):
        self.streams = streams

    def propose(self, req, k):
        n = len(req.generated)
        return np.asarray(self.streams[int(req.uid)][n:n + k], np.int32)


def _stats(eng) -> dict:
    """Every ``EngineStats`` field."""
    import dataclasses

    return dataclasses.asdict(eng.stats)


def comparable(rec: dict) -> dict:
    """A ``stack_scenarios`` record without the selection trace's
    intensities: the engine reads them off the plan that runs, the
    per-shard plan at TP=k."""
    stats = dict(rec["stats"])
    stats["selection_trace"] = [{k: v for k, v in e.items()
                                 if k != "intensity"}
                                for e in stats["selection_trace"]]
    return {**rec, "stats": stats}


def _state_digest(eng) -> str:
    """A digest of every per-slot state leaf of the rank's cache."""
    import hashlib

    h = hashlib.sha256()
    for layer, st in zip(eng.cache, eng.model.state_layers):
        if st:
            for key in sorted(layer):
                h.update(layer[key].float().cpu().numpy().tobytes())
    return h.hexdigest()


def _watch_states(eng) -> list:
    """Wrap ``eng.step``: (digest before, digest after, evictions so far)
    a step."""
    seen, step = [], eng.step

    def watched(*a, **k):
        before = _state_digest(eng)
        r = step(*a, **k)
        seen.append((before, _state_digest(eng), eng.stats.evictions))
        return r

    eng.step = watched
    return seen


def stack_scenarios(model, params, mesh, names, faults, dtype,
                    abft=None) -> tuple:
    """The named scenarios of one stack at ``mesh`` (None: local): the
    records every rank shares (streams, errors, every ``EngineStats``
    field, blocks) and, apart, each run's state digests a step
    (``_watch_states``; a rank's own shard).  ``abft``: the engines'
    ``ABFTConfig`` but for the speculative runs' (flash off)."""
    eng_kw = dict(dtype=dtype, device="cpu", mesh=mesh)
    paged = dict(cache_kind="paged", block_size=8)
    hard = RecoveryPolicy(max_retries=0, evict_on_hard_fault=True)
    spec_kw = dict(slots=2, max_len=64, cache_kind="paged", num_blocks=24,
                   abft=ABFTConfig())
    cfg = model.cfg
    table = {
        "dense": (reqs(cfg), None, dict(slots=3, max_len=64)),
        "paged": (reqs(cfg), None, dict(slots=3, max_len=64, **paged)),
        "shared_chunked": (shared_reqs(cfg), None, dict(
            slots=3, max_len=64, prefix_sharing=True, chunk_tokens=12,
            **paged)),
        "moe_faults": (reqs(cfg), {
            "fault_at": (2, faults.get("expert_up")),
            "admit_fault_at": (1, faults.get("router"))},
            dict(slots=3, max_len=64, **paged)),
        "expert_down": (reqs(cfg), {
            "fault_at": (2, faults.get("expert_down")),
            "admit_fault_at": (1, faults.get("expert_up"))},
            dict(slots=3, max_len=64)),
        "qkv_faults": (reqs(cfg), {"fault_at": (2, faults.get("qkv")),
                                 "admit_fault_at": (1, faults.get("qkv"))},
                       dict(slots=3, max_len=64)),
        "ssm_in": (reqs(cfg), {"fault_at": (2, faults.get("ssm_in"))},
                   dict(slots=3, max_len=64)),
        "ssm_out": (reqs(cfg), {"fault_at": (3, faults.get("ssm_out"))},
                    dict(slots=3, max_len=64, **paged)),
        "hard_fault": (reqs(cfg, n=4, seed=5), {"fault_at": (
            1, faults.get("expert_up") or faults.get("ssm_out")
            or faults.get("qkv"))},
            dict(slots=2, max_len=64, policy=hard)),
        "unsped": (periodic_reqs(), None, spec_kw),
        "ngram": (periodic_reqs(), None, dict(
            spec_decode="ngram", draft_len=3, **spec_kw)),
    }
    recs, states = {}, {}
    for name in names:
        if name == "oracle":
            rs, run_kw = periodic_reqs(), None
            kw = dict(spec_decode=OracleProposer(recs["unsped"]["streams"]),
                      draft_len=3, **spec_kw)
        else:
            rs, run_kw, kw = table[name]
            rs = [Request(uid=r.uid, prompt=r.prompt,
                          max_new_tokens=r.max_new_tokens) for r in rs]
        if abft is not None:
            kw = {"abft": abft, **kw}
        eng = ServeEngine(model, params, **eng_kw, **kw)
        seen = _watch_states(eng)
        out = eng.run(rs, **(run_kw or {}))
        rec = _record(eng, rs, out)
        rec["stats"] = _stats(eng)
        recs[name], states[name] = rec, seen
    return recs, states


def routed_output(model, params, mesh, dtype) -> np.ndarray:
    """The routed experts' output alone (the first MoE FFN without its
    shared experts) of a seeded (2, 5, D) input, at ``mesh`` (None:
    local), as f32."""
    import dataclasses

    from repro_torch.models.moe import moe_forward
    from repro_torch.serve.executor import LocalExecutor, MeshExecutor

    cfg = model.cfg
    dev = torch.device("cpu")
    ex = (MeshExecutor(model, params, mesh=mesh, dtype=dtype, device=dev)
          if mesh is not None else
          LocalExecutor(model, params, dtype=dtype, device=dev))
    ctx = LayerCtx(abft=ABFTConfig(), hints=ex.hints, tp=ex.tp)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, cfg.d_model, generator=gen).to(dtype)
    layer = next(lp for lp in ex.params["layers"]
                 if "w_up" in lp.get("ffn", {}))
    with torch.no_grad():
        y, _, _ = moe_forward(x, layer["ffn"], dataclasses.replace(
            cfg, n_shared_experts=0), ctx)
    return y.float().numpy()


def routing_log(model, params, mesh, dtype) -> list:
    """Every ``top_k`` routing decision (expert ids) of a dense run of
    ``reqs``, in call order."""
    from repro_torch.models import moe

    log, top_k = [], moe.top_k

    def logged(probs, k):
        vals, idx = top_k(probs, k)
        log.append(idx.tolist())
        return vals, idx

    moe.top_k = logged
    try:
        eng = ServeEngine(model, params, slots=3, max_len=64, dtype=dtype,
                          device="cpu", mesh=mesh)
        eng.run(reqs(model.cfg))
    finally:
        moe.top_k = top_k
    return log


def executed_stack_schemes(model, params, k, hw_fields, dtype) -> dict:
    """{site: schemes} that ``protected_matmul`` and
    ``protected_matmul_batched`` resolve in a 64-token forward of this
    rank's shard on the hardware ``hw_fields``."""
    from repro_torch.core import protected
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.serve.executor import MeshExecutor

    ex = MeshExecutor(model, params, mesh=k, dtype=dtype,
                      device=torch.device("cpu"))
    ctx = LayerCtx(abft=ABFTConfig(hardware=HardwareSpec(**hw_fields)),
                   hints=ex.hints, tp=ex.tp)
    seen = {}
    scope = protected.protection_scope

    def record(scheme, site):
        seen.setdefault(site, set()).add(scheme)
        return scope(scheme, site)

    protected.protection_scope = record
    try:
        tokens = np.arange(64).reshape(4, 16) % model.cfg.vocab_size
        with torch.no_grad():
            model.forward(ex.params, {"tokens": tokens}, ctx, device="cpu")
    finally:
        protected.protection_scope = scope
    return {site: sorted(s) for site, s in seen.items()}


def shard_draw_equal(model, k, dtype) -> bool:
    """``init_params(mesh=)`` on this rank equals ``shard_params`` of the
    whole tree bit for bit (seed 4)."""
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.distributed.mesh import build_mesh, rank_devices

    mesh = build_mesh(model=k, data=1, devices=rank_devices("cpu"))
    drawn = tree_leaves_with_path(model.init_params(4, dtype=dtype,
                                                    mesh=mesh))
    cut = tree_leaves_with_path(model.shard_params(
        model.init_params(4, dtype=dtype), mesh))
    return [p for p, _ in drawn] == [p for p, _ in cut] and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for (_, a), (_, b) in zip(drawn, cut))


def audit_step(model, params, k, dtype) -> dict:
    """This rank's served decode step at ``mesh=k`` walked by the coverage
    audit (``analysis.audit.audit_served_step``) after an admission."""
    from repro_torch.analysis.audit import audit_served_step

    eng = ServeEngine(model, params, slots=2, max_len=32, dtype=dtype,
                      device="cpu", mesh=k)
    eng.admit(reqs(model.cfg, n=2, new_tokens=4))
    return audit_served_step(eng, eng.step).to_json()


MOE_NAMES = ("dense", "shared_chunked", "moe_faults", "hard_fault",
             "unsped", "ngram", "oracle")
SSM_NAMES = ("dense", "paged", "ssm_in", "ssm_out", "hard_fault")


def moe_rank(k, variants, hw) -> dict:
    """Rank side of ``tests/test_torch_mesh_moe.py``: each variant
    (name -> (config overrides, params, scenario names)) at ``mesh=k``,
    its routed output, routing log, executed schemes, the shard-at-draw
    check and the audit of a served step; every record checked equal
    across the ranks."""
    out = {}
    for name, (over, params, names) in variants.items():
        model = Model(moe_config(**over))
        recs, _ = stack_scenarios(model, params, k, names, MOE_FAULTS, BF16)
        rec = {"scenarios": recs,
               "routing": routing_log(model, params, k, BF16),
               "executed": executed_stack_schemes(model, params, k, hw,
                                                  BF16),
               "shard_draw": shard_draw_equal(model, k, BF16),
               "audit": audit_step(model, params, k, BF16)}
        ex = ServeEngine(model, params, slots=1, max_len=16, dtype=BF16,
                         device="cpu", mesh=k).executor
        ex_tp = ex.tp
        rec["sharded"] = sorted(ex_tp.sharded)
        rec["moe_mode"] = ex.hints.moe_mode
        for key, val in rec.items():
            collectives.check_same(val, ex_tp, f"{name}/{key}")
        rec["routed"] = routed_output(model, params, k, BF16)
        out[name] = rec
    return out


def ssm_rank(k, stacks, hw, norm_inputs) -> dict:
    """Rank side of ``tests/test_torch_mesh_ssm.py``: each arch (-> its
    params) at ``mesh=k`` through ``SSM_NAMES`` (f32), its executed
    schemes, the shard-at-draw check and the audit; the shared records
    checked across the ranks, the state digests kept per rank; and the
    rank's slice of ``gated_rms_norm(tp=)`` of ``norm_inputs``."""
    out = {"norm": norm_rank(k, *norm_inputs)}
    for arch, params in stacks.items():
        model = Model(ssm_config(arch))
        recs, states = stack_scenarios(model, params, k, SSM_NAMES,
                                       ssm_faults(model.cfg), F32)
        rec = {"scenarios": recs,
               "executed": executed_stack_schemes(model, params, k, hw,
                                                  F32),
               "shard_draw": shard_draw_equal(model, k, F32),
               "audit": audit_step(model, params, k, F32)}
        eng = ServeEngine(model, params, slots=1, max_len=16, dtype=F32,
                          device="cpu", mesh=k)
        rec["sharded"] = sorted(eng.executor.tp.sharded)
        for key, val in rec.items():
            collectives.check_same(val, eng.executor.tp, f"{arch}/{key}")
        rec["states"] = states
        out[arch] = rec
    return out


def norm_rank(k, x, z, w) -> np.ndarray:
    """``gated_rms_norm(tp=)`` of this rank's slice of the last dim."""
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.distributed.collectives import TPGroup
    from repro_torch.models.layers import gated_rms_norm

    mesh = build_mesh(model=k, data=1, devices=rank_devices("cpu"))
    tp = TPGroup(rank=mesh.model_rank, size=k, group=mesh.group)
    n = x.shape[-1] // k
    cut = slice(tp.rank * n, (tp.rank + 1) * n)
    y = gated_rms_norm(x[..., cut], z[..., cut], w[cut], 1e-5, tp=tp)
    return y.float().numpy()


# ------------------------------------------------- MLA with its MTP head
# (tests/test_torch_mesh_mla.py)

MLA_ARCH = "deepseek-v3-671b"
# mla.q_b (site qkv) at column 60 of its 96 (4 heads x 24): rank 1's at
# k = 2, rank 2's at k = 4; layer 1 is the MoE layer (1 dense + 1 MoE)
MLA_FAULTS = {
    "qkv": ModelFault.at(0, "qkv", FaultSpec.value(0, 60, 1e5)),
    "expert_up": ModelFault.at(1, "expert_up", FaultSpec.value(0, 9, 1e5)),
    "router": ModelFault.at(1, "router", FaultSpec.value(0, 1, 1e5)),
}
MLA_NAMES = ("dense", "shared_chunked", "qkv_faults", "moe_faults",
             "hard_fault", "unsped", "ngram", "oracle")


def mla_config(**over):
    """Scaled-down deepseek-v3-671b: 2 layers (1 dense + 1 MoE), 4 MLA
    heads, 8 experts top 2 with a shared expert, the MTP head (``over``:
    the top-4 case)."""
    return scaled_down(get_config(MLA_ARCH), **over)


def forward_logits(model, params, mesh, dtype) -> dict:
    """``Model.forward`` of a seeded (2, 12) batch at ``mesh`` (None:
    local) on the rank's shard: its f32 logits and ``mtp_logits``."""
    from repro_torch.serve.executor import LocalExecutor, MeshExecutor

    dev = torch.device("cpu")
    ex = (MeshExecutor(model, params, mesh=mesh, dtype=dtype, device=dev)
          if mesh is not None else
          LocalExecutor(model, params, dtype=dtype, device=dev))
    ctx = LayerCtx(abft=ABFTConfig(), hints=ex.hints, tp=ex.tp)
    tokens = np.random.default_rng(5).integers(
        1, model.cfg.vocab_size, size=(2, 12))
    with torch.no_grad():
        out = model.forward(ex.params, {"tokens": tokens}, ctx, device="cpu")
    return {"logits": out.logits.numpy(),
            "mtp_logits": out.mtp_logits.numpy(), "flag": bool(out.flag)}


def mla_rank(k, variants, hw) -> dict:
    """Rank side of ``tests/test_torch_mesh_mla.py``: each variant (name ->
    (config overrides, params, scenario names)) at ``mesh=k``, its routed
    output, routing log and forward logits with ``mtp_logits``; the first
    variant's executed schemes, shard-at-draw check and audit of a served
    step (the routing width changes none of them); the shared records
    checked equal across the ranks."""
    out = {}
    for i, (name, (over, params, names)) in enumerate(variants.items()):
        model = Model(mla_config(**over))
        recs, _ = stack_scenarios(model, params, k, names, MLA_FAULTS, BF16)
        rec = {"scenarios": recs,
               "routing": routing_log(model, params, k, BF16)}
        if i == 0:
            rec["executed"] = executed_stack_schemes(model, params, k, hw,
                                                     BF16)
            rec["shard_draw"] = shard_draw_equal(model, k, BF16)
            rec["audit"] = audit_step(model, params, k, BF16)
        ex = ServeEngine(model, params, slots=1, max_len=16, dtype=BF16,
                         device="cpu", mesh=k).executor
        rec["sharded"] = sorted(ex.tp.sharded)
        rec["moe_mode"] = ex.hints.moe_mode
        rec["mtp_shapes"] = {p: list(t.shape) for p, t in _leaves(
            ex.params["mtp"])}
        for key, val in rec.items():
            collectives.check_same(val, ex.tp, f"{name}/{key}")
        rec["routed"] = routed_output(model, params, k, BF16)
        rec["forward"] = forward_logits(model, params, k, BF16)
        out[name] = rec
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}/{key}" if path else key)
    else:
        yield path, tree


# ------------------------------------------------------ TP head padding
# (tests/test_torch_head_padding.py)

# q, k and v at column 60 of the padded 96 (6 heads x 16): rank 1's at
# k = 2 (48 a rank) and at k = 3 (32 a rank)
PAD_FAULTS = {"qkv": ModelFault.at(1, "qkv", FaultSpec.value(0, 60, 1e5))}
PAD_NAMES = ("dense", "paged", "shared_chunked", "qkv_faults", "hard_fault")


def pad_configs():
    """A 5-head qwen1.5-32b stack (q/k/v biases, 5 kv heads, head dim 16)
    and the same padded to 6 / 6 heads (the reference's test case)."""
    import dataclasses

    base = scaled_down(get_config("qwen1.5-32b"), n_heads=5, n_kv_heads=5,
                       head_dim=16)
    return base, dataclasses.replace(base, pad_heads_to=6,
                                     pad_kv_heads_to=6)


def padding_rank(k, params, flash: bool) -> dict:
    """Rank side: the padded stack's ``PAD_NAMES`` at ``mesh=k``, flash
    attention on or off; every record checked across the ranks."""
    model = Model(pad_configs()[1])
    recs, _ = stack_scenarios(model, params, k, PAD_NAMES, PAD_FAULTS, BF16,
                              abft=ABFTConfig(flash_attention=flash))
    eng = ServeEngine(model, params, slots=1, max_len=16, dtype=BF16,
                      device="cpu", mesh=k)
    rec = {"scenarios": recs, "sharded": sorted(eng.executor.tp.sharded),
           "wq": list(eng.executor.params["layers"][0]["mixer"]["wq"].shape),
           "cache": list(eng.cache[0]["k"].shape)}
    collectives.check_same(rec, eng.executor.tp, "padding")
    return rec


# ------------------------------------- stream equality across TP widths
# (tests/test_torch_mesh_engine.py::test_tp_widths_part_at_near_ties)

def wide_config(d: int):
    """Scaled-down llama3.2-1b (2 layers) at d_model ``d``: 4 heads of
    ``d / 4``, d_ff ``4 d``."""
    return scaled_down(get_config("llama3.2-1b"), n_layers=2, d_model=d,
                       d_ff=4 * d, head_dim=d // 4)


def decode_logits(d: int, params, mesh) -> tuple:
    """(every decode step's f32 logits stacked, the streams) of a dense
    bf16 run of ``reqs`` at ``mesh`` (None: local) on ``wide_config(d)``."""
    model = Model(wide_config(d))
    log, decode = [], model.decode

    def logged(*a, **kw):
        logits, cache, flag = decode(*a, **kw)
        log.append(logits.float().numpy().copy())
        return logits, cache, flag

    model.decode = logged
    eng = ServeEngine(model, params, slots=3, max_len=64, dtype=BF16,
                      device="cpu", mesh=mesh)
    rs = reqs(model.cfg)
    out = eng.run(rs)
    return np.stack(log), np.array([list(out[r.uid]) for r in rs])


def failing_rank() -> None:
    """Rank 1 raises while rank 0 waits in a barrier, which then fails on
    the closed connection (``tests/test_torch_mesh_engine.py``)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails first")
    dist.barrier()
