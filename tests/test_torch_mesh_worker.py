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
    from repro_torch.core import protected
    from repro_torch.core.hardware import HardwareSpec
    from repro_torch.serve.executor import MeshExecutor

    model = Model(small_config())
    ex = MeshExecutor(model, params, mesh=k, dtype=BF16,
                      device=torch.device("cpu"))
    ctx = LayerCtx(abft=ABFTConfig(hardware=HardwareSpec(**hw_fields)),
                   tp=ex.tp)
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
