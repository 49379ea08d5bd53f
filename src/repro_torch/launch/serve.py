"""Serving CLI: continuous batching + ABFT recovery stats (port of
``repro.launch.serve`` for the options this port has).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch qwen3-14b --scale full --dtype bfloat16 --flash-attention \
      [--cache paged [--prefix-sharing]] [--chunk-tokens N|auto] \
      [--spec-decode ngram|self-draft [--draft-len K|auto] \
       [--draft-model UNITS@WINDOW]] \
      [--inject-faults] [--abft auto|global|block_1s|off] \
      [--fault-rate 0.2 --fault-kind transient --adaptive] \
      [--temperature 0.8 --top-k 50] [--plan-out plan.json] \
      [--metrics-out m.json] [--trace-out t.json] [--log-events] \
      [--mesh N]

``--arch`` takes every registered config; the port serves the dense
family (llama3.2-1b, qwen3-14b, stablelm-1.6b, qwen1.5-32b), the MoE
qwen2-moe-a2.7b, the MLA deepseek-v3-671b, the SSM mamba2-1.3b and the
hybrid jamba-v0.1-52b, and exits with the engine's ``NotImplementedError``
message naming the memory inputs on whisper-tiny and llama-3.2-vision-11b
(the engine passes only tokens, as the reference's); a stack with a Mamba2
layer exits with the reference's ``ValueError`` message on
``--prefix-sharing``, ``--chunk-tokens`` and ``--spec-decode``.  Runs on
the CUDA
device unless ``--device cpu`` is given.  Block schemes
always run the fused ABFT kernel on the card (its plain version on the
CPU).  Weights are random, made from ``--seed``.

Fault-campaign flags: ``--fault-rate`` attaches a seeded f32
``FaultModel`` (Bernoulli-per-step injection; ``--fault-kind permanent``
makes faults sticky for ``--fault-duration`` steps), and every injected
fault is classified as corrected / uncorrected / SDC / masked.
``--adaptive`` wraps the base policy in an ``ErrorAdaptivePolicy`` that
escalates to ``global`` when the observed detection rate reaches
``--escalate-threshold``.  Telemetry flags: ``--metrics-out`` writes the
metrics snapshot + fault-rate surface + engine stats as one JSON
artifact (``benchmarks/check_telemetry_schema.py`` validates it);
``--trace-out`` writes a Chrome-trace/Perfetto JSON; ``--log-events``
streams every trace event as a JSON line to stderr.
``--prefix-sharing`` (paged cache) shares resident prompt blocks with
copy-on-write; ``--chunk-tokens`` sets the chunked-prefill step budget
(an int, or ``auto`` for the roofline-tuned budget).
``--spec-decode`` turns on speculative decoding (``ngram`` prompt lookup,
or ``self-draft`` through the first UNITS layers over a WINDOW of context,
``--draft-model``), ``--draft-len`` its draft length (an int, or ``auto``
for the roofline-tuned K); it needs flash attention off.  The stats line
then carries a ``spec_decode`` block (proposer, draft length, proposed and
accepted drafts, acceptance rate, verify retries).
``--mesh N`` serves with tensor parallelism over N ranks, a
``(data=1, model=N)`` mesh as the reference's CLI builds
(``distributed/spawn.py``: one process a rank, gloo where ranks share a
device or run on the CPU, NCCL where each has a GPU of its own), each
drawing only its shard of the weights (the same ``--seed``'s numbers) and
holding its shard of the KV cache or per-slot state: GQA, MLA and
Mamba2 stacks with dense, MoE or no FFNs (the dense family,
qwen2-moe-a2.7b, deepseek-v3-671b, mamba2-1.3b, jamba-v0.1-52b); the
encoder-decoder and vision stacks, and a layout the port does not shard
(an MLA or SSD head split: ROADMAP A.3b-ii), exit with the
``NotImplementedError`` message before any rank starts; GQA heads the
ranks would split are padded (``executor.layout_config``).  Data-parallel
replicas (``data > 1``) have no flag here, as the reference's CLI has
none: they serve through ``ServeEngine(mesh=build_mesh(data=d,
model=k))`` on each rank (``executor.MeshExecutor``).  Rank 0
prints the stats line, with the per-shard plan (``shard_plan``), the
backend and the ranks a device, and writes every artifact; the heartbeat
monitor tracks one worker a rank.  ``--mesh 1`` runs the mesh executor in this process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.faults import FaultModel, FaultSpec
from repro_torch.core.policy import (
    ErrorAdaptivePolicy,
    FixedPolicy,
    IntensityGuidedPolicy,
)
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import Scheme
from repro_torch.models.layers import ModelFault
from repro_torch.models.model import Model
from repro_torch.obs import ENGINE_COUNTERS, EngineTelemetry
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.executor import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _chunk_tokens(v: str):
    """--chunk-tokens value: an int budget or 'auto' (roofline-tuned)."""
    if str(v).lower() == "auto":
        return "auto"
    return int(v)


def _draft_len(v: str):
    """--draft-len value: an int K or 'auto' (roofline-tuned)."""
    if str(v).lower() == "auto":
        return "auto"
    return int(v)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="llama3.2-1b")
    ap.add_argument("--scale", choices=["full", "smoke"], default="smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default when available) or cpu")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--abft", default="auto",
                    choices=["auto", "global", "block_1s", "off"])
    ap.add_argument("--flash-attention", action="store_true",
                    help="decode attention through the fused-ABFT flash "
                         "decode kernel")
    ap.add_argument("--inject-faults", action="store_true")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-step Bernoulli fault probability: attaches "
                         "a seeded FaultModel (0 = no campaign)")
    ap.add_argument("--fault-kind", default="transient",
                    choices=["transient", "permanent"],
                    help="one-step transients or sticky permanent faults")
    ap.add_argument("--fault-duration", type=int, default=8,
                    help="steps a sticky permanent fault persists")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultModel seed (same seed -> same schedule)")
    ap.add_argument("--fault-magnitude", type=float, default=1e4,
                    help="injected value delta (0 = random exponent-bit "
                         "flips in the f32 accumulator instead)")
    ap.add_argument("--adaptive", action="store_true",
                    help="wrap the base policy in ErrorAdaptivePolicy: "
                         "escalate to global protection under observed "
                         "faults, de-escalate with hysteresis")
    ap.add_argument("--escalate-threshold", type=float, default=0.05,
                    help="detections-per-step rate that escalates "
                         "(--adaptive)")
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--raise-on-hard-fault", action="store_true")
    ap.add_argument("--cache", choices=["dense", "paged"], default="dense")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--admit-lookahead", type=int, default=8)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted prefix sharing + copy-on-write "
                         "(paged cache)")
    ap.add_argument("--chunk-tokens", type=_chunk_tokens, default=None,
                    help="chunked-prefill step token budget (decode tokens "
                         "pack first, prompt chunks fill the rest), or "
                         "'auto': the smallest budget whose mixed step "
                         "clears the device CMR, re-tuned as occupancy "
                         "drifts")
    ap.add_argument("--spec-decode", default=None,
                    choices=["ngram", "self-draft"],
                    help="speculative decoding proposer: 'ngram' (prompt "
                         "lookup) or 'self-draft' (truncated-depth greedy "
                         "draft from the same weights); the K+1-token "
                         "verify step runs the ABFT-checked path and "
                         "greedy streams equal the unsped engine's")
    ap.add_argument("--draft-len", type=_draft_len, default="auto",
                    help="draft tokens per verify step: an int K or "
                         "'auto' (the largest K whose modeled time per "
                         "emitted token beats plain decode)")
    ap.add_argument("--draft-model", default=None, metavar="UNITS@WINDOW",
                    help="self-draft truncation 'units@window' (e.g. "
                         "'2@16'): layers kept and trailing context seen "
                         "(only with --spec-decode self-draft)")
    ap.add_argument("--plan-out", default=None,
                    help="write the engine's ProtectionPlan as JSON")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples per slot")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and sampling seed")
    ap.add_argument("--metrics-out", default=None,
                    help="write the telemetry snapshot + engine stats as "
                         "JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run")
    ap.add_argument("--log-events", action="store_true",
                    help="stream every trace event as a JSON line to "
                         "stderr")
    ap.add_argument("--mesh", type=int, default=None,
                    help="tensor-parallel width: N ranks, each serving "
                         "its shard of the params and the KV cache over a "
                         "(data=1, model=N) mesh, the protection plan "
                         "compiled from the per-shard GEMM shapes")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.draft_model and args.spec_decode != "self-draft":
        ap.error("--draft-model requires --spec-decode self-draft")
    if args.mesh is not None and args.mesh < 1:
        ap.error("--mesh must be >= 1")
    if args.mesh is None or args.mesh == 1:
        serve(args, emit=True)
    else:
        print(json.dumps(_serve_sharded(args, argv)))
    return 0


def _serve_sharded(args, argv) -> dict:
    """Check that the config serves sharded, then run ``serve`` on
    ``--mesh`` ranks; rank 0's stats line."""
    from repro_torch.distributed import spawn
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.serve.executor import check_shardable, layout_config

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = scaled_down(cfg)
    device = resolve_device(args.device)
    geometry = Mesh(grid=np.arange(args.mesh).reshape(1, args.mesh),
                    axis_names=("data", "model"),
                    devices=(device,) * args.mesh)
    try:
        Model(cfg)
        check_shardable(layout_config(cfg, geometry), geometry)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")
    lines = spawn.run(_serve_rank, args.mesh,
                      list(sys.argv[1:] if argv is None else argv),
                      device=device.type)
    return lines[0]


def _serve_rank(argv) -> dict:
    """One rank of ``--mesh N``: the whole serve on its shard."""
    return serve(_parser().parse_args(argv))


def serve(args, emit: bool = False) -> dict:
    """Build the model and the engine, serve the requests; returns the
    stats line, printed first where ``emit`` (rank 0 of a mesh writes the
    artifacts)."""
    import torch.distributed as dist

    rank0 = not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
    draft_units, draft_window = 1, 8
    if args.draft_model:
        u, _, w = args.draft_model.partition("@")
        draft_units, draft_window = int(u), int(w or 8)

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = scaled_down(cfg)
    try:
        model = Model(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")
    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    mesh, shard = args.mesh, None
    if mesh is not None and mesh > 1:
        # each rank draws its own shard alone (``init_params(mesh=)``)
        from repro_torch.distributed.mesh import build_mesh, rank_devices

        mesh = shard = build_mesh(model=mesh, data=1,
                                  devices=rank_devices(device.type))
        device = mesh.device
    params = model.init_params(args.seed, dtype=dtype, device=device,
                               mesh=shard)
    if args.abft == "off":
        abft = ABFTConfig(enabled=False,
                          flash_attention=args.flash_attention)
    else:
        pol = (IntensityGuidedPolicy() if args.abft == "auto"
               else FixedPolicy(Scheme(args.abft)))
        if args.adaptive:
            pol = ErrorAdaptivePolicy(
                pol, detection_threshold=args.escalate_threshold)
        abft = ABFTConfig.from_policy(pol,
                                      flash_attention=args.flash_attention)
    fault_model = None
    if args.fault_rate > 0:
        fault_model = FaultModel(
            transient_rate=(args.fault_rate
                            if args.fault_kind == "transient" else 0.0),
            permanent_rate=(args.fault_rate
                            if args.fault_kind == "permanent" else 0.0),
            permanent_duration=args.fault_duration,
            seed=args.fault_seed, layers=cfg.n_layers,
            dtype=torch.float32, magnitude=args.fault_magnitude or None)
    telemetry = None
    if args.metrics_out or args.trace_out or args.log_events:
        sink = None
        if args.log_events:
            def sink(ev):
                print(json.dumps(ev), file=sys.stderr)
        telemetry = EngineTelemetry(
            trace=bool(args.trace_out or args.log_events), trace_sink=sink)
    try:
        engine = ServeEngine(
            model, params, slots=args.slots, max_len=args.max_len, abft=abft,
            dtype=dtype, device=device, cache_kind=args.cache,
            block_size=args.block_size, num_blocks=args.num_blocks,
            admit_lookahead=args.admit_lookahead,
            prefix_sharing=args.prefix_sharing,
            chunk_tokens=args.chunk_tokens,
            temperature=args.temperature, top_k=args.top_k, seed=args.seed,
            telemetry=telemetry, fault_model=fault_model,
            spec_decode=(args.spec_decode.replace("-", "_")
                         if args.spec_decode else None),
            draft_len=args.draft_len if args.spec_decode else None,
            draft_units=draft_units, draft_window=draft_window,
            policy=RecoveryPolicy(
                max_retries=args.max_retries,
                evict_on_hard_fault=not args.raise_on_hard_fault),
            mesh=mesh)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    heartbeats = None
    if engine.mesh is not None:
        # one liveness worker a rank, on the telemetry registry
        from repro_torch.runtime.heartbeat import HeartbeatMonitor

        heartbeats = HeartbeatMonitor(
            [f"rank{r}:{d}" for r, d in enumerate(engine.mesh.devices)],
            registry=telemetry.registry if telemetry is not None
            else None)
    if args.plan_out and rank0:
        with open(args.plan_out, "w") as fh:
            fh.write(engine.plan.to_json())
        print(f"wrote protection plan -> {args.plan_out}")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=rng.integers(4, 12)).astype(
                        np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    fault_at = None
    if args.inject_faults:
        fault_at = (3, ModelFault.at(0, "mlp_down",
                                     FaultSpec.value(0, 1, 1e5)))
    t0 = time.perf_counter()
    results = engine.run(reqs, fault_at=fault_at)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = engine.stats
    if heartbeats is not None:
        from repro_torch.distributed.collectives import check_same

        # every rank reached here with the same streams and counters
        check_same({"streams": {r.uid: r.generated for r in reqs},
                    "tokens": st.tokens, "retries": st.retries},
                   engine.executor.tp, "the served streams")
        for w in list(heartbeats.workers):
            heartbeats.beat(w)
        assert not heartbeats.check()
    if telemetry is not None:
        # TTFT/ITL histograms: the CLI owns arrival time
        for r in reqs:
            if r.times:
                telemetry.observe_ttft(r.times[0] - t0)
            for a, b in zip(r.times, r.times[1:]):
                telemetry.observe_itl(b - a)
    schemes = sorted({e["scheme"] for e in st.selection_trace})
    tp = engine.executor.tp
    line = {
        "device": str(device),
        "requests": len(results),
        "tokens": st.tokens,
        "tokens_per_s": st.tokens / dt,
        "faults_detected": st.faults_detected,
        "retries": st.retries,
        "hard_faults": st.hard_faults,
        "evictions": st.evictions,
        "rejections": st.rejections,
        "prefix_hit_rate": st.prefix_hit_rate,
        "cow_copies": st.cow_copies,
        "prefill_chunks": st.prefill_chunks,
        "mixed_steps": st.mixed_steps,
        "decode_only_steps": st.decode_only_steps,
        "campaign": ({
            "faults_injected": st.faults_injected,
            "faults_corrected": st.faults_corrected,
            "faults_uncorrected": st.faults_uncorrected,
            "sdc_faults": st.sdc_faults,
            "masked_faults": st.masked_faults,
            "schedule": fault_model.schedule,
        } if fault_model is not None else None),
        "protection_level": engine.protection_level,
        "protection_escalations": st.protection_escalations,
        "protection_deescalations": st.protection_deescalations,
        "chunk_tokens": engine.chunk_tokens,
        "chunk_budget_retunes": st.chunk_budget_retunes,
        "spec_decode": ({
            "proposer": engine.spec.name,
            "draft_len": engine.draft_len,
            "draft_proposed": st.draft_proposed,
            "draft_accepted": st.draft_accepted,
            "accept_rate": (st.draft_accepted / st.draft_proposed
                            if st.draft_proposed else None),
            "verify_retries": st.verify_retries,
        } if engine.spec is not None else None),
        "step_schemes": schemes,
        "model_parallel": engine.model_parallel,
        "shard_plan": ([{"layer": r["layer"], "scheme": r["scheme"],
                         "ai": r["ai"], "bound": r["bound"]}
                        for r in engine.plan.report_rows()]
                       if engine.mesh is not None else None),
        "backend": tp.backend if tp is not None else None,
        "ranks_per_device": (_ranks_per_device(engine.mesh)
                             if engine.mesh is not None else None),
        "errors": {r.uid: r.error for r in reqs if r.error},
        "cache": engine.cache_stats(),
        "telemetry": (telemetry.faults.snapshot()
                      if telemetry is not None else None),
    }
    if not rank0:
        return line
    if emit:
        print(json.dumps(line))
    if args.metrics_out:
        artifact = telemetry.snapshot()
        artifact["engine_stats"] = {
            k: getattr(st, a) for k, a in ENGINE_COUNTERS.items()}
        artifact["counters_match_stats"] = telemetry.counters_match(st)
        with open(args.metrics_out, "w") as fh:
            json.dump(artifact, fh, indent=2)
        print(f"wrote metrics snapshot -> {args.metrics_out}")
    if args.trace_out:
        telemetry.tracer.write(args.trace_out)
        print(f"wrote trace ({len(telemetry.tracer.events)} events) -> "
              f"{args.trace_out}")
    return line


def _ranks_per_device(mesh) -> int:
    devs = [str(d) for d in mesh.devices]
    return max(devs.count(d) for d in devs)


if __name__ == "__main__":
    raise SystemExit(main())
