"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes the serving
path gives it, serves full-width llama3.2-1b (random weights from a seed)
through ``repro_torch.serve.engine.ServeEngine`` on the dense and the
paged cache, with a fault-injected run and a ``global``-scheme run, and
times the kernels at the decode step's shapes.  Each phase prints one
JSON line; any failure exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k3", "engine", "timing")
HBM_BW = 3.35e12          # H100 SXM data sheet, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
# the llama3.2-1b GEMMs (K, N) and token counts K1 is checked at
K1_SHAPES = {"q": (2048, 2048), "kv": (2048, 512), "up": (2048, 8192),
             "down": (8192, 2048), "head": (2048, 128256)}
K1_M = (4, 8, 40, 512)
ENGINE_ARCH = "llama3.2-1b"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def need(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_graph(fn, iters: int = 10) -> float:
    """Device milliseconds of ``fn()``: one eager warm-up, then ``fn``
    captured into a CUDA graph and replayed, so host launch overhead (the
    Python wrappers, ctypes, allocation) is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed(graph.replay, iters=iters, warmup=1)


# ------------------------------------------------------------------ K1

def k1_checks(dev) -> dict:
    """K1 against its plain version: three modes x bf16/f32 x llama GEMM
    shapes at M in {4, 8, 40, 512}, the tied head through ``embed.T``.

    Tolerances: y in f32 agrees within 1e-4 x max|y| (f32 sums over K <=
    8192 in another order); y in bf16 within 2^-7 x max|y| (one bf16
    rounding of either side); bounds within 1e-4 relative (sums of
    magnitudes, order only); clean residuals stay under the threshold on
    both sides (they are rounding noise, not comparable element-wise)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.schemes import BlockShape
    from repro_torch.kernels import ops
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = K1_SHAPES
    worst = 0.0
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        ws = {}
        for name, (k, n) in shapes.items():
            if name == "head":     # the tied head: a transposed view
                ws[name] = (0.02 * torch.randn(n, k, generator=gen,
                                               device=dev)).to(dtype).t()
            else:
                ws[name] = (0.02 * torch.randn(k, n, generator=gen,
                                               device=dev)).to(dtype)
        for m in K1_M:
            for name, w in ws.items():
                k, n = w.shape
                x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                out_dtype = torch.float32 if name == "head" else dtype
                for mode in ("1s", "2s", "replica"):
                    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                                  ((256, m), (512, k), (256, n)))
                    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn,
                              out_dtype=out_dtype)
                    y, res, bnd = abft_matmul_kernel(x, w, **kw)
                    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
                    torch.cuda.synchronize()
                    scale = yp.float().abs().max().item()
                    err = (y.float() - yp.float()).abs().max().item()
                    tol = (1e-4 if out_dtype == torch.float32
                           else 2 ** -7) * scale
                    need(err <= tol, f"K1 y {name} m={m} {mode} {dtype}: "
                         f"err {err} > {tol}")
                    worst = max(worst, err / max(scale, 1e-30))
                    berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(
                        1e-30)).max().item()
                    need(berr <= 1e-4, f"K1 bnd {name} m={m} {mode}: {berr}")
                    _, chk = ops.abft_matmul(x, w, mode=mode,
                                             out_dtype=out_dtype)
                    need(not bool(chk.flag),
                         f"K1 false flag {name} m={m} {mode} {dtype}")
                    cases += 1
                    if m in (K1_M[0], K1_M[-1]):
                        _k1_fault_check(ops, FaultSpec, x, w, mode,
                                        out_dtype, name)
        del ws
    return {"cases": cases, "max_rel_err_y": worst,
            "blocks": BlockShape().__dict__}


def _k1_fault_check(ops, FaultSpec, x, w, mode, out_dtype, name):
    """A value fault and a bit-flip fault are flagged at their (block_i,
    block_j, row) by the kernel and by the plain version alike.  Both
    faults are far above the threshold: the two-sided scalar threshold
    of a 256 x 256 block at K = 8192 is ~1e3, and a flip that shrinks an
    element of magnitude ~3 to ~0 is below any block check's noise."""
    from repro_torch.kernels.ref import abft_matmul_ref

    m, k = x.shape
    n = w.shape[1]
    row, col = m - 1, n // 2 + 3
    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                  ((256, m), (512, k), (256, n)))
    # an exponent flip that scales the element up by >= 2^32: bit 30 when
    # |y| < 2 (exponent < 128), else bit 29 (exponent in [128, 160))
    v = (x[row].float() @ w[:, col].float()).abs().item()
    for fault in (FaultSpec.value(row, col, 1e5),
                  FaultSpec.bitflip(row, col, 30 if v < 2 else 29)):
        _, chk = ops.abft_matmul(x, w, mode=mode, out_dtype=out_dtype,
                                 fault=fault)
        fidx = (row // bm, col // bn, row % bm, col % bn, 1, fault.bit)
        _, resp, _ = abft_matmul_ref(x, w, fidx, fault.delta, mode=mode,
                                     bm=bm, bk=bk, bn=bn,
                                     out_dtype=out_dtype)
        need(bool(chk.flag), f"K1 missed fault {name} {mode} {fault}")
        want = (row // bm, col // bn) + (() if mode == "2s"
                                         else (row % bm,))
        for who, res in (("kernel", chk.residual), ("plain", resp)):
            res = res.nan_to_num(float("inf"))
            at = np.unravel_index(int(res.argmax().item()), res.shape)
            need(tuple(int(a) for a in at) == want,
                 f"K1 {who} fault {name} {mode} at {at}, expected {want}")


# ------------------------------------------------------------------ K3

def k3_checks(dev) -> dict:
    """K3 against its plain version, dense and paged: B=4, KV=8, gq=4,
    d=64, BS=16, ragged lengths, a permuted table with sentinel tails and
    garbage in every slot past a row's length.

    Tolerances: outputs within 2^-7 x max|o| in bf16 (one rounding of
    either side) and 1e-5 x max|o| in f32 (softmax sums in another
    order); bounds within 1e-4 relative; no flag on clean inputs."""
    from repro_torch.kernels.flash_attention import (
        flash_decode_kernel,
        flash_decode_ref,
    )
    from repro_torch.kernels.flash_ops import flash_decode, flash_decode_paged

    gen = torch.Generator(device=dev).manual_seed(2)
    B, KV, G, D, BS, S = 4, 8, 4, 64, 16, 256
    W = S // BS
    NB = B * W + 7
    lengths = torch.tensor([1, 17, 100, 255], dtype=torch.int32, device=dev)
    perm = torch.randperm(NB, generator=gen, device=dev)[:B * W]
    table = perm.reshape(B, W).to(torch.int32).contiguous()
    table[0, 1:] = NB                          # sentinel tail
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, 1, KV * G, D, generator=gen, device=dev).to(dtype)
        # garbage everywhere, including slots past each row's length
        kp = (3 * torch.randn(NB, BS, KV, D, generator=gen,
                              device=dev)).to(dtype)
        vp = (3 * torch.randn(NB, BS, KV, D, generator=gen,
                              device=dev)).to(dtype)
        kd = (3 * torch.randn(B, S, KV, D, generator=gen,
                              device=dev)).to(dtype)
        vd = (3 * torch.randn(B, S, KV, D, generator=gen,
                              device=dev)).to(dtype)
        tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
        for kind, args in (("paged", (kp, vp, table, BS)),
                           ("dense", (kd, vd, None, 128))):
            kc, vc, tb, block = args
            got = flash_decode_kernel(q, kc, vc, tb, lengths, block=block)
            ref = flash_decode_ref(q, kc, vc, tb, lengths, block=block)
            torch.cuda.synchronize()
            scale = ref[0].float().abs().max().item()
            err = (got[0].float() - ref[0].float()).abs().max().item()
            need(err <= tol * scale, f"K3 {kind} {dtype} out err {err}")
            for gi, ri, nm in ((got[2], ref[2], "bnd_s"),
                               (got[4], ref[4], "bnd_pv")):
                rel = ((gi - ri).abs() / ri.abs().clamp_min(1e-30)).max()
                need(rel.item() <= 1e-4, f"K3 {kind} {nm} rel {rel.item()}")
            if kind == "paged":
                _, chk = flash_decode_paged(q, kp, vp, table, lengths)
            else:
                _, chk = flash_decode(q, kd, vd, lengths)
            need(not bool(chk.flag), f"K3 false flag {kind} {dtype}")
            out[f"{kind}_{str(dtype)[6:]}_max_abs_err"] = err
    return out


# ------------------------------------------------------------------ engine

def engine_runs(dev) -> dict:
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.schemes import Scheme
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]

    def serve(cache_kind, policy, fault_at=None, label=""):
        abft = ABFTConfig.from_policy(policy, hardware=NVIDIA_H100_SXM,
                                      flash_attention=True)
        eng = ServeEngine(model, params, slots=4, max_len=512, abft=abft,
                          dtype=torch.bfloat16, device=dev,
                          cache_kind=cache_kind)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        t_pre, t_dec = [], []
        admit, step = eng.admit, eng.step

        def timed_admit(*a, **k):
            t = time.perf_counter()
            r = admit(*a, **k)
            torch.cuda.synchronize()
            t_pre.append(time.perf_counter() - t)
            return r

        def timed_step(*a, **k):
            t = time.perf_counter()
            r = step(*a, **k)
            torch.cuda.synchronize()
            if r:
                t_dec.append(time.perf_counter() - t)
            return r

        eng.admit, eng.step = timed_admit, timed_step
        torch.cuda.synchronize()
        K1.launches = K3.launches = 0        # counts of THIS run only
        t0 = time.perf_counter()
        results = eng.run(reqs, fault_at=fault_at)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {"abft_matmul": K1.launches, "flash_decode": K3.launches}
        errors = {r.uid: r.error for r in reqs if r.error}
        need(not errors, f"engine {label}: errors {errors}")
        need(all(len(results[i]) == 16 for i in range(len(reqs))),
             f"engine {label}: incomplete streams")
        need(all(0 <= t < cfg.vocab_size for s in results.values()
                 for t in s), f"engine {label}: token out of range")
        st = eng.stats
        rec = dict(label=label, cache=cache_kind, tokens=st.tokens,
                   seconds=dt, tokens_per_s=st.tokens / dt,
                   prefill_ms=[1e3 * t for t in t_pre],
                   decode_step_ms_median=1e3 * float(np.median(t_dec)),
                   decode_steps=len(t_dec), launches=launches,
                   faults_detected=st.faults_detected, retries=st.retries,
                   hard_faults=st.hard_faults,
                   selection_trace=[f'{e["decode"]}+{e["prefill"]}:'
                                    f'{e["scheme"]}'
                                    for e in st.selection_trace])
        emit("engine", **rec)
        return results, rec, eng

    intensity = IntensityGuidedPolicy()
    serve("dense", intensity, label="warmup")
    dense, rec_dense, eng = serve("dense", intensity, label="dense")
    need(rec_dense["launches"]["abft_matmul"] > 0
         and rec_dense["launches"]["flash_decode"] > 0,
         "main path did not launch both kernels")
    paged, rec_paged, _ = serve("paged", intensity, label="paged")
    need(rec_paged["launches"]["abft_matmul"] > 0
         and rec_paged["launches"]["flash_decode"] > 0,
         "paged path did not launch both kernels")
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    faulted, rec_fault, _ = serve("dense", intensity, fault_at=(3, fault),
                                  label="dense_fault")
    need(rec_fault["faults_detected"] >= 1 and rec_fault["retries"] >= 1,
         "injected fault not detected and retried")
    need(faulted == dense, "faulted run's streams differ from the clean run")
    glob, rec_glob, _ = serve("dense", FixedPolicy(Scheme.GLOBAL),
                              label="dense_global")
    need(rec_glob["faults_detected"] == 0, "global scheme false flag")
    agree = float(np.mean([a == b for k in dense
                           for a, b in zip(dense[k], paged[k])]))
    agree_g = float(np.mean([a == b for k in dense
                             for a, b in zip(dense[k], glob[k])]))
    emit("engine_agreement", dense_vs_paged_tokens=agree,
         dense_vs_global_tokens=agree_g, fault_run_equals_clean=True)

    # small-input reference: scaled-down f32 llama on the card (kernels)
    # against the same engine on the CPU (plain versions), greedy streams
    small = scaled_down(cfg, n_layers=2)
    sm = Model(small)
    sp = sm.init_params(3, dtype=torch.float32, device="cpu")
    srng = np.random.default_rng(5)
    sprompts = [srng.integers(1, 256, size=int(n)).astype(np.int32)
                for n in srng.integers(3, 40, size=5)]
    streams = {}
    for d in ("cpu", dev):
        e = ServeEngine(sm, sp, slots=2, max_len=64, dtype=torch.float32,
                        device=d, abft=ABFTConfig(flash_attention=True))
        streams[str(d)] = e.run([Request(uid=i, prompt=p, max_new_tokens=8)
                                 for i, p in enumerate(sprompts)])
    need(streams["cpu"] == streams[str(dev)],
         "small f32 engine: card streams differ from the CPU reference")
    emit("engine_small_reference", streams_equal=True)
    return {"dense": rec_dense, "engine": eng, "params": params,
            "prompts": prompts}


def decode_profile(dev, eng_out, steps: int = 4) -> dict:
    """Where a decode step's time goes: ``steps`` decode steps of the
    dense engine (4 slots, the same configuration as the main run) under
    ``torch.profiler``.  Device ms per step is the sum of the kernels'
    device time (one stream: no overlap).  The profiler slows the host, so
    the idle share is taken against the unprofiled median decode step of
    the main run: 1 - device / that median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.serve.engine import Request, ServeEngine

    base = eng_out["engine"]
    eng = ServeEngine(base.model, eng_out["params"], slots=4, max_len=512,
                      abft=ABFTConfig(hardware=NVIDIA_H100_SXM,
                                      flash_attention=True),
                      dtype=torch.bfloat16, device=dev)
    pending = [Request(uid=i, prompt=p, max_new_tokens=steps + 2)
               for i, p in enumerate(eng_out["prompts"][:4])]
    eng.admit(pending)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            need(eng.step(), "profiled decode step decoded nothing")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_name = sorted(((e.key, e.device_time_total / 1e3 / steps,
                       e.count / steps) for e in kernels),
                     key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in by_name)
    step_ms = eng_out["dense"]["decode_step_ms_median"]
    return {"steps": steps, "profiled_wall_ms_per_step": 1e3 * wall / steps,
            "unprofiled_step_ms": step_ms,
            "device_ms_per_step": dev_ms if kernels else None,
            "idle_share": 1 - dev_ms / step_ms if kernels else None,
            "kernels_per_step": sum(r[2] for r in by_name),
            "top": [{"kernel": k[:80], "ms_per_step": ms,
                     "launches_per_step": n} for k, ms, n in by_name[:10]]}


# ------------------------------------------------------------------ timing

def _gemm_bound(m, k, n, in_bytes, out_bytes, gm_gn_rows):
    byts = m * k * in_bytes + k * n * in_bytes + m * n * out_bytes \
        + 2 * 4 * gm_gn_rows
    flops = 2.0 * m * k * n
    t_b, t_f = byts / HBM_BW, flops / PEAK_BF16
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def k1_timing(dev, params, m: int) -> dict:
    """K1 over one step's GEMMs at M=m, using the engine's own weights
    (distinct per layer, so weights come from HBM as in a real step):
    kernel, plain version, torch.matmul, and the bound.  ``ms`` etc. are
    device times (CUDA-graph replay); ``ms_eager`` includes the host
    launch overhead of the eager loop."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref

    layers = params["layers"]
    groups = {
        "q": [l["mixer"]["wq"] for l in layers],
        "kv": [l["mixer"][w] for l in layers for w in ("wk", "wv")],
        "o": [l["mixer"]["wo"] for l in layers],
        "up_gate": [l["ffn"][w] for l in layers for w in ("up", "gate")],
        "down": [l["ffn"]["down"] for l in layers],
        "head": [params["embed"].t()],
    }
    gen = torch.Generator(device=dev).manual_seed(4)
    per = {}
    tot = {"ms": 0.0, "ms_eager": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "gemms": 0}
    bound_by = set()
    for name, ws in groups.items():
        k, n = ws[0].shape
        out_dtype = torch.float32 if name == "head" else torch.bfloat16
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                      ((256, m), (512, k), (256, n)))
        kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)

        def kern():
            for w in ws:
                abft_matmul_kernel(x, w, **kw)

        def plain():
            for w in ws:
                abft_matmul_ref(x, w, **kw)

        def lib():
            for w in ws:
                torch.matmul(x, w)

        rows = -(-m // bm) * -(-n // bn) * bm
        b_ms, by = _gemm_bound(m, k, n, 2, out_dtype.itemsize, rows)
        rec = {"gemms": len(ws), "m": m, "k": k, "n": n,
               "ms": timed_graph(kern, iters=5),
               "ms_eager": timed(kern, iters=5),
               "plain_ms": timed_graph(plain, iters=2),
               "library_ms": timed_graph(lib, iters=5),
               "bound_ms": b_ms * len(ws), "bound_by": by}
        per[name] = rec
        bound_by.add(by)
        for key in ("ms", "ms_eager", "plain_ms", "library_ms",
                    "bound_ms"):
            tot[key] += rec[key]
        tot["gemms"] += len(ws)
    tot["bound_by"] = "bytes" if bound_by == {"bytes"} else (
        "operations" if bound_by == {"operations"} else "mixed")
    emit("k1_timing", m=m, per_shape=per, step_total=tot)
    return tot


def k3_timing(dev, eng, prompts) -> dict:
    """K3 over one decode step's 16 layers on the engine's dense cache
    at the lengths of the first four requests' last decode step."""
    from repro_torch.kernels.flash_attention import (
        flash_decode_kernel,
        flash_decode_ref,
    )

    cfg = eng.model.cfg
    caches = eng.cache
    B = 4
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lengths = torch.tensor([len(p) + 15 for p in prompts[:B]],
                           dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    S = caches[0]["k"].shape[1]
    block = min(128, -(-S // 8) * 8)

    def kern():
        for c in caches:
            flash_decode_kernel(q, c["k"], c["v"], None, lengths, block=block)

    def plain():
        for c in caches:
            flash_decode_ref(q, c["k"], c["v"], None, lengths, block=block)

    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)

    def lib():
        for c in caches:
            torch.nn.functional.scaled_dot_product_attention(
                qt, c["k"].transpose(1, 2), c["v"].transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

    o = flash_decode_kernel(q, caches[0]["k"], caches[0]["v"], None,
                            lengths, block=block)[0]
    op = flash_decode_ref(q, caches[0]["k"], caches[0]["v"], None, lengths,
                          block=block)[0]
    err = (o.float() - op.float()).abs().max().item()
    valid = int(lengths.sum().item())
    byts = len(caches) * (2 * valid * KV * D * 2 + 2 * B * H * D * 2
                          + 4 * B * H * 4 + B * 4)
    flops = len(caches) * 4.0 * valid * H * D
    t_b, t_f = byts / HBM_BW, flops / PEAK_BF16
    rec = {"launches_timed": len(caches), "B": B, "S": S, "block": block,
           "lengths": lengths.tolist(), "ms": timed_graph(kern, iters=10),
           "ms_eager": timed(kern, iters=10),
           "plain_ms": timed_graph(plain, iters=2),
           "library_ms": timed_graph(lib, iters=10),
           "bound_ms": max(t_b, t_f) * 1e3,
           "bound_by": "bytes" if t_b >= t_f else "operations",
           "max_abs_err": err}
    emit("k3_timing", **rec)
    return rec


def k1_max_err(dev, params) -> float:
    """K1 vs plain at the decode step's shapes (M=4, first layer + head)."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    lp = params["layers"][0]
    for w, od in ((lp["mixer"]["wq"], torch.bfloat16),
                  (lp["ffn"]["down"], torch.bfloat16),
                  (params["embed"].t(), torch.float32)):
        k, n = w.shape
        x = torch.randn(4, k, generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(mode="1s", bm=8, bk=min(512, k), bn=min(256, n),
                  out_dtype=od)
        y = abft_matmul_kernel(x, w, **kw)[0]
        yp = abft_matmul_ref(x, w, **kw)[0]
        worst = max(worst, (y.float() - yp.float()).abs().max().item())
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import abft_matmul, flash_attention, library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    built = library.build_all(force=True)
    for lib in library.SOURCES:
        library.library(lib)
    emit("build", seconds=time.perf_counter() - t, sources=built,
         ptxas={n: [ln.strip() for ln in
                    (library.BUILD / f"{n}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln][:6]
                for n in library.SOURCES})
    if "k1" in phases:
        emit("k1_check", **k1_checks(dev))
    if "k3" in phases:
        emit("k3_check", **k3_checks(dev))
    kernels = None
    if "engine" in phases:
        eng_out = engine_runs(dev)
        emit("decode_profile", **decode_profile(dev, eng_out))
        if "timing" in phases:
            launches = eng_out["dense"]["launches"]
            t1 = k1_timing(dev, eng_out["params"], 4)
            k1_timing(dev, eng_out["params"], 512)
            t3 = k3_timing(dev, eng_out["engine"], eng_out["prompts"])
            kernels = [
                {"name": "abft_matmul", "route": "cuda",
                 "source": abft_matmul.KERNEL.source,
                 "replaces": "src/repro/kernels/abft_matmul.py:188",
                 "launches": launches["abft_matmul"],
                 "max_abs_err": k1_max_err(dev, eng_out["params"]),
                 "ms": t1["ms"], "plain_ms": t1["plain_ms"],
                 "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
                 "library_ms": t1["library_ms"]},
                {"name": "flash_decode", "route": "cuda",
                 "source": flash_attention.KERNEL.source,
                 "replaces": "src/repro/kernels/flash_attention.py:267",
                 "launches": launches["flash_decode"],
                 "max_abs_err": t3["max_abs_err"],
                 "ms": t3["ms"], "plain_ms": t3["plain_ms"],
                 "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
                 "library_ms": t3["library_ms"]},
            ]
    for line in smi:
        print(line)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
