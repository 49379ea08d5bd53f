"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes its path gives
it, and drives full-width llama3.2-1b (random weights from a seed) three
ways: served through ``repro_torch.serve.engine.ServeEngine`` on the dense
and the paged cache (with a fault-injected run and a ``global``-scheme
run), a full-sequence ``Model.forward`` with the flash attention kernel on
and off, and four f32 training steps through
``repro_torch.train.trainer.Trainer``.  The ``campaign`` phase runs the
reference's fault-campaign protocol on the served path (seeded fault
models, shadow classification, hard faults, adaptive escalation,
sampling, the cost of tracing) and ``profile`` times ``block_1s`` against
``global`` per GEMM shape with ``build_profile_table`` and serves under
the resulting ``ProfileGuidedPolicy``.  Then it times the kernels at
their paths' shapes.  ``sharing`` serves prefix and long-prompt traffic
with prefix sharing and chunked prefill (llama3.2-1b, then qwen3-14b),
every greedy stream held to the plain paged run's, faults included;
``spec`` serves copy and fresh traffic with speculative decoding (n-gram
and self-draft proposers, the K+1-row verify step through K1), every
greedy stream held to the unsped run's, faults included;
``family`` serves and scores the rest of the dense family; and ``moe``
holds K1 batched over experts against its plain version, then serves,
scores and times full-width qwen2-moe-a2.7b.  Each phase
prints JSON lines; any failure exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k2", "k3", "engine", "forward", "train",
          "campaign", "profile", "timing", "sharing", "spec", "family",
          "moe")
HBM_BW = 3.35e12          # H100 SXM data sheet, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # f32 outside the tensor cores (TF32 off)
# the llama3.2-1b GEMMs (K, N) and token counts K1 is checked at
K1_SHAPES = {"q": (2048, 2048), "kv": (2048, 512), "up": (2048, 8192),
             "down": (8192, 2048), "head": (2048, 128256)}
K1_M = (4, 8, 40, 333, 512, 2048)     # 2048: the forward's B x L rows
K1_FAULT_M = (4, 40, 333, 512, 2048)
# the serving prefill's rows, where K1 runs one K slice: a short suffix
# (one row, 8 padded tokens), a 256-token chunk, chunk batches of 2 and 4
# rows, and an admission of 4 prompts padded to 512 tokens
K1_ONE_SLICE_M = (8, 256, 512, 1024, 2048)
# the speculative verify step's slots (x 9 rows at K = 8), where K1 runs
# the decode step's K split: at 16 slots it differs from the unpinned one
K1_SPLIT_SLOTS = (4, 16)
ENGINE_ARCH = "llama3.2-1b"
# K2 at llama3.2-1b's attention shapes: (B, H, KV, D)
K2_HEADS = (2, 32, 8, 64)
FWD_B, FWD_L = 2, 1024          # the forward phase's batch
TRAIN_B, TRAIN_L, TRAIN_STEPS = 4, 128, 4
# the dense family at full width, smallest first; the score's batch
FAMILY_ARCHS = ("stablelm-1.6b", "qwen3-14b", "qwen1.5-32b")
SCORE_B, SCORE_L = 1, 1024
# the second arch of the sharing and spec phases: qwen3-14b at full width
# and 10 of its 40 layers (its gates hold the paths at another arch's
# widths, which the depth does not change; the run keeps to its time)
SIDE_ARCH, SIDE_LAYERS = "qwen3-14b", 10


def side_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SIDE_ARCH), n_layers=SIDE_LAYERS)


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


def tensor_core_instructions(so) -> dict:
    """Counts of tensor-core instructions (``HGMMA`` for wgmma, ``HMMA``
    for mma.sync) in the SASS of a built kernel library, read with the
    CUDA toolkit's ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\s{op}\.", sass))
            for op in ("HGMMA", "HMMA")}


# ------------------------------------------------------------------ K1

def k1_checks(dev) -> dict:
    """K1 against its plain version: three modes x bf16/f32 x llama GEMM
    shapes at M in ``K1_M``, the tied head through
    ``embed.T``: every pass-1 route (tensor cores for bf16 1s/2s, the
    GEMV for f32 decode — and for bf16 decode forced, as k1_timing times
    it — the SIMT pass for f32 1s/2s above 8 rows — and the CUDA-core
    tiles forced in its place, as k1_timing times them — CUDA-core tiles
    for replica).  A repeat of the SIMT pass is bit-for-bit.  The worst
    clean residual / threshold of each route taken must stay under 1.
    The same shapes and modes again with ``one_slice`` (the plan the
    serving prefill runs: one K slice at any M) at the prefill's rows
    ``K1_ONE_SLICE_M``, with the same gates and the fault checks; and
    with ``split_rows`` (the verify step's plan: the decode step's K
    split) at 4 x 9 and 16 x 9 rows, with the same gates.

    Tolerances: y in f32 agrees within 1e-4 x max|y| (f32 sums over K <=
    8192 in another order); y in bf16 within 2^-7 x max|y| (one bf16
    rounding of either side); bounds within 1e-4 relative (sums of
    magnitudes, order only); clean residuals stay under the threshold on
    both sides (they are rounding noise, not comparable element-wise)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.schemes import BlockShape
    from repro_torch.kernels import ops
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, routes
    from repro_torch.kernels.ref import abft_matmul_ref

    from repro_torch.kernels.abft_matmul import plan

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = K1_SHAPES
    worst = 0.0
    cases = 0
    ratios = {}             # route -> worst clean residual / threshold
    one_abs = {}            # dtype -> worst |y - plain| with one slice
    split_abs = {}          # dtype, rows -> the same with split_rows
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
                    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
                    scale = yp.float().abs().max().item()
                    tol = (1e-4 if out_dtype == torch.float32
                           else 2 ** -7) * scale
                    # the route taken, and the GEMV (bf16 decode) or the
                    # tiles (f32) that k1_timing times in its place
                    can = routes(x, w, bn, mode)
                    fork = [c for c in can[1:] if c == "gemv"
                            or (can[0] == "simt" and c == "tiled")]
                    for r in (can[0], *fork):
                        y, res, bnd = abft_matmul_kernel(x, w, **kw, force=r)
                        torch.cuda.synchronize()
                        if r == "simt" and mode == "1s":
                            again = abft_matmul_kernel(x, w, **kw)
                            need(all(torch.equal(a, b) for a, b in
                                     zip((y, res, bnd), again)),
                                 f"K1 simt repeat not bit-for-bit {name} "
                                 f"m={m}")
                        err = (y.float() - yp.float()).abs().max().item()
                        need(err <= tol, f"K1 y {name} m={m} {mode} {dtype} "
                             f"{r}: err {err} > {tol}")
                        worst = max(worst, err / max(scale, 1e-30))
                        berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(
                            1e-30)).max().item()
                        need(berr <= 1e-4,
                             f"K1 bnd {name} m={m} {mode} {r}: {berr}")
                    _, chk = ops.abft_matmul(x, w, mode=mode,
                                             out_dtype=out_dtype)
                    need(not bool(chk.flag),
                         f"K1 false flag {name} m={m} {mode} {dtype}")
                    r = f"k1_{can[0]}_{str(dtype)[6:]}"
                    ratios[r] = max(ratios.get(r, 0.0), _ratio(chk))
                    cases += 1
                    if m in K1_FAULT_M:
                        _k1_fault_check(ops, FaultSpec, x, w, mode,
                                        out_dtype, name)
        for m in K1_ONE_SLICE_M:
            for name, w in ws.items():
                k, n = w.shape
                x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                out_dtype = torch.float32 if name == "head" else dtype
                for mode in ("1s", "2s", "replica"):
                    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                                  ((256, m), (512, k), (256, n)))
                    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn,
                              out_dtype=out_dtype)
                    p = plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn,
                             one_slice=True)
                    need(p.slices == 1 or p.route == "gemv",
                         f"K1 one_slice {name} m={m} {mode}: {p.slices} "
                         f"slices on {p.route}")
                    yp, _, bndp = abft_matmul_ref(x, w, **kw)
                    y, _, bnd = abft_matmul_kernel(x, w, **kw,
                                                   one_slice=True)
                    torch.cuda.synchronize()
                    scale = yp.float().abs().max().item()
                    tol = (1e-4 if out_dtype == torch.float32
                           else 2 ** -7) * scale
                    err = (y.float() - yp.float()).abs().max().item()
                    need(err <= tol, f"K1 one_slice y {name} m={m} {mode} "
                         f"{dtype} {p.route}: err {err} > {tol}")
                    worst = max(worst, err / max(scale, 1e-30))
                    key = str(dtype)[6:]
                    one_abs[key] = max(one_abs.get(key, 0.0), err)
                    berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(
                        1e-30)).max().item()
                    need(berr <= 1e-4, f"K1 one_slice bnd {name} m={m} "
                         f"{mode} {p.route}: {berr}")
                    _, chk = ops.abft_matmul(x, w, mode=mode,
                                             out_dtype=out_dtype,
                                             one_slice=True)
                    need(not bool(chk.flag), f"K1 one_slice false flag "
                         f"{name} m={m} {mode} {dtype}")
                    r = f"k1_{p.route}_{key}_one_slice"
                    ratios[r] = max(ratios.get(r, 0.0), _ratio(chk))
                    cases += 1
                    if m in (8, 256, 2048):
                        _k1_fault_check(ops, FaultSpec, x, w, mode,
                                        out_dtype, name, one_slice=True)
        # the verify step's plan: B x T rows with the decode step's K
        # split (``split_rows=B``), 4 and 16 slots at K = 8
        for slots in K1_SPLIT_SLOTS:
            m = slots * 9
            for name, w in ws.items():
                k, n = w.shape
                x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                out_dtype = torch.float32 if name == "head" else dtype
                for mode in ("1s", "2s", "replica"):
                    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                                  ((256, m), (512, k), (256, n)))
                    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn,
                              out_dtype=out_dtype)
                    p = plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn,
                             split_rows=slots)
                    yp, _, bndp = abft_matmul_ref(x, w, **kw)
                    y, _, bnd = abft_matmul_kernel(x, w, **kw,
                                                   split_rows=slots)
                    torch.cuda.synchronize()
                    scale = yp.float().abs().max().item()
                    tol = (1e-4 if out_dtype == torch.float32
                           else 2 ** -7) * scale
                    err = (y.float() - yp.float()).abs().max().item()
                    need(err <= tol, f"K1 split_rows={slots} y {name} m={m} "
                         f"{mode} {dtype} {p.route}: err {err} > {tol}")
                    worst = max(worst, err / max(scale, 1e-30))
                    key = f"{str(dtype)[6:]}_{slots}x9"
                    split_abs[key] = max(split_abs.get(key, 0.0), err)
                    berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(
                        1e-30)).max().item()
                    need(berr <= 1e-4, f"K1 split_rows bnd {name} m={m} "
                         f"{mode} {p.route}: {berr}")
                    _, chk = ops.abft_matmul(x.reshape(slots, 9, k), w,
                                             mode=mode, out_dtype=out_dtype,
                                             decode_rows=slots)
                    need(not bool(chk.flag), f"K1 decode_rows false flag "
                         f"{name} m={m} {mode} {dtype}")
                    r = f"k1_{p.route}_{str(dtype)[6:]}_split_rows"
                    ratios[r] = max(ratios.get(r, 0.0), _ratio(chk))
                    cases += 1
        del ws
    need(all(v < 1 for v in ratios.values()),
         f"K1 clean residual at or over its threshold: {ratios}")
    return {"cases": cases, "max_rel_err_y": worst,
            "one_slice_max_abs_err": one_abs,
            "split_rows_max_abs_err": split_abs,
            "worst_clean_residual_over_threshold": ratios,
            "blocks": BlockShape().__dict__}


def _ratio(chk) -> float:
    """Worst clean residual / threshold of a CheckResult (the reference's
    thresholds; a flag is raised at > 1)."""
    return (chk.residual / chk.threshold).max().item()


def _k1_fault_check(ops, FaultSpec, x, w, mode, out_dtype, name,
                    one_slice: bool = False):
    """A value fault and a bit-flip fault are flagged at their (block_i,
    block_j, row) by the kernel (with ``one_slice``, on that plan) and by
    the plain version alike.  Both
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
                                 fault=fault, one_slice=one_slice)
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

def _k3_close(got, ref, tol, what):
    """K3's outputs against a plain version's: o within ``tol`` x max|o|,
    the two bounds within 1e-4 relative.  Returns the output's error."""
    scale = ref[0].float().abs().max().item()
    err = (got[0].float() - ref[0].float()).abs().max().item()
    need(err <= tol * scale, f"K3 {what}: out err {err} (max|o| {scale})")
    for gi, ri, nm in ((got[2], ref[2], "bnd_s"), (got[4], ref[4],
                                                    "bnd_pv")):
        rel = ((gi - ri).abs() / ri.abs().clamp_min(1e-30)).max().item()
        need(rel <= 1e-4, f"K3 {what} {nm} rel {rel}")
    return err


def k3_checks(dev) -> dict:
    """K3 against its plain versions, dense and paged, at the serving
    engine's shapes: B=4, KV=8, gq=4, d=64, S=512 (its max_len), BS=16,
    ragged lengths, a permuted table with sentinel tails and garbage in
    every slot past a row's length.  Every forced split count 1..W (32
    paged; 4 dense at the 128-key block) against the plain split walk
    (``flash_decode_split_ref``) and the sequential walk; the
    ``decode_splits`` launch twice, bit-for-bit.  Then other head groups
    and row widths (G = 3, 6, 16; d = 80, 96 in bf16, 128 in f32), each
    at a few split counts against the sequential walk.

    Tolerances: outputs within 2^-7 x max|o| in bf16 (one rounding of
    either side) and 1e-5 x max|o| in f32 (softmax sums in another
    order); bounds within 1e-4 relative; no flag on clean inputs."""
    from repro_torch.kernels.flash_attention import (
        decode_splits,
        flash_decode_kernel,
        flash_decode_ref,
        flash_decode_split_ref,
    )
    from repro_torch.kernels.flash_ops import flash_decode, flash_decode_paged

    gen = torch.Generator(device=dev).manual_seed(2)
    B, KV, G, D, BS, S = 4, 8, 4, 64, 16, 512
    W = S // BS
    NB = B * W + 7
    lengths = torch.tensor([1, 17, 300, 511], dtype=torch.int32, device=dev)
    perm = torch.randperm(NB, generator=gen, device=dev)[:B * W]
    table = perm.reshape(B, W).to(torch.int32).contiguous()
    table[0, 1:] = NB                          # sentinel tail
    out = {}
    cases = 0
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
            width = W if kind == "paged" else -(-S // block)
            seq = flash_decode_ref(q, kc, vc, tb, lengths, block=block)
            worst = 0.0
            for splits in range(1, width + 1):
                got = flash_decode_kernel(q, kc, vc, tb, lengths,
                                          block=block, splits=splits)
                ref = flash_decode_split_ref(q, kc, vc, tb, lengths,
                                             block=block, splits=splits)
                torch.cuda.synchronize()
                for who, r in (("split", ref), ("walk", seq)):
                    worst = max(worst, _k3_close(
                        got, r, tol, f"{kind} {dtype} splits={splits} vs "
                        f"{who}"))
                cases += 1
            chosen = decode_splits(B, KV, width, block, G)
            a = flash_decode_kernel(q, kc, vc, tb, lengths, block=block)
            b = flash_decode_kernel(q, kc, vc, tb, lengths, block=block)
            need(all(torch.equal(u, v) for u, v in zip(a, b)),
                 f"K3 {kind} {dtype} repeat not bit-for-bit")
            if kind == "paged":
                _, chk = flash_decode_paged(q, kp, vp, table, lengths)
            else:
                _, chk = flash_decode(q, kd, vd, lengths)
            need(not bool(chk.flag), f"K3 false flag {kind} {dtype}")
            out[f"{kind}_{str(dtype)[6:]}_max_abs_err"] = worst
            out[f"{kind}_splits"] = {"W": width, "chosen": chosen}
    # other head groups and row widths: G = 3 and 6 round up to an
    # instantiation, G = 16 takes two CTAs a kv head, d = 80 and 96 (bf16)
    # pad their rows of 10 and 12 units to 16, d = 128 (f32) fills 32
    # units and takes one chunk buffer a warp
    shapes = {}
    for g2, d2, dt in ((3, 64, torch.bfloat16), (6, 96, torch.bfloat16),
                       (16, 64, torch.bfloat16), (4, 80, torch.bfloat16),
                       (2, 128, torch.float32)):
        kv2 = 2
        tol = 2 ** -7 if dt == torch.bfloat16 else 1e-5
        q2 = torch.randn(B, 1, kv2 * g2, d2, generator=gen,
                         device=dev).to(dt)
        kp2, vp2 = ((3 * torch.randn(NB, BS, kv2, d2, generator=gen,
                                     device=dev)).to(dt) for _ in range(2))
        kd2, vd2 = ((3 * torch.randn(B, S, kv2, d2, generator=gen,
                                     device=dev)).to(dt) for _ in range(2))
        worst = 0.0
        for kind, (kc, vc, tb, block) in (("paged", (kp2, vp2, table, BS)),
                                          ("dense", (kd2, vd2, None, 128))):
            width = W if kind == "paged" else -(-S // block)
            seq = flash_decode_ref(q2, kc, vc, tb, lengths, block=block)
            for splits in sorted({1, 3, width,
                                  decode_splits(B, kv2, width, block, g2)}):
                got = flash_decode_kernel(q2, kc, vc, tb, lengths,
                                          block=block, splits=splits)
                worst = max(worst, _k3_close(
                    got, seq, tol, f"{kind} G={g2} d={d2} {dt} "
                    f"splits={splits}"))
                cases += 1
        shapes[f"G{g2}_d{d2}_{str(dt)[6:]}_max_abs_err"] = worst
    out["other_shapes"] = shapes
    out["cases"] = cases
    return out


# ------------------------------------------------------------------ K2

def _k2_inputs(gen, dev, B, L, H, KV, D, dtype, Lk=None):
    Lk = L if Lk is None else Lk
    q = torch.randn(B, L, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    v = (3 * torch.randn(B, Lk, KV, D, generator=gen, device=dev)).to(dtype)
    return q, k, v


def _k2_blocks(L, Lk=None, b=128):
    Lk = L if Lk is None else Lk
    bq, bk = min(b, -(-L // 8) * 8), min(b, -(-Lk // 8) * 8)
    return dict(bq=bq, bk=bk, lq_pad=-(-L // bq) * bq, lk_pad=-(-Lk // bk) * bk)


def k2_checks(dev) -> dict:
    """K2 against its plain version at llama3.2-1b's heads (B=2, H=32,
    KV=8, D=64): causal at L in {1, 7, 128, 333, 1024} and non-causal at
    L=256, bf16 and f32; non-causal padding raises; clean inputs raise no
    flag; a fault in the second q block is flagged at its row; a repeat is
    bit-for-bit.

    Tolerances: o in f32 within 1e-5 x max|o| (softmax sums in another
    order); o in bf16 element by element within 2^-7 |o_ref| + 1e-5 x
    max|o| (that f32 difference, then one bf16 rounding of either side,
    at most one ulp of the element: a late row, where |o| is far below
    the first rows' max, is held to its own size); the two bounds within 1e-4 relative (magnitude sums, order only); the two
    residuals are rounding noise: each side's stays under its threshold.
    A faulted PV residual (1e4) agrees within 1e-4 relative."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.core.faults import FaultSpec
    from repro_torch.kernels.flash_attention import (
        f32_bits,
        flash_attention_kernel,
        flash_attention_ref,
        tc_path,
    )
    from repro_torch.kernels.flash_ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(8)
    B, H, KV, D = K2_HEADS
    worst = {}
    ratios = {}             # route -> worst clean residual / threshold
    worst_share = 0.0       # the bf16 elementwise error / its tolerance
    cases = 0

    def tau(bnd, depth):
        return ATOL + tolerance_scale(depth) * bnd

    for dtype in (torch.bfloat16, torch.float32):
        for L, causal in ((1, True), (7, True), (128, True), (333, True),
                          (1024, True), (256, False)):
            q, k, v = _k2_inputs(gen, dev, B, L, H, KV, D, dtype)
            kw = dict(causal=causal, **_k2_blocks(L))
            got = flash_attention_kernel(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            o_ref = ref[0].float()
            scale = o_ref.abs().max().item()
            diff = (got[0].float() - o_ref).abs()
            err = diff.max().item()
            if dtype == torch.bfloat16:
                share = (diff / (2 ** -7 * o_ref.abs() + 1e-5 * scale)
                         ).max().item()
                worst_share = max(worst_share, share)
                need(share <= 1, f"K2 o L={L} causal={causal} bf16: an "
                     f"element off by {share} x its tolerance")
            else:
                need(err <= 1e-5 * scale, f"K2 o L={L} causal={causal} "
                     f"f32: err {err} > {1e-5 * scale}")
            for gi, ri, nm in ((got[2], ref[2], "bnd_s"),
                               (got[4], ref[4], "bnd_pv")):
                rel = ((gi - ri).abs() / ri.abs().clamp_min(1e-30)).max()
                need(rel.item() <= 1e-4, f"K2 {nm} L={L} {dtype}: rel "
                     f"{rel.item()}")
            for side in (got, ref):
                need(bool((side[1] <= tau(side[2], D)).all())
                     and bool((side[3] <= tau(side[4], L)).all()),
                     f"K2 clean residual over threshold L={L} {dtype}")
            r = "k2_" + ("tc" if tc_path(q, k, v, kw["bk"]) else "cuda_core") \
                + f"_{str(dtype)[6:]}"
            ratios[r] = max(ratios.get(r, 0.0),
                            (got[1] / tau(got[2], D)).max().item(),
                            (got[3] / tau(got[4], L)).max().item())
            _, chk = flash_attention(q, k, v, causal=causal)
            need(not bool(chk.flag), f"K2 false flag L={L} {dtype}")
            key = f"{str(dtype)[6:]}"
            worst[key] = max(worst.get(key, 0.0), err)
            cases += 1
            if L == 1024:
                again = flash_attention_kernel(q, k, v, **kw)
                need(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"K2 repeat not bit-for-bit {dtype}")
                row, col, delta = 200, 5, 1e4        # q block 1 of 8
                _, chk = flash_attention(
                    q, k, v, causal=True,
                    fault=FaultSpec.value(row, col, delta))
                need(bool(chk.flag), f"K2 missed fault {dtype}")
                fi = (row // 128, 0, row % 128, col, 1, f32_bits(delta))
                gf = flash_attention_kernel(q, k, v, fi, **kw)
                rf = flash_attention_ref(q, k, v, fi, **kw)
                for who, rp in (("kernel", gf[3]), ("plain", rf[3])):
                    at = rp.reshape(B, H, -1).argmax(-1)
                    need(bool((at == row).all()),
                         f"K2 {who} fault not at row {row}")
                rel = ((gf[3][:, :, 1, row % 128] - rf[3][:, :, 1, row % 128])
                       .abs() / rf[3][:, :, 1, row % 128]).max().item()
                need(rel <= 1e-4, f"K2 faulted residual rel {rel}")
    q, k, v = _k2_inputs(gen, dev, B, 300, H, KV, D, torch.bfloat16)
    try:
        flash_attention(q, k, v, causal=False)
    except ValueError:
        pass
    else:
        fail("K2 non-causal padding did not raise")
    need(all(v < 1 for v in ratios.values()),
         f"K2 clean residual at or over its threshold: {ratios}")
    return {"cases": cases, "max_abs_err": worst,
            "bf16_worst_err_over_tolerance": worst_share,
            "worst_clean_residual_over_threshold": ratios, "heads": K2_HEADS}


def k2_timing(dev, heads=K2_HEADS, L: int = FWD_L,
              arch: str = ENGINE_ARCH) -> dict:
    """K2 at the forward phase's shapes (B=2, L=1024, llama heads, bf16;
    ``heads`` = (B, H, KV, D) and ``L`` for another path's),
    one launch: kernel, plain version, ``scaled_dot_product_attention``
    (causal, GQA) and the bound.  Bytes: q, k, v and o once, and the four
    (B, H, L) check vectors; operations at the bf16 tensor-core rate: S
    over every (query, key) pair, since the score check is taken before
    the causal mask (2 B H L^2 D), and PV over the pairs the mask admits
    (2 B H D L(L+1)/2), as p is exactly 0 on the others."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel,
        flash_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, KV, D = heads
    q, k, v = _k2_inputs(gen, dev, B, L, H, KV, D, torch.bfloat16)
    kw = dict(causal=True, **_k2_blocks(L))
    o = flash_attention_kernel(q, k, v, **kw)[0]
    op = flash_attention_ref(q, k, v, **kw)[0]
    err = (o.float() - op.float()).abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib():
        torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    byts = 2 * (2 * B * L * H * D + 2 * B * L * KV * D) + 4 * 4 * B * H * L
    flops = 2.0 * B * H * L * L * D + 2.0 * B * H * D * L * (L + 1) / 2
    t_b, t_f = byts / HBM_BW, flops / PEAK_BF16
    rec = {"arch": arch, "B": B, "L": L, "H": H, "KV": KV, "D": D,
           "ms": timed_graph(lambda: flash_attention_kernel(q, k, v, **kw),
                             iters=10),
           "plain_ms": timed_graph(lambda: flash_attention_ref(q, k, v, **kw),
                                   iters=3),
           "library_ms": timed_graph(lib, iters=10),
           "bound_ms": max(t_b, t_f) * 1e3,
           "bound_by": "bytes" if t_b >= t_f else "operations",
           "bytes": byts, "flops": flops, "max_abs_err": err}
    emit("k2_timing", **rec)
    return rec


# ------------------------------------------------------------------ forward

def forward_runs(dev) -> dict:
    """Full-width llama3.2-1b in bf16 (seed 0): ``Model.forward`` at
    B=2, L=1024 under ``IntensityGuidedPolicy`` on ``NVIDIA_H100_SXM``,
    with the flash kernel (K2) and with the chunked path.  A fault on
    layer 1's ``attn_out`` GEMM is flagged.  The flash run launches K2
    once per layer.

    Tolerance: the two bf16 paths round each layer's attention output
    differently, and 16 layers of bf16 activations amplify that (2.5% of
    max|logits| between the two on an H100).  So both are held against
    the same weights run in f32 (chunked path): the flash path's error
    may exceed the chunked path's own by at most 50%, and the two paths
    differ by at most 2.5 times the chunked path's error."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import LayerCtx, ModelFault
    from repro_torch.models.model import Model

    K1, K2 = abft_matmul.KERNEL, flash_attention.FULL_KERNEL
    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(FWD_B, FWD_L)).astype(np.int64)).to(dev)

    def ctx(flash, fault=None):
        return LayerCtx(abft=ABFTConfig.from_policy(
            IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
            flash_attention=flash), fault=fault)

    def run(flash, fault=None):
        with torch.no_grad():
            return model.forward(params, {"tokens": tokens},
                                 ctx(flash, fault), device=dev)

    run(True)                                     # warm-up
    torch.cuda.synchronize()
    K1.launches = K2.launches = 0                 # counts of THIS run only
    t = time.perf_counter()
    flash = run(True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"abft_matmul": K1.launches, "flash_attention": K2.launches}
    need(launches["flash_attention"] == cfg.n_layers,
         f"forward launched K2 {launches['flash_attention']} times, "
         f"expected {cfg.n_layers}")
    need(launches["abft_matmul"] > 0, "forward launched no K1")
    chunked = run(False)
    torch.cuda.synchronize()
    lf, lc = flash.logits, chunked.logits
    need(lf.shape == (FWD_B, FWD_L, cfg.vocab_size)
         and lf.dtype == torch.float32, f"logits {tuple(lf.shape)}")
    need(bool(torch.isfinite(lf).all()), "non-finite logits")
    need(not bool(flash.flag) and not bool(chunked.flag),
         "clean forward raised a flag")
    params32 = {"embed": params["embed"].float(),
                "final_norm": {"w": params["final_norm"]["w"].float()},
                "layers": [{g: {n: w.float() for n, w in sub.items()}
                            for g, sub in lp.items()}
                           for lp in params["layers"]]}
    with torch.no_grad():
        l32 = model.forward(params32, {"tokens": tokens}, ctx(False),
                            device=dev).logits
    del params32
    scale = lc.abs().max().item()
    err = (lf - lc).abs().max().item()
    err_c = (lc - l32).abs().max().item()
    err_f = (lf - l32).abs().max().item()
    need(err_f <= 1.5 * err_c, f"flash vs f32 err {err_f} > 1.5 x the "
         f"chunked path's {err_c}")
    need(err <= 2.5 * err_c, f"flash vs chunked logits: err {err} > 2.5 x "
         f"{err_c} (chunked vs f32)")
    agree = (lf.argmax(-1) == lc.argmax(-1)).float().mean().item()
    faulted = run(True, ModelFault.at(1, "attn_out",
                                      FaultSpec.value(0, 2, 1e4)))
    need(bool(faulted.flag), "attn_out fault not flagged")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    ms = 1e3 * float(np.median(times))
    rec = dict(B=FWD_B, L=FWD_L, dtype="bfloat16", launches=launches,
               first_ms=1e3 * dt, ms=ms,
               tokens_per_s=FWD_B * FWD_L / (ms / 1e3),
               logits_max_abs_diff_flash_vs_chunked=err,
               logits_max_abs_err_chunked_vs_f32=err_c,
               logits_max_abs_err_flash_vs_f32=err_f,
               logits_scale=scale, argmax_agreement=agree,
               fault_flagged=True)
    emit("forward", **rec)
    del params, flash, chunked, faulted, l32
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------------ train

def train_runs(dev, workdir: str) -> dict:
    """Full-width llama3.2-1b in f32 (seed 0) through ``Trainer``:
    ``SyntheticLM`` batches of 4 x 128 tokens, four AdamW steps at lr
    3e-4 under ``--abft auto`` (every forward GEMM on K1).  The loss is
    finite and falls; a ``mlp_down`` fault raises the step's flag; two
    clean steps from one state give bit-identical params.  K1 launches
    per step count the forward twice (the per-layer recompute).

    One clean step from the trained state is held against the same step
    under ``--abft off`` (plain ``torch.matmul`` on the card), which
    checks K1's forward and the autograd backward at full width.  Both
    are f32 with sums in another order, so: loss within 1e-5 relative;
    ``grad_norm`` within 1e-4 relative (the backward through 16 layers
    carries the forward's rounding); each leaf's update within 1e-3 of
    its norm (AdamW divides by sqrt(v), which magnifies the f32 noise of
    the smallest gradients; a wrong gradient moves a leaf by O(1))."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.launch.train import abft_config
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    K1, K2 = abft_matmul.KERNEL, flash_attention.FULL_KERNEL
    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32, device=dev)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4))
    dcfg = DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                      vocab_size=cfg.vocab_size)
    trainer = Trainer(model, params, tcfg, dcfg,
                      TrainerConfig(steps=TRAIN_STEPS, ckpt_every=10 ** 9,
                                    ckpt_dir=workdir),
                      abft=abft_config("auto"), device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K2.launches = 0                 # counts of THIS run only
    t = time.perf_counter()
    hist = trainer.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"abft_matmul": K1.launches, "flash_attention": K2.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    need(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
         f"train losses {losses}")
    need(losses[-1] < losses[0], f"loss did not fall: {losses}")
    need(launches["abft_matmul"] > 0, "training launched no K1")
    need(not trainer.events, f"clean training raised events "
         f"{trainer.events}")
    step_ms = [1e3 * h["time_s"] for h in hist]

    step = make_train_step(model, abft_config("auto"), tcfg, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in trainer.data.batch(TRAIN_STEPS).items()}
    K1.launches = 0
    _, _, met = step(trainer.params, trainer.opt_state, batch,
                     fault=ModelFault.at(0, "mlp_down",
                                         FaultSpec.value(0, 1, 1e5)))
    need(bool(met["abft_flag"]), "faulted train step not flagged")
    per_step = K1.launches
    del met
    pa, _, ma = step(trainer.params, trainer.opt_state, batch)
    pa = tree_leaves(pa)
    need(not bool(ma["abft_flag"]), "clean train step flagged")
    pb, _, _ = step(trainer.params, trainer.opt_state, batch)
    same = all(torch.equal(a, b) for a, b in zip(pa, tree_leaves(pb)))
    need(same, "two clean steps from one state differ")
    del pb
    po, _, mo = make_train_step(model, abft_config("off"), tcfg,
                                device=dev)(trainer.params, trainer.opt_state,
                                            batch)
    vs_off = {"loss_rel": abs(ma["loss"].item() - mo["loss"].item())
              / abs(mo["loss"].item()),
              "grad_norm_rel": abs(ma["grad_norm"].item()
                                   - mo["grad_norm"].item())
              / mo["grad_norm"].item(),
              "update_rel_worst_leaf": 0.0,
              "update_max_abs_rel_worst_leaf": 0.0}
    for p0, a, o in zip(tree_leaves(trainer.params), pa, tree_leaves(po)):
        da, do = a - p0, o - p0
        vs_off["update_rel_worst_leaf"] = max(
            vs_off["update_rel_worst_leaf"],
            ((da - do).norm() / do.norm().clamp_min(1e-30)).item())
        vs_off["update_max_abs_rel_worst_leaf"] = max(
            vs_off["update_max_abs_rel_worst_leaf"],
            ((da - do).abs().max() / do.abs().max().clamp_min(1e-30))
            .item())
    del po, pa
    need(vs_off["loss_rel"] <= 1e-5 and vs_off["grad_norm_rel"] <= 1e-4
         and vs_off["update_rel_worst_leaf"] <= 1e-3,
         f"train step on K1 differs from the plain step: {vs_off}")
    rec = dict(B=TRAIN_B, L=TRAIN_L, steps=TRAIN_STEPS, losses=losses,
               step_ms=step_ms, step_ms_median=float(np.median(step_ms[1:])),
               seconds=dt,
               tokens_per_s=TRAIN_B * TRAIN_L * TRAIN_STEPS / dt,
               peak_memory_gb=peak / 1e9, launches=launches,
               k1_launches_per_step=per_step,
               forward_gemms=7 * cfg.n_layers + 1,
               faulted_step_flagged=True, clean_steps_bit_identical=True,
               step_vs_abft_off=vs_off)
    emit("train", **rec)
    out = {"rec": rec, "params": trainer.params}
    del trainer
    return out


# ------------------------------------------------------------------ engine

def engine_inputs(dev, arch: str = ENGINE_ARCH, cfg=None) -> tuple:
    """Full-width weights of ``arch`` (bf16, seed 0), or of ``cfg`` where
    given, made on the card, and the 8 prompts of 16-256 tokens every
    engine run serves."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = cfg or get_config(arch)
    params = Model(cfg).init_params(0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    return params, prompts


def engine_serve(model, params, prompts, dev, cache_kind, policy, *,
                 fault_at=None, label="", phase="engine",
                 max_new_tokens=16):
    """One bf16 engine run (4 slots, max_len 512, flash on) of ``prompts``
    under ``policy`` on ``NVIDIA_H100_SXM``, every admission and decode
    step timed to a synchronize; K1 (its expert-batched launches apart,
    also per decode step) and K3 counted from 0 for this run.  Emits the
    run's line under ``phase``; returns (streams, record, engine)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import Request, ServeEngine

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    K1B = abft_matmul.BATCHED
    abft = ABFTConfig.from_policy(policy, hardware=NVIDIA_H100_SXM,
                                  flash_attention=True)
    eng = ServeEngine(model, params, slots=4, max_len=512, abft=abft,
                      dtype=torch.bfloat16, device=dev,
                      cache_kind=cache_kind)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]
    t_pre, t_dec, step_batched = [], [], []
    admit, step = eng.admit, eng.step

    def timed_admit(*a, **k):
        t = time.perf_counter()
        r = admit(*a, **k)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t)
        return r

    def timed_step(*a, **k):
        b0 = K1B.launches
        t = time.perf_counter()
        r = step(*a, **k)
        torch.cuda.synchronize()
        if r:
            t_dec.append(time.perf_counter() - t)
            step_batched.append(K1B.launches - b0)
        return r

    eng.admit, eng.step = timed_admit, timed_step
    torch.cuda.synchronize()
    K1.launches = K3.launches = K1B.launches = 0   # THIS run's counts
    t0 = time.perf_counter()
    results = eng.run(reqs, fault_at=fault_at)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del eng.admit, eng.step         # the timers close a cycle through eng
    launches = {"abft_matmul": K1.launches, "flash_decode": K3.launches,
                "abft_matmul_batched": K1B.launches}
    errors = {r.uid: r.error for r in reqs if r.error}
    need(not errors, f"{phase} {label}: errors {errors}")
    need(all(len(results[i]) == max_new_tokens for i in range(len(reqs))),
         f"{phase} {label}: incomplete streams")
    need(all(0 <= t < model.cfg.vocab_size for s in results.values()
             for t in s), f"{phase} {label}: token out of range")
    st = eng.stats
    rec = dict(label=label, cache=cache_kind, tokens=st.tokens,
               seconds=dt, tokens_per_s=st.tokens / dt,
               prefill_ms=[1e3 * t for t in t_pre],
               decode_step_ms_median=1e3 * float(np.median(t_dec)),
               decode_steps=len(t_dec), launches=launches,
               batched_launches_per_step={
                   str(v): step_batched.count(v)
                   for v in sorted(set(step_batched))},
               faults_detected=st.faults_detected, retries=st.retries,
               hard_faults=st.hard_faults,
               selection_trace=[f'{e["decode"]}+{e["prefill"]}:'
                                f'{e["scheme"]}'
                                for e in st.selection_trace])
    emit(phase, **rec)
    return results, rec, eng


def engine_runs(dev) -> dict:
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.schemes import Scheme
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    params, prompts = engine_inputs(dev)

    def serve(cache_kind, policy, fault_at=None, label=""):
        return engine_serve(model, params, prompts, dev, cache_kind, policy,
                            fault_at=fault_at, label=label)

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
            "prompts": prompts, "streams": dense}


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


# ------------------------------------------------------------------ campaign

CAMPAIGN_RATE = 0.25        # transient faults per engine step
CAMPAIGN_MAG = 1e4          # value faults: far above every threshold


def _serve_run(model, params, prompts, dev, label, *, policy=None,
               abft_on=True, fault_model=None, telemetry=None, retries=1,
               fault_at=None, level_plan=None, classify=None, **engine_kw):
    """One full-width engine run (bf16, 4 slots, max_len 512, flash on,
    16 new tokens a request) with per-call bookkeeping: wall time, decode
    step times, the shadow runs' time, and per admit/step the protection
    level and K1's launches.  ``level_plan`` forces the protection level
    a step runs at (a fault-free twin of an adaptive run)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import (
        RecoveryPolicy,
        Request,
        ServeEngine,
    )

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    abft = ABFTConfig.from_policy(policy or IntensityGuidedPolicy(),
                                  hardware=NVIDIA_H100_SXM,
                                  flash_attention=True, enabled=abft_on)
    eng = ServeEngine(model, params, slots=4, max_len=512, abft=abft,
                      dtype=torch.bfloat16, device=dev,
                      fault_model=fault_model, telemetry=telemetry,
                      classify_injections=classify,
                      policy=RecoveryPolicy(max_retries=retries),
                      **engine_kw)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    shadow, t_dec, calls = [], [], []
    shadow_fn, admit, step = eng._shadow_outcome, eng.admit, eng.step

    def timed_shadow(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = shadow_fn(*a)
        torch.cuda.synchronize()
        shadow.append(time.perf_counter() - t)
        return r

    def traced_admit(*a, **k):
        before = K1.launches
        r = admit(*a, **k)
        calls.append(("admit", eng.protection_level, K1.launches - before,
                      any(q.error is None for q in r)))
        return r

    def traced_step(*a, **k):
        i = len([c for c in calls if c[0] == "step"])
        if level_plan is not None and i < len(level_plan) \
                and level_plan[i] != eng.protection_level:
            eng._set_protection_level(level_plan[i], {})
        before = K1.launches
        t = time.perf_counter()
        r = step(*a, **k)
        torch.cuda.synchronize()
        if r:
            t_dec.append(time.perf_counter() - t)
        calls.append(("step", eng.protection_level, K1.launches - before,
                      bool(r)))
        return r

    eng._shadow_outcome = timed_shadow
    eng.admit, eng.step = traced_admit, traced_step
    torch.cuda.synchronize()
    K1.launches = K3.launches = 0            # counts of THIS run only
    t0 = time.perf_counter()
    results = eng.run(reqs, fault_at=fault_at)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = eng.stats
    rec = dict(label=label, seconds=dt, tokens=st.tokens,
               tokens_per_s=st.tokens / dt,
               decode_step_ms_median=(1e3 * float(np.median(t_dec))
                                      if t_dec else None),
               launches={"abft_matmul": K1.launches,
                         "flash_decode": K3.launches},
               faults_injected=st.faults_injected,
               faults_corrected=st.faults_corrected,
               faults_uncorrected=st.faults_uncorrected,
               sdc_faults=st.sdc_faults, masked_faults=st.masked_faults,
               faults_detected=st.faults_detected, retries=st.retries,
               hard_faults=st.hard_faults, evictions=st.evictions,
               shadow_runs=len(shadow), shadow_ms=1e3 * sum(shadow),
               escalations=st.protection_escalations,
               deescalations=st.protection_deescalations)
    need(all(0 <= t < model.cfg.vocab_size for s in results.values()
             for t in s), f"campaign {label}: token out of range")
    return {"results": results, "rec": rec, "eng": eng, "reqs": reqs,
            "calls": calls,
            "levels": [c[1] for c in calls if c[0] == "step"]}


def _accounted(rec) -> bool:
    return rec["faults_injected"] == (
        rec["faults_corrected"] + rec["faults_uncorrected"]
        + rec["sdc_faults"] + rec["masked_faults"])


def campaign_runs(dev, params, prompts, ref_streams=None) -> dict:
    """The reference's campaign protocol (``benchmarks/fault_campaign.py``)
    at full width on the card, every item a gate: clean, a protected
    transient campaign, its replay, a disabled fault model, an ``abft
    off`` campaign (the shadow stream must see SDCs), a sticky fault
    becoming a hard fault, adaptive escalation (K1 silent while
    escalated) and de-escalation, sampling, and the cost of tracing."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultModel, FaultSpec
    from repro_torch.core.policy import (
        ErrorAdaptivePolicy,
        FixedPolicy,
        IntensityGuidedPolicy,
    )
    from repro_torch.core.schemes import Scheme
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.obs import EngineTelemetry
    from repro_torch.serve.engine import Request

    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)

    def run(label, **kw):
        out = _serve_run(model, params, prompts, dev, label, **kw)
        emit("campaign", **out["rec"])
        return out

    def fm(rate=CAMPAIGN_RATE, **kw):
        base = dict(transient_rate=rate, seed=0, layers=cfg.n_layers,
                    dtype=torch.float32, magnitude=CAMPAIGN_MAG)
        base.update(kw)
        return FaultModel(**base)

    summary = {}
    run("warmup")
    clean = run("clean")
    clean_streams = clean["results"]
    if ref_streams is not None:
        need(clean_streams == ref_streams,
             "campaign clean run differs from the engine phase's streams")
    # protected transient campaign + replay + disabled
    f1 = fm()
    prot = run("protected", fault_model=f1)
    pr = prot["rec"]
    need(pr["launches"]["abft_matmul"] > 0
         and pr["launches"]["flash_decode"] > 0,
         "protected campaign did not launch K1 and K3")
    need(pr["faults_injected"] > 0 and pr["sdc_faults"] == 0,
         f"protected campaign: {pr}")
    need(_accounted(pr), "protected campaign: outcomes do not add up")
    need(prot["results"] == clean_streams,
         "protected campaign streams differ from the clean run")
    f2 = fm()
    rep = run("replay", fault_model=f2)
    need(f1.schedule == f2.schedule
         and prot["eng"].stats.injection_log
         == rep["eng"].stats.injection_log
         and rep["results"] == prot["results"], "replay is not identical")
    off0 = run("disabled", fault_model=fm(rate=0.0))
    need(off0["results"] == clean_streams
         and off0["rec"]["faults_injected"] == 0,
         "a rate-0 fault model changed the streams")
    eff = pr["faults_injected"] - pr["masked_faults"]
    det = pr["faults_corrected"] + pr["faults_uncorrected"]
    summary["protected"] = dict(
        coverage=det / eff if eff else 1.0,
        sdc_rate=pr["sdc_faults"] / pr["faults_injected"],
        overhead=pr["seconds"] / clean["rec"]["seconds"],
        faults_injected=pr["faults_injected"],
        schedule_len=len(f1.schedule))
    # unprotected campaign: the shadow stream must see the corruption
    off = run("abft_off", abft_on=False, fault_model=fm())
    orc = off["rec"]
    need(orc["sdc_faults"] > 0 and _accounted(orc),
         f"abft off campaign saw no SDC: {orc}")
    summary["abft_off"] = dict(
        sdc_rate=orc["sdc_faults"] / orc["faults_injected"],
        faults_injected=orc["faults_injected"],
        shadow_runs=orc["shadow_runs"], shadow_ms=orc["shadow_ms"],
        shadow_ms_per_run=orc["shadow_ms"] / max(orc["shadow_runs"], 1),
        overhead=orc["seconds"] / clean["rec"]["seconds"])
    # sticky permanent fault under block_1s, one retry: a hard fault
    perm = run("permanent", policy=FixedPolicy(Scheme.BLOCK_1S),
               fault_model=fm(rate=0.0, permanent_rate=0.2,
                              permanent_duration=4, sites=("mlp_down",)))
    prc = perm["rec"]
    errs = {r.error for r in perm["reqs"] if r.error}
    need(prc["hard_faults"] >= 1 and prc["faults_uncorrected"] >= 1
         and prc["evictions"] >= 1 and errs == {"hard_fault:decode"},
         f"sticky fault did not become a hard fault: {prc} {errs}")
    need(all(len(perm["results"][r.uid]) == 16 for r in perm["reqs"]
             if not r.error), "a surviving request is incomplete")
    eng = perm["eng"]
    eng.fault_model = None
    alive = eng.run([Request(uid=100 + i, prompt=p, max_new_tokens=16)
                     for i, p in enumerate(prompts[:4])])
    need(all(len(s) == 16 for s in alive.values()),
         "engine did not serve on after the hard fault")
    summary["permanent"] = dict(hard_faults=prc["hard_faults"],
                                evictions=prc["evictions"])
    # adaptive: escalation under the elevated rate, K1 silent while there
    ada_tel = EngineTelemetry(trace=True)
    adaptive = ErrorAdaptivePolicy(IntensityGuidedPolicy(),
                                   deescalate_after=4)
    ada = run("adaptive", policy=adaptive, fault_model=fm(),
              telemetry=ada_tel)
    arc = ada["rec"]
    need(arc["escalations"] >= 1, "adaptive campaign never escalated")
    need(all(n == 0 for _, lvl, n, _ in ada["calls"] if lvl == 1),
         "K1 launched while escalated")
    need(ada_tel.counters_match(ada["eng"].stats), "counters drifted")
    need(arc["sdc_faults"] == 0 and arc["hard_faults"] == 0
         and _accounted(arc), f"adaptive campaign: {arc}")
    twin = run("adaptive_twin", policy=ErrorAdaptivePolicy(
        IntensityGuidedPolicy(), deescalate_after=10 ** 9),
        level_plan=ada["levels"])
    need(twin["results"] == ada["results"],
         "adaptive streams differ from a fault-free run at the same levels")
    instants = [{k: e["args"][k] for k in ("level", "direction")
                 if k in e["args"]} | {"ts_ms": e["ts"] / 1e3}
                for e in ada_tel.tracer.events
                if e["name"] == "protection_escalation"]
    # de-escalation: one fault escalates, four quiet steps return
    one = ModelFault.at(1, "mlp_up", FaultSpec.value(0, 5, CAMPAIGN_MAG))
    res = run("adaptive_resume", policy=ErrorAdaptivePolicy(
        IntensityGuidedPolicy(), deescalate_after=4), fault_at=(2, one))
    rrc = res["rec"]
    lv = res["levels"]
    back = [i for i in range(1, len(lv)) if lv[i - 1] == 1 and lv[i] == 0]
    need(rrc["escalations"] == 1 and rrc["deescalations"] == 1 and back,
         f"adaptive engine did not return to level 0: {lv}")
    steps_after = [c for c in res["calls"] if c[0] == "step"][back[0]:]
    need(all(n > 0 for _, lvl, n, ran in steps_after if lvl == 0 and ran),
         "K1 did not resume after de-escalation")
    twin2 = run("adaptive_resume_twin", policy=ErrorAdaptivePolicy(
        IntensityGuidedPolicy(), deescalate_after=10 ** 9), level_plan=lv)
    need(twin2["results"] == res["results"],
         "resumed adaptive streams differ from the fault-free twin")
    quiet = run("adaptive_quiet", policy=ErrorAdaptivePolicy(
        IntensityGuidedPolicy(), deescalate_after=4),
        fault_model=fm(rate=0.0))
    need(quiet["results"] == clean_streams
         and quiet["eng"].stats.selection_trace
         == clean["eng"].stats.selection_trace
         and quiet["rec"]["escalations"] == 0,
         "quiet adaptive engine differs from the base policy")
    summary["adaptive"] = dict(
        escalations=arc["escalations"], deescalations=arc["deescalations"],
        levels=ada["levels"], escalation_instants=instants,
        k1_launches_by_level={lvl: sum(n for _, l2, n, _ in ada["calls"]
                                       if l2 == lvl) for lvl in (0, 1)},
        resume_levels=lv)
    # sampling: seeded replay, and a corrected campaign under sampling
    samp = dict(temperature=0.8, top_k=50, seed=0)
    s1 = run("sampled", **samp)
    s2 = run("sampled_again", **samp)
    sf = run("sampled_campaign", fault_model=fm(), **samp)
    need(s1["results"] == s2["results"], "sampled runs do not replay")
    need(sf["results"] == s1["results"] and sf["rec"]["sdc_faults"] == 0
         and sf["rec"]["faults_injected"] > 0,
         "faulted sampled run differs from the clean sampled run")
    summary["sampling"] = dict(
        agree_with_greedy=float(np.mean([
            a == b for k in clean_streams
            for a, b in zip(clean_streams[k], s1["results"][k])])),
        retries=sf["rec"]["retries"])
    # the cost of --trace-out: clean and traced runs in turns (the host's
    # spread between identical runs is large; medians of four each)
    pairs = [(run(f"untraced_{i}"),
              run(f"traced_{i}", telemetry=EngineTelemetry(trace=True)))
             for i in range(4)]
    for _, t in pairs:
        need(t["results"] == clean_streams, "tracing changed the streams")

    def med(runs, key):
        return float(np.median([r["rec"][key] for r in runs]))

    plain, traced = [p[0] for p in pairs], [p[1] for p in pairs]
    summary["trace_overhead"] = dict(
        untraced_tokens_per_s=[r["rec"]["tokens_per_s"] for r in plain],
        traced_tokens_per_s=[r["rec"]["tokens_per_s"] for r in traced],
        untraced_decode_step_ms=[r["rec"]["decode_step_ms_median"]
                                 for r in plain],
        traced_decode_step_ms=[r["rec"]["decode_step_ms_median"]
                               for r in traced],
        tokens_per_s_ratio=med(traced, "tokens_per_s")
        / med(plain, "tokens_per_s"),
        decode_step_ms_ratio=med(traced, "decode_step_ms_median")
        / med(plain, "decode_step_ms_median"),
        events=len(traced[0]["eng"].telemetry.tracer.events))
    emit("campaign_summary", **summary)
    return {"clean": clean, "summary": summary}


# ------------------------------------------------------------------ profile

def _eager_call_ms(d, dev) -> dict:
    """What the eager engine pays a call of each scheme at shape ``d``:
    mean ms over back-to-back calls (host launch cost and device time,
    whichever paces; warm L2), beside the profiler's device time."""
    from repro_torch.core.policy import FixedPolicy
    from repro_torch.core.protected import ABFTConfig, protected_matmul

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(d.m, d.k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(d.k, d.n, generator=gen, device=dev).to(torch.bfloat16)
    od = torch.float32 if d.out_dtype_bytes == 4 else torch.bfloat16
    out = {}
    for sc in ("block_1s", "global"):
        cfg = ABFTConfig.from_policy(FixedPolicy(sc))
        out[f"{sc}_eager_ms"] = timed(
            lambda: protected_matmul(x, w, cfg, out_dtype=od), iters=20)
    return out


def profile_runs(dev, params, prompts, clean_streams=None) -> dict:
    """``build_profile_table`` on the card: ``block_1s`` (K1) against
    ``global`` (cuBLAS + the checksum reductions) at the plan's GEMM dims
    for a decode step (M = 4) and a 512-token admission, and at every
    shape the engine run reaches (recorded from ``protected_matmul``).
    Then two engine runs under the
    resulting ``ProfileGuidedPolicy``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import (
        IntensityGuidedPolicy,
        ProfileGuidedPolicy,
        ProtectionPlan,
    )
    from repro_torch.core.profiler import build_profile_table
    from repro_torch.models.model import Model

    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)

    import repro_torch.core.protected as protected

    seen: set = set()
    gemm_dims = protected._gemm_dims

    def recording(x, w, out_dtype):
        d = gemm_dims(x, w, out_dtype)
        seen.add(d)
        return d

    protected._gemm_dims = recording      # every GEMM the run executes
    try:
        seen_run = _serve_run(model, params, prompts, dev,
                              "profile_shapes")
    finally:
        protected._gemm_dims = gemm_dims
    if clean_streams is None:
        clean_streams = seen_run["results"]
    dims = []
    for m in (4, 512):
        plan = ProtectionPlan.for_model(cfg, hw=NVIDIA_H100_SXM,
                                        n_tokens=m, phase="serve")
        for e in plan.entries:
            d = e.layer.dims
            if e.layer.name == "lm_head":     # the head's output is f32
                d = dataclasses.replace(d, out_dtype_bytes=4)
            dims.append(d)
    dims += sorted(seen, key=dataclasses.astuple)
    dims = list(dict.fromkeys(dims))
    times: dict = {}
    t = time.perf_counter()
    table = build_profile_table(dims, times=times, dtype=torch.bfloat16,
                                device=dev, iters=7)
    wall = time.perf_counter() - t
    analytic = IntensityGuidedPolicy()
    rows = []
    for d in dims:
        ms = {str(getattr(s, "value", s)): 1e3 * v
              for s, v in times[d].items()}
        rows.append({"m": d.m, "k": d.k, "n": d.n,
                     "out_bytes": d.out_dtype_bytes,
                     "block_1s_ms": ms["block_1s"], "global_ms": ms["global"],
                     "winner": table[d].value,
                     "intensity_guided": analytic.select(
                         d, NVIDIA_H100_SXM).scheme_name,
                     "in_run": d in seen,
                     **_eager_call_ms(d, dev)})
    emit("profile_table", shapes=rows, seconds=wall,
         global_wins=sum(r["winner"] == "global" for r in rows))
    pol = ProfileGuidedPolicy(table=table, fallback=analytic)
    runs = [_serve_run(model, params, prompts, dev, label, policy=pol)
            for label in ("profile_guided", "profile_guided_again")]
    a, b = runs
    need(not any(r.error for r in a["reqs"]), "profile-guided run errors")
    need(a["rec"]["faults_detected"] == 0, "profile-guided false flag")
    need(a["results"] == b["results"], "profile-guided run does not replay")
    ran = {d: table[d].value for d in seen}
    k1 = a["rec"]["launches"]["abft_matmul"]
    need((k1 > 0) == ("block_1s" in ran.values()),
         f"K1 launches {k1} do not follow the table {set(ran.values())}")
    if set(ran.values()) == {"block_1s"}:
        need(a["results"] == clean_streams,
             "profile-guided streams differ from the clean run")
    agree = float(np.mean([x == y for k in clean_streams
                           for x, y in zip(clean_streams[k],
                                           a["results"][k])]))
    eng = a["eng"]
    plan_rows = [{"name": e["name"], **{k: e["dims"][k] for k in "mkn"},
                  "scheme": e["scheme"], "reason": e["reason"]}
                 for e in json.loads(eng.plan.to_json())["layers"]]
    out = dict(a["rec"], plan_rows=plan_rows,
               run_shapes={f'{d.m}x{d.k}x{d.n}/{d.out_dtype_bytes}': s
                           for d, s in ran.items()},
               streams_equal_clean=a["results"] == clean_streams,
               token_agreement_with_clean=agree,
               tokens_per_s_again=b["rec"]["tokens_per_s"],
               decode_step_ms_median_again=b["rec"][
                   "decode_step_ms_median"])
    emit("profile_guided", **out)
    return out


# ------------------------------------------------------------------ family

def free_memory() -> None:
    """Collect what reference cycles keep alive (an engine, and through it
    its weights and cache), then hand the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def family_plan(cfg) -> dict:
    """The plan ``IntensityGuidedPolicy`` compiles for ``cfg`` on the
    H100 at a decode step (M = 4), a prefill admission (M = 512) and the
    score's rows (M = 1024): (site, m, k, n, intensity, scheme) a row."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy, ProtectionPlan

    out = {}
    for name, n in (("decode", 4), ("prefill", 512), ("score", 1024)):
        plan = ProtectionPlan.for_model(cfg, hw=NVIDIA_H100_SXM,
                                        policy=IntensityGuidedPolicy(),
                                        phase=name, n_tokens=n)
        out[name] = [(r["layer"], r["m"], r["k"], r["n"], r["ai"],
                      r["scheme"]) for r in plan.report_rows()]
    return out


def _gemm_sites(params) -> dict:
    """The 2-D GEMM sites of layer 0 and the head: name -> (weight, output
    dtype).  A dense FFN gives ``up`` and ``down``; an MoE FFN gives the
    router (N = E, f32 out) and the shared experts' ``shared_up`` and
    ``shared_down`` (its expert GEMMs are ``moe_k1_checks``')."""
    lp = params["layers"][0]
    bf, f32 = params["embed"].dtype, torch.float32
    sites = {"q": (lp["mixer"]["wq"], bf), "kv": (lp["mixer"]["wk"], bf),
             "o": (lp["mixer"]["wo"], bf)}
    ffn = lp["ffn"]
    if "router" in ffn:
        sites["router"] = (ffn["router"], f32)
        if "shared" in ffn:
            sites["shared_up"] = (ffn["shared"]["up"], bf)
            sites["shared_down"] = (ffn["shared"]["down"], bf)
    else:
        sites["up"], sites["down"] = (ffn["up"], bf), (ffn["down"], bf)
    sites["head"] = (params["lm_head"] if "lm_head" in params
                     else params["embed"].t(), f32)
    return sites


def family_checks(dev, cfg, params) -> dict:
    """K1 and K2 against their plain versions at ``cfg``'s shapes, before
    its main path runs.  K1: each 2-D GEMM site's real weights
    (``_gemm_sites``; K up to 27392, N from 60 to 152064) at M = 4 (a
    decode step) and 1024 (the score's rows), and with ``one_slice`` (the
    serving prefill's plan) at M = 256 (a chunk) and 1024 (an admission),
    mode 1s on the route the path takes, and a value fault and a bit flip
    in the FFN's down projection (``down``, or ``shared_down``) flagged
    at their block and row.  K2: causal
    bf16 at B = 1, L = 1024 with ``cfg``'s heads (D = 64 or 128, G = 1 or
    5).  K3 is held against its plain version layer by layer in
    ``k3_timing`` on the engine's own cache.

    Tolerances as ``k1_checks`` and ``k2_checks``: y within 2^-7 x max|y|
    in bf16 (one rounding of either side; 1e-4 in f32, the head's and the
    router's output) at the deepest K; bounds within 1e-4 relative; clean
    residuals under the threshold on both sides."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.core.faults import FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, route
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel,
        flash_attention_ref,
        tc_path,
    )
    from repro_torch.kernels.ref import abft_matmul_ref

    gemms = _gemm_sites(params)
    gen = torch.Generator(device=dev).manual_seed(11)
    ratios, worst, worst_abs, routes_taken = {}, 0.0, 0.0, {}
    one_abs = 0.0
    for m, one in ((4, False), (1024, False), (256, True), (1024, True)):
        for name, (w, out_dtype) in gemms.items():
            k, n = w.shape
            x = torch.randn(m, k, generator=gen, device=dev).to(w.dtype)
            bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                          ((256, m), (512, k), (256, n)))
            kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
            tag = f"{name}_m{m}" + ("_one_slice" if one else "")
            y, _, bnd = abft_matmul_kernel(x, w, **kw, one_slice=one)
            yp, _, bndp = abft_matmul_ref(x, w, **kw)
            scale = yp.float().abs().max().item()
            tol = (1e-4 if out_dtype == torch.float32 else 2 ** -7) * scale
            err = (y.float() - yp.float()).abs().max().item()
            need(err <= tol, f"K1 {cfg.name} {tag}: err {err} > {tol}")
            berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max()
            need(berr.item() <= 1e-4, f"K1 {cfg.name} bnd {tag}: "
                 f"{berr.item()}")
            del y, yp, bnd, bndp
            _, chk = ops.abft_matmul(x, w, mode="1s", out_dtype=out_dtype,
                                     one_slice=one)
            need(not bool(chk.flag), f"K1 false flag {cfg.name} {tag} "
                 f"(K={k})")
            ratios[tag] = _ratio(chk)
            routes_taken[tag] = route(x, w, bn, "1s")
            worst = max(worst, err / max(scale, 1e-30))
            if one:
                one_abs = max(one_abs, err)
            else:
                worst_abs = max(worst_abs, err)
            if name in ("down", "shared_down"):
                _k1_fault_check(ops, FaultSpec, x, w, "1s", out_dtype,
                                f"{cfg.name} {name}", one_slice=one)
    need(all(v < 1 for v in ratios.values()),
         f"K1 clean residual at or over its threshold: {ratios}")
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _k2_inputs(gen, dev, 1, 1024, H, KV, D, torch.bfloat16)
    kw = dict(causal=True, **_k2_blocks(1024))
    got = flash_attention_kernel(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    o_ref = ref[0].float()
    share = ((got[0].float() - o_ref).abs()
             / (2 ** -7 * o_ref.abs() + 1e-5 * o_ref.abs().max())).max()
    need(share.item() <= 1, f"K2 {cfg.name}: an element off by "
         f"{share.item()} x its tolerance")
    for gi, ri, nm in ((got[2], ref[2], "bnd_s"), (got[4], ref[4], "bnd_pv")):
        rel = ((gi - ri).abs() / ri.abs().clamp_min(1e-30)).max().item()
        need(rel <= 1e-4, f"K2 {cfg.name} {nm}: rel {rel}")
    k2_ratio = max(
        (got[1] / (ATOL + tolerance_scale(D) * got[2])).max().item(),
        (got[3] / (ATOL + tolerance_scale(1024) * got[4])).max().item())
    need(k2_ratio < 1, f"K2 {cfg.name} clean residual over threshold")
    return {"k1_max_rel_err_y": worst, "k1_max_abs_err": worst_abs,
            "k1_one_slice_max_abs_err": one_abs,
            "k1_routes": routes_taken,
            "k1_worst_clean_residual_over_threshold": max(ratios.values()),
            "k2_tc": tc_path(q, k, v, kw["bk"]),
            "k2_bf16_worst_err_over_tolerance": share.item(),
            "k2_max_abs_err": (got[0].float() - o_ref).abs().max().item(),
            "k2_worst_clean_residual_over_threshold": k2_ratio}


def _forward_f32_layerwise(model, params, tokens):
    """Final hidden states of ``params`` run in f32, cast one layer at a
    time (the whole model in f32 does not fit beside its bf16 weights at
    14B and 32B): plain matmuls (ABFT off, TF32 off) and chunked
    attention, through the model's own ``apply_layer``."""
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx, norm

    cfg = model.cfg
    ctx = LayerCtx(abft=ABFTConfig(enabled=False))
    B, L = tokens.shape
    x = params["embed"][tokens].float()
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = model.apply_layer(x, tree_map(lambda t: t.float(), lp),
                                    ctx.with_layer(i), positions, "full",
                                    None)
    return norm(x, tree_map(lambda t: t.float(), params["final_norm"]),
                cfg.norm, cfg.norm_eps)


def family_score(dev, model, params) -> dict:
    """``Model.forward`` at B = 1 x L = 1024 under ``IntensityGuidedPolicy``
    on K2 and on the chunked path, held against each other with the
    ``forward`` phase's tolerance: both against the same weights run in
    f32 (layer by layer; the head in column chunks), the flash path's
    error at most 1.5 x the chunked path's own, and the two paths apart
    by at most 2.5 x the chunked path's error.  Neither raises a flag;
    K2 launches once a layer."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import LayerCtx

    K1, K2 = abft_matmul.KERNEL, flash_attention.FULL_KERNEL
    cfg = model.cfg
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(SCORE_B, SCORE_L)).astype(np.int64)).to(dev)

    def run(flash):
        ctx = LayerCtx(abft=ABFTConfig.from_policy(
            IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
            flash_attention=flash))
        torch.cuda.synchronize()
        K1.launches = K2.launches = 0             # counts of THIS run only
        t = time.perf_counter()
        with torch.no_grad():
            out = model.forward(params, {"tokens": tokens}, ctx, device=dev)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t), {
            "abft_matmul": K1.launches, "flash_attention": K2.launches}

    flash, ms_flash, launches = run(True)
    chunked, ms_chunked, _ = run(False)
    lf, lc = flash.logits, chunked.logits
    need(lf.shape == (SCORE_B, SCORE_L, cfg.vocab_size)
         and lf.dtype == torch.float32, f"logits {tuple(lf.shape)}")
    need(bool(torch.isfinite(lf).all()) and bool(torch.isfinite(lc).all()),
         "non-finite logits")
    need(not bool(flash.flag) and not bool(chunked.flag),
         f"{cfg.name}: clean forward raised a flag")
    need(launches["flash_attention"] == cfg.n_layers,
         f"{cfg.name}: forward launched K2 {launches['flash_attention']} "
         f"times, expected {cfg.n_layers}")
    need(launches["abft_matmul"] > 0, f"{cfg.name}: forward launched no K1")
    with torch.no_grad():
        h32 = _forward_f32_layerwise(model, params, tokens)
        head = params["lm_head"] if "lm_head" in params \
            else params["embed"].t()
        err = err_c = err_f = 0.0
        for c0 in range(0, cfg.vocab_size, 16384):
            c1 = min(c0 + 16384, cfg.vocab_size)
            l32 = h32 @ head[:, c0:c1].float()
            err = max(err, (lf[..., c0:c1] - lc[..., c0:c1]).abs().max()
                      .item())
            err_c = max(err_c, (lc[..., c0:c1] - l32).abs().max().item())
            err_f = max(err_f, (lf[..., c0:c1] - l32).abs().max().item())
        del h32, l32
    need(err_f <= 1.5 * err_c, f"{cfg.name}: flash vs f32 err {err_f} > "
         f"1.5 x the chunked path's {err_c}")
    need(err <= 2.5 * err_c, f"{cfg.name}: flash vs chunked logits: err "
         f"{err} > 2.5 x {err_c} (chunked vs f32)")
    agree = (lf.argmax(-1) == lc.argmax(-1)).float().mean().item()
    rec = dict(B=SCORE_B, L=SCORE_L, launches=launches, ms=ms_flash,
               chunked_ms=ms_chunked,
               tokens_per_s=SCORE_B * SCORE_L / (ms_flash / 1e3),
               logits_max_abs_diff_flash_vs_chunked=err,
               logits_max_abs_err_chunked_vs_f32=err_c,
               logits_max_abs_err_flash_vs_f32=err_f,
               logits_scale=lc.abs().max().item(), argmax_agreement=agree)
    del flash, chunked, lf, lc
    return rec


def family_arch(dev, arch: str) -> dict:
    """One dense-family config at full width (published dims, every
    layer; bf16 weights from seed 0, made on the card): the plan, the
    kernel checks at its shapes, serving (dense and paged streams equal,
    a clean run raises no flag, an ``mlp_down`` fault is recomputed to
    the clean streams), scoring, and the kernels' times at its shapes.
    Frees its weights before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    model = Model(cfg)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, prompts = engine_inputs(dev, arch)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    emit("family_plan", arch=arch, init_s=time.perf_counter() - t0,
         weights_gb=weights / 1e9, **family_plan(cfg))
    checks = family_checks(dev, cfg, params)
    emit("family_check", arch=arch, **checks)

    def serve(cache_kind, fault_at=None, label="", reqs=None, new=16):
        return engine_serve(model, params, prompts if reqs is None else reqs,
                            dev, cache_kind, IntensityGuidedPolicy(),
                            fault_at=fault_at, label=f"{arch} {label}",
                            phase="family_engine", max_new_tokens=new)

    serve("dense", label="warmup", reqs=prompts[:1], new=2)
    free_memory()
    dense, rec_dense, eng = serve("dense", label="dense")
    t3 = k3_timing(dev, eng, prompts, long_context=False)
    del eng
    free_memory()
    paged, rec_paged, _ = serve("paged", label="paged")
    free_memory()
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    faulted, rec_fault, _ = serve("dense", fault_at=(3, fault),
                                  label="dense_fault")
    free_memory()
    for rec in (rec_dense, rec_paged):
        need(rec["launches"]["abft_matmul"] > 0
             and rec["launches"]["flash_decode"] > 0,
             f"{arch} {rec['label']}: K1 or K3 never launched")
        need(rec["faults_detected"] == 0, f"{arch} {rec['label']}: a clean "
             f"run raised a flag")
    need(paged == dense, f"{arch}: paged streams differ from dense")
    need(rec_fault["faults_detected"] >= 1 and rec_fault["retries"] >= 1,
         f"{arch}: injected fault not detected and retried")
    need(faulted == dense, f"{arch}: faulted run's streams differ from the "
         f"clean run")
    score = family_score(dev, model, params)
    free_memory()
    t1 = k1_timing(dev, params, 4, arch=arch)
    t2 = k2_timing(dev, (SCORE_B, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim), SCORE_L, arch=arch)
    peak = torch.cuda.max_memory_allocated()
    rec = dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim),
        weights_gb=weights / 1e9,
        decode_bound_ms=weights / HBM_BW * 1e3,
        tokens_per_s=rec_dense["tokens_per_s"],
        paged_tokens_per_s=rec_paged["tokens_per_s"],
        decode_step_ms_median=rec_dense["decode_step_ms_median"],
        paged_decode_step_ms_median=rec_paged["decode_step_ms_median"],
        prefill_ms_per_admission=rec_dense["prefill_ms"],
        launches=rec_dense["launches"],
        paged_launches=rec_paged["launches"],
        dense_equals_paged=True, fault_recomputed=True,
        fault_run=dict(faults_detected=rec_fault["faults_detected"],
                       retries=rec_fault["retries"]),
        schemes=sorted({e.split(":")[1]
                        for e in rec_dense["selection_trace"]}),
        score=score, peak_memory_gb=peak / 1e9,
        seconds=time.perf_counter() - t0,
        k1_decode=t1, k2=t2, k3={key: t3[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")})
    emit("family", **rec)
    del params
    free_memory()
    return {"rec": rec, "checks": checks, "k1": t1, "k2": t2, "k3": t3}


def family_runs(dev) -> dict:
    """stablelm-1.6b, qwen3-14b and qwen1.5-32b, one after another."""
    return {arch: family_arch(dev, arch) for arch in FAMILY_ARCHS}


# ------------------------------------------------------------------ sharing

SHARE_SLOTS, SHARE_MAX_LEN, SHARE_BLOCK = 4, 2048, 16
SHARE_CHUNK = 256                   # the fixed chunk budget of the phase
SYS_LEN = 512                       # the shared system prefix


def sharing_traffic(vocab: int, seed: int = 0) -> tuple:
    """(prefix, long) traffic, drawn from ``seed``: lists of (prompt,
    new tokens, arrival iteration).  Prefix: eight prompts of one
    512-token system prefix and a unique 16-128-token suffix, then two
    identical prompts (the COW of a shared tail), 32 new tokens each,
    arriving one every other step (so a sharer is resident when the next
    arrives).  Long: two short prompts (48 tokens, 128 new) at step 0 and
    six prompts of 1024-1536 tokens (16 new) pending from step 4."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, vocab, size=SYS_LEN)
    prefix = [np.concatenate([sys_p, rng.integers(1, vocab, size=int(n))])
              for n in rng.integers(16, 129, size=8)]
    twin = np.concatenate([sys_p, rng.integers(1, vocab, size=40)])
    prefix += [twin, twin.copy()]
    short = [rng.integers(1, vocab, size=48) for _ in range(2)]
    long = [rng.integers(1, vocab, size=int(n))
            for n in rng.integers(1024, 1537, size=6)]
    return ([(p.astype(np.int32), 32, 2 * i) for i, p in enumerate(prefix)],
            [(p.astype(np.int32), 128, 0) for p in short]
            + [(p.astype(np.int32), 16, 4) for p in long])


def share_serve(model, params, traffic, dev, label, *, fault=None,
                fault_at=None, fault_uid=None, capture=None,
                max_retries=1, temperature=0.0, top_k=0, **kw) -> dict:
    """One full-width bf16 engine run (4 slots, max_len 2048, block 16,
    flash on, ``IntensityGuidedPolicy`` on the H100) of ``traffic`` through
    ``admit``/``step``, each request pending from its arrival iteration.
    ``fault``: with ``fault_uid``, an admission fault on that request;
    with ``fault_at`` an int, a step fault at that iteration; with
    ``fault_at="mixed"``, a step fault at the first iteration that
    carries decodes and chunks (it lands on the chunk); with ``"sharers"``,
    at the first decode step with two requests resident and a block
    shared.
    ``check_invariants`` after every iteration; K1 and K3 counted from 0
    for this run; TTFT from each request's arrival, every step timed to a
    synchronize.  ``capture`` collects each request's prompt KV cells
    (first, middle and last layer) once it turns active.  Returns the
    run's record."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import (
        RecoveryPolicy,
        Request,
        ServeEngine,
    )

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    abft = ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                  hardware=NVIDIA_H100_SXM,
                                  flash_attention=True)
    eng = ServeEngine(model, params, slots=SHARE_SLOTS,
                      max_len=SHARE_MAX_LEN, block_size=SHARE_BLOCK,
                      abft=abft, dtype=torch.bfloat16, device=dev,
                      policy=RecoveryPolicy(max_retries=max_retries),
                      temperature=temperature, top_k=top_k, seed=0, **kw)
    auto_budget = eng.chunk_tokens
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n, _) in enumerate(traffic)]
    due = {r.uid: a for r, (_, _, a) in zip(reqs, traffic)}
    pending, later = [], list(reqs)
    layers = (0, model.cfg.n_layers // 2, model.cfg.n_layers - 1)
    torch.cuda.synchronize()
    K1.launches = K3.launches = 0          # counts of THIS run only
    t0 = time.perf_counter()
    arrival, fault_it = {}, None
    step_ms, decode_ms, it = [], [], 0
    while pending or later or eng.active or eng._prefill_cursors:
        now = time.perf_counter()
        for r in [r for r in later if due[r.uid] <= it]:
            arrival[r.uid] = now
            pending.append(r)
            later.remove(r)
        if pending and eng.free_slots():
            if fault is not None and fault_uid is not None:
                eng.admit(pending, fault=fault, fault_uid=fault_uid)
            else:
                eng.admit(pending)
        step_fault = None
        if fault is not None and fault_it is None and fault_uid is None:
            mixed = bool(eng.active and eng._prefill_cursors)
            sharers = (eng.pool is not None and eng.pool.blocks_shared > 0
                       and len(eng.active) >= 2
                       and not eng._prefill_cursors)
            if fault_at == it or (fault_at == "mixed" and mixed) or (
                    fault_at == "sharers" and sharers):
                step_fault, fault_it = fault, it
        ts = time.perf_counter()
        chunked = bool(eng._prefill_cursors)
        out = eng.step(step_fault)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - ts)
        step_ms.append(dt)
        if out and not chunked:
            decode_ms.append(dt)
        if eng.pool is not None:
            eng.pool.check_invariants()
        if capture is not None:
            for s, r in eng.active.items():
                if r.uid in capture:
                    continue
                n = len(r.prompt)
                if eng.pool is not None:
                    t = torch.as_tensor(eng.pool.tables[s], device=dev)
                    pos = torch.arange(n, device=dev)
                    idx = (t[pos // SHARE_BLOCK].long(), pos % SHARE_BLOCK)
                else:
                    idx = (s, slice(0, n))
                capture[r.uid] = [eng.cache[i][k][idx].clone()
                                  for i in layers for k in ("k", "v")]
        it += 1
        need(it < 4000, f"sharing {label}: the run does not end")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = eng.stats
    rec = dict(
        label=label, seconds=seconds, iterations=it, fault_at=fault_it,
        launches={"abft_matmul": K1.launches, "flash_decode": K3.launches},
        streams={r.uid: list(r.generated) for r in reqs},
        errors={r.uid: r.error for r in reqs if r.error},
        ttft_ms={r.uid: 1e3 * (r.times[0] - arrival[r.uid])
                 for r in reqs if r.times},
        step_ms_median=float(np.median(step_ms)),
        decode_step_ms_median=(float(np.median(decode_ms))
                               if decode_ms else None),
        prompt_tokens=st.prompt_tokens_total,
        prefill_tokens_computed=sum(e["prefill"]
                                    for e in st.selection_trace),
        blocks_used_peak=st.blocks_used_peak,
        blocks_used_mean=st.blocks_used_mean,
        blocks_used_median=st.blocks_used_median,
        blocks_shared_peak=st.blocks_shared_peak,
        auto_budget=auto_budget if kw.get("chunk_tokens") == "auto"
        else None,
        chunk_tokens=eng.chunk_tokens,
        schemes=sorted({e["scheme"] for e in st.selection_trace}),
        scheme_flips=st.scheme_flips,
        **{k: getattr(st, k) for k in (
            "steps", "tokens", "faults_detected", "retries", "hard_faults",
            "evictions", "prefix_tokens_shared", "cow_copies",
            "prefill_chunks", "chunk_retries", "chunk_budget_retunes",
            "mixed_steps", "decode_only_steps", "prefill_only_steps")})
    rec["times"] = {r.uid: list(r.times) for r in reqs}
    rec["arrival"] = arrival
    need(rec["launches"]["abft_matmul"] > 0
         and rec["launches"]["flash_decode"] > 0,
         f"sharing {label}: K1 or K3 never launched {rec['launches']}")
    if eng.pool is not None:
        need(eng.pool.blocks_free == eng.pool.num_blocks,
             f"sharing {label}: blocks leaked")
    out = {k: v for k, v in rec.items()
           if k not in ("streams", "times", "arrival")}
    emit("sharing_run", **out)
    del eng
    return rec


def _itl(rec, uids, lo, hi) -> dict:
    """p50 / p99 inter-token gap (ms) of streams ``uids`` between host
    times ``lo`` and ``hi``."""
    gaps = [1e3 * (b - a) for u in uids
            for a, b in zip(rec["times"][u], rec["times"][u][1:])
            if lo <= a and b <= hi]
    need(gaps, f"sharing {rec['label']}: no inter-token gap in the window")
    return {"p50": float(np.percentile(gaps, 50)),
            "p99": float(np.percentile(gaps, 99)),
            "max": float(max(gaps)), "gaps": len(gaps)}


def _kv_diff(a: dict, b: dict) -> float:
    """Largest |difference| between two runs' captured prompt KV cells."""
    worst = 0.0
    for uid in a.keys() & b.keys():
        for x, y in zip(a[uid], b[uid]):
            worst = max(worst, (x.float() - y.float()).abs().max().item())
    return worst


def _same_streams(rec, ref, what, clean: bool = True) -> None:
    need(not rec["errors"], f"sharing {what}: errors {rec['errors']}")
    need(rec["streams"] == ref["streams"],
         f"sharing {what}: greedy streams differ from the reference run")
    need(not clean or rec["faults_detected"] == 0,
         f"sharing {what}: a clean run raised a flag")


def sharing_llama(dev, params=None) -> dict:
    """Full-width llama3.2-1b: the prefix and long-prompt traffic through
    the reference run (paged, neither feature) and every feature, faults
    included; the gates of the slice (see ``main``'s docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    if params is None:
        params, _ = engine_inputs(dev)
    prefix, long = sharing_traffic(cfg.vocab_size)

    def run(traffic, label, **kw):
        return share_serve(model, params, traffic, dev, label, **kw)

    run(prefix[:2], "warmup", cache_kind="paged", prefix_sharing=True,
        chunk_tokens=SHARE_CHUNK)
    kv_ref, kv_chunk, kv_share = {}, {}, {}
    ref = run(prefix, "prefix_reference", cache_kind="paged",
              capture=kv_ref)
    share = run(prefix, "prefix_sharing", cache_kind="paged",
                prefix_sharing=True, capture=kv_share)
    _same_streams(share, ref, "prefix_sharing")
    need(share["prefix_tokens_shared"] > 0 and share["cow_copies"] > 0
         and share["blocks_shared_peak"] > 0,
         "sharing: no prefix shared, block shared or tail copied")
    need(share["blocks_used_peak"] < ref["blocks_used_peak"]
         and share["blocks_used_mean"] < ref["blocks_used_mean"],
         "sharing: no fewer pool blocks than without it")
    runs = {"prefix_reference": ref, "prefix_sharing": share}
    for label, kw in (
            ("prefix_chunk256_dense", dict(chunk_tokens=SHARE_CHUNK)),
            ("prefix_chunk256_paged", dict(cache_kind="paged",
                                           chunk_tokens=SHARE_CHUNK,
                                           capture=kv_chunk)),
            ("prefix_chunk_auto", dict(cache_kind="paged",
                                       chunk_tokens="auto")),
            ("prefix_sharing_chunk256", dict(cache_kind="paged",
                                             prefix_sharing=True,
                                             chunk_tokens=SHARE_CHUNK))):
        rec = run(prefix, label, **kw)
        _same_streams(rec, ref, label)
        need(rec["prefill_chunks"] > 0, f"sharing {label}: no chunk ran")
        runs[label] = rec
    both = runs["prefix_sharing_chunk256"]
    need(both["prefix_tokens_shared"] > 0 and both["cow_copies"] > 0,
         "sharing+chunking: no prefix shared or tail copied")
    kv = {"chunk_vs_whole": _kv_diff(kv_chunk, kv_ref),
          "suffix_vs_whole": _kv_diff(kv_share, kv_ref),
          "requests": len(kv_ref.keys() & kv_chunk.keys())}
    emit("sharing_kv_cells", **kv)

    # sampling: four requests, one per slot, so every slot's draws are
    # the same sequence however the prompts were prefilled
    samp = {}
    for label, kw in (("sampled", dict(cache_kind="paged")),
                      ("sampled_chunk256", dict(cache_kind="paged",
                                                chunk_tokens=SHARE_CHUNK))):
        samp[label] = run(prefix[:4], label, temperature=0.8, top_k=50,
                          **kw)
    need(samp["sampled"]["streams"] == samp["sampled_chunk256"]["streams"],
         "sharing: sampled streams differ between chunked and unchunked")

    # faults: a chunk fault retried alone; a decode fault with sharers
    # resident; a persistent admission fault evicting one sharer
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    cf = run(prefix, "chunk_fault", cache_kind="paged", prefix_sharing=True,
             chunk_tokens=SHARE_CHUNK, fault=fault, fault_at="mixed")
    _same_streams(cf, ref, "chunk_fault", clean=False)
    need(cf["fault_at"] is not None and cf["faults_detected"] == 1
         and cf["chunk_retries"] == 1 and cf["retries"] == 1
         and cf["hard_faults"] == 0,
         f"chunk fault: not retried alone ({cf['chunk_retries']} chunk "
         f"retries, {cf['retries']} retries)")
    need(cf["steps"] == both["steps"], "chunk fault: the step count moved")
    df = run(prefix, "decode_fault_sharers", cache_kind="paged",
             prefix_sharing=True, fault=fault, fault_at="sharers")
    _same_streams(df, ref, "decode_fault_sharers", clean=False)
    need(df["fault_at"] is not None and df["faults_detected"] == 1
         and df["retries"] == 1,
         "decode fault with sharers: not detected and retried")
    # uid 9 is the second twin: it shares uid 8's blocks, its tail copied
    ev = run(prefix, "evict_one_sharer", cache_kind="paged",
             prefix_sharing=True, max_retries=0, fault=fault, fault_uid=9)
    need(ev["errors"].get(9) == "hard_fault:prefill"
         and set(ev["errors"].values()) == {"hard_fault:prefill"},
         f"persistent fault: evicted {ev['errors']}")
    survivors = [u for u in ev["streams"] if u not in ev["errors"]]
    need(8 in survivors and all(ev["streams"][u] == ref["streams"][u]
                                for u in survivors),
         "persistent fault: a surviving sharer's stream changed")
    need(ev["hard_faults"] == 1, "persistent fault: no hard fault")

    # long prompts beside two resident short streams
    lref = run(long, "long_reference", cache_kind="paged")
    lchunk = run(long, "long_chunk256", cache_kind="paged",
                 chunk_tokens=SHARE_CHUNK)
    _same_streams(lchunk, lref, "long_chunk256")
    need(lchunk["mixed_steps"] > 0, "long: no step mixed decode and chunks")
    itl = {}
    for rec in (lref, lchunk):
        lo = min(rec["arrival"][u] for u in range(2, 8))
        hi = max(rec["times"][u][0] for u in range(2, 8))
        itl[rec["label"]] = _itl(rec, (0, 1), lo, hi)
    emit("sharing_itl", **itl)
    runs.update(samp, chunk_fault=cf, decode_fault_sharers=df,
                evict_one_sharer=ev, long_reference=lref,
                long_chunk256=lchunk)
    t_chunk = k1_timing(dev, params, SHARE_CHUNK, one_slice=True)
    t_chunk_split = k1_timing(dev, params, SHARE_CHUNK)
    attn = prefill_attention_timing(dev, cfg)
    summary = dict(
        arch=ENGINE_ARCH,
        ttft_ms={k: runs[k]["ttft_ms"] for k in (
            "prefix_reference", "prefix_sharing", "prefix_sharing_chunk256",
            "long_reference", "long_chunk256")},
        itl_short_streams=itl,
        decode_step_ms={k: r["decode_step_ms_median"]
                        for k, r in runs.items()},
        prefill_tokens={k: (r["prefill_tokens_computed"],
                            r["prompt_tokens"]) for k, r in runs.items()},
        blocks_used={k: (r["blocks_used_peak"], r["blocks_used_mean"])
                     for k, r in runs.items()},
        auto_budget=runs["prefix_chunk_auto"]["auto_budget"],
        auto_retunes=runs["prefix_chunk_auto"]["chunk_budget_retunes"],
        auto_schemes=runs["prefix_chunk_auto"]["schemes"],
        kv_cells_max_abs_diff=kv,
        launches={k: r["launches"] for k, r in runs.items()},
        k1_chunk={"one_slice": t_chunk, "split": t_chunk_split},
        prefill_attention_ms=attn)
    emit("sharing", **summary)
    return summary


def prefill_attention_timing(dev, cfg) -> dict:
    """One layer's serving prefill attention at ``cfg``'s heads, bf16:
    the row-wise path the serving prefill runs (``spans``: fixed 512 x
    1024 f32 blocks, a row at a time) against the batched path the plain
    engine ran before it (``lengths`` only), on an engine admission (4
    rows padded to 256, lengths 256/192/128/64) and on one 256-token
    chunk at logical 1280 over its 1536 keys.  Milliseconds between CUDA
    events around eager calls: the host's launches are in them.  Both
    paths' outputs agree within 2^-7 x max|out| (the same f32 math in
    blocks of other shapes)."""
    from repro_torch.models.layers import chunked_attention

    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for name, (B, Lq, Lk, off, lens) in {
            "admission_4x256": (4, 256, 256, 0, (256, 192, 128, 64)),
            "chunk_256_at_1280": (1, 256, 1536, 1280, (1536,))}.items():
        q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(
            torch.bfloat16)
        lengths = torch.tensor(lens, device=dev)
        spans = [(off, n) for n in lens]

        def batched():
            return chunked_attention(q, k, v, causal=True, q_offset=off,
                                     lengths=lengths)

        def rowwise():
            return chunked_attention(q, k, v, causal=True, spans=spans)

        a, b = batched().float(), rowwise().float()
        valid = torch.zeros(B, Lq, dtype=torch.bool, device=dev)
        for i, n in enumerate(lens):
            valid[i, :n - off] = True
        err = (a - b)[valid].abs().max().item()
        need(err <= 2 ** -7 * a[valid].abs().max().item(),
             f"prefill attention {cfg.name} {name}: paths differ by {err}")
        out[name] = {"batched_ms": timed(batched, iters=5),
                     "rowwise_ms": timed(rowwise, iters=5),
                     "layers": cfg.n_layers}
    return out


def sharing_qwen(dev) -> dict:
    """qwen3-14b at full width (G = 5, q/k norm; ``SIDE_LAYERS`` layers):
    the prefix traffic under sharing with chunks of 256 against its
    unshared, unchunked run."""
    from repro_torch.models.model import Model

    arch = SIDE_ARCH
    cfg = side_config()
    model = Model(cfg)
    free_memory()
    params, _ = engine_inputs(dev, cfg=cfg)
    prefix, _ = sharing_traffic(cfg.vocab_size)
    ref = share_serve(model, params, prefix, dev, f"{arch} reference",
                      cache_kind="paged")
    both = share_serve(model, params, prefix, dev,
                       f"{arch} sharing_chunk256", cache_kind="paged",
                       prefix_sharing=True, chunk_tokens=SHARE_CHUNK)
    _same_streams(both, ref, f"{arch} sharing_chunk256")
    need(both["prefix_tokens_shared"] > 0 and both["prefill_chunks"] > 0,
         f"{arch}: no prefix shared or no chunk ran")
    rec = dict(arch=arch, layers=cfg.n_layers, streams_equal=True,
               prefill_attention_ms=prefill_attention_timing(dev, cfg),
               decode_step_ms={"reference": ref["decode_step_ms_median"],
                               "sharing_chunk256":
                                   both["decode_step_ms_median"]},
               ttft_ms={"reference": ref["ttft_ms"],
                        "sharing_chunk256": both["ttft_ms"]},
               prefill_tokens={"reference": (ref["prefill_tokens_computed"],
                                             ref["prompt_tokens"]),
                               "sharing_chunk256": (
                                   both["prefill_tokens_computed"],
                                   both["prompt_tokens"])},
               blocks_used_peak={"reference": ref["blocks_used_peak"],
                                 "sharing_chunk256":
                                     both["blocks_used_peak"]},
               launches={"reference": ref["launches"],
                         "sharing_chunk256": both["launches"]},
               seconds=ref["seconds"] + both["seconds"])
    emit("sharing_family", **rec)
    del params
    free_memory()
    return rec


def sharing_runs(dev, params=None) -> dict:
    out = {"llama": sharing_llama(dev, params)}
    free_memory()
    out["qwen"] = sharing_qwen(dev)
    return out


# ------------------------------------------------------------------ spec

SPEC_SLOTS, SPEC_MAX_LEN, SPEC_BLOCK, SPEC_NEW = 4, 1024, 16, 64
SPEC_CHUNK = 256


def spec_traffic(vocab: int, seed: int = 0) -> dict:
    """Copy and fresh traffic, drawn from ``seed``: lists of prompts.
    Copy: eight prompts of 128-512 random tokens that repeat one random
    span of 8-32 tokens three times, the last copy at the end (the
    prompt-lookup case of code editing and quoting answers).  Fresh:
    eight prompts of 128-512 random tokens (drafts mostly miss)."""
    rng = np.random.default_rng(seed)
    copy, fresh = [], []
    for n in rng.integers(128, 513, size=8):
        span = rng.integers(1, vocab, size=int(rng.integers(8, 33)))
        body = rng.integers(1, vocab, size=int(n) - 3 * len(span))
        cuts = np.sort(rng.choice(len(body), size=2, replace=False))
        copy.append(np.concatenate([body[:cuts[0]], span,
                                    body[cuts[0]:cuts[1]], span,
                                    body[cuts[1]:], span]).astype(np.int32))
    for n in rng.integers(128, 513, size=8):
        fresh.append(rng.integers(1, vocab, size=int(n)).astype(np.int32))
    return {"copy": copy, "fresh": fresh}


class _TimedProposer:
    """A proposer that adds its host time to ``ms``."""

    def __init__(self, inner):
        self.inner, self.name, self.ms = inner, inner.name, 0.0

    def propose(self, req, k):
        t = time.perf_counter()
        out = self.inner.propose(req, k)
        self.ms += 1e3 * (time.perf_counter() - t)
        return out


class _OracleProposer:
    """Proposes the unsped run's own next tokens: every draft is accepted
    (streams are bit-equal), so the run shows the verify step's ceiling,
    which random weights keep the real proposers from reaching."""

    name = "oracle"

    def __init__(self, streams):
        self.streams = streams

    def propose(self, req, k):
        n = len(req.generated)
        return np.asarray(self.streams[req.uid][n:n + k], np.int32)


def spec_serve(model, params, prompts, dev, label, *, policy=None,
               fault_model=None, fault_step=None, max_retries=1,
               temperature=0.0, top_k=0, phase="spec_run", **kw) -> dict:
    """One full-width bf16 engine run (4 slots, max_len 1024, block 16,
    flash off, ``IntensityGuidedPolicy`` on the H100 unless ``policy``)
    of ``prompts`` (64 new tokens each, all pending from the start)
    through ``admit``/``step``.  Every step is timed to a synchronize; K1
    and K3 counted from 0 for this run, and K1 must launch on every step
    that ran a verify (or decode) call (not under a fixed plain
    ``policy``, whose product is ``torch.matmul``), K2 and K3 never (flash
    is off: the self-draft's ``full`` forward takes
    ``chunked_attention``).  ``k1_verify_launches_by_m``: K1's launches
    inside the verify calls, by the call's GEMM height M = slots x T.
    ``fault_step``: a
    ``(step, fault)`` injected at that engine step; ``fault_model``: a
    campaign.  ``check_invariants`` after every paged step.  Returns the
    run's record (streams and errors included)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import (
        RecoveryPolicy,
        Request,
        ServeEngine,
    )

    K1, K2 = abft_matmul.KERNEL, flash_attention.FULL_KERNEL
    K3 = flash_attention.KERNEL
    abft = ABFTConfig.from_policy(policy or IntensityGuidedPolicy(),
                                  hardware=NVIDIA_H100_SXM)
    eng = ServeEngine(model, params, slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
                      block_size=SPEC_BLOCK, abft=abft,
                      dtype=torch.bfloat16, device=dev,
                      policy=RecoveryPolicy(max_retries=max_retries),
                      temperature=temperature, top_k=top_k, seed=0,
                      fault_model=fault_model, **kw)
    if eng.spec is not None:
        eng.spec = _TimedProposer(eng.spec)
    auto_k = eng.draft_len
    by_m: dict = {}

    def counted(inner):
        def verify(*a):
            k1 = K1.launches
            out = inner(*a)
            m = a[1].shape[0] * a[1].shape[1]
            by_m[m] = by_m.get(m, 0) + K1.launches - k1
            return out
        return verify

    for r in eng._level_runners:
        r.verify = counted(r.verify)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SPEC_NEW)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    step_ms, steps_k1, it = [], [], 0
    torch.cuda.synchronize()
    K1.launches = K2.launches = K3.launches = 0    # THIS run's counts
    t0 = time.perf_counter()
    while pending or eng.active or eng._prefill_cursors:
        if pending and eng.free_slots():
            eng.admit(pending)
        fault = None
        if fault_step is not None and it == fault_step[0]:
            fault = fault_step[1]
        before, k1 = eng.stats.steps, K1.launches
        active = bool(eng.active)
        ts = time.perf_counter()
        eng.step(fault)
        torch.cuda.synchronize()
        if eng.stats.steps > before and active:
            step_ms.append(1e3 * (time.perf_counter() - ts))
            steps_k1.append(K1.launches - k1)
        if eng.pool is not None:
            eng.pool.check_invariants()
        it += 1
        need(it < 2000, f"spec {label}: the run does not end")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = eng.stats
    verify = eng.spec is not None
    rec = dict(
        label=label, seconds=seconds, steps=len(step_ms),
        tokens=st.tokens, tokens_per_s=st.tokens / seconds,
        step_ms_median=float(np.median(step_ms)),
        step_kind="verify" if verify else "decode",
        k1_launches_per_step_min=min(steps_k1),
        launches={"abft_matmul": K1.launches,
                  "flash_attention": K2.launches,
                  "flash_decode": K3.launches},
        k1_verify_launches_by_m=dict(sorted(by_m.items())),
        streams={r.uid: list(r.generated) for r in reqs},
        errors={r.uid: r.error for r in reqs if r.error},
        **{k: getattr(st, k) for k in (
            "faults_detected", "retries", "verify_retries", "hard_faults",
            "evictions", "draft_proposed", "draft_accepted", "scheme_flips",
            "prefix_tokens_shared", "prefill_chunks", "cow_copies")})
    rec["acceptance"] = (st.draft_accepted / st.draft_proposed
                         if st.draft_proposed else None)
    # tokens a resident-slot step emits (admission emits one a request)
    rec["tokens_per_step"] = (st.tokens - len(reqs)) / max(1, len(step_ms))
    rec["proposer_ms_per_step"] = (eng.spec.ms / max(1, len(step_ms))
                                   if verify else None)
    rec["draft_len"] = eng.draft_len if verify else None
    rec["auto_draft_len"] = auto_k if kw.get("draft_len") == "auto" \
        else None
    rec["schemes"] = sorted({e["scheme"] for e in st.selection_trace})
    if policy is None:
        need(min(steps_k1) > 0, f"spec {label}: a step launched no K1")
    need(K2.launches == 0 and K3.launches == 0,
         f"spec {label}: K2 or K3 launched with flash off")
    if eng.pool is not None:
        need(eng.pool.blocks_free == eng.pool.num_blocks,
             f"spec {label}: blocks leaked")
    emit(phase, **{k: v for k, v in rec.items() if k != "streams"})
    del eng
    return rec


def _same_spec_streams(rec, ref, what, clean: bool = True) -> None:
    need(not rec["errors"], f"spec {what}: errors {rec['errors']}")
    need(rec["streams"] == ref["streams"],
         f"spec {what}: greedy streams differ from the unsped run")
    need(not clean or rec["faults_detected"] == 0,
         f"spec {what}: a clean run raised a flag")


def norm_row_order(dev) -> dict:
    """Whether a norm over the (slots, T) rows of a verify step reduces
    each row in the order of decode's (slots, 1) rows, at the dense
    family's norm widths: ``rms_norm`` over d_model 2048 (llama3.2-1b)
    and 5120 (qwen3-14b), ``layer_norm`` over 2048 (stablelm-1.6b), and
    qwen3-14b's q/k norms over head_dim 128 (40 and 8 heads a row).  For
    slots 1, 4, 8 and 16 and T 2, 5 and 9: ``f32`` — the row reductions
    (mean of squares; mean and variance) bit-equal; ``out`` — the norm's
    bf16 output bit-equal (a coarser probe: an f32 ulp rarely moves a
    bf16 rounding); ``per_step`` — the verify path's own (``per_step``)
    output bit-equal.  Observations: the gates are the streams and the
    card tests."""
    from repro_torch.models.layers import layer_norm, per_step, rms_norm

    def rms_red(x):
        xf = x.float()
        return (xf * xf).mean(dim=-1, keepdim=True)

    def ln_red(x):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        return torch.cat([mu, ((xf - mu) ** 2).mean(dim=-1, keepdim=True)],
                         -1)

    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    cases = {"rms_norm_2048": ((2048,), rms_red, rms_norm, (rnd(2048),)),
             "rms_norm_5120": ((5120,), rms_red, rms_norm, (rnd(5120),)),
             "layer_norm_2048": ((2048,), ln_red, layer_norm,
                                 (rnd(2048), rnd(2048))),
             "q_norm_40x128": ((40, 128), rms_red, rms_norm, (rnd(128),)),
             "k_norm_8x128": ((8, 128), rms_red, rms_norm, (rnd(128),))}
    out = {}
    for name, (width, red, fn, args) in cases.items():
        rec = {}
        for slots in (1, 4, 8, 16):
            eq = {"f32": True, "out": True, "per_step": True}
            for T in (2, 5, 9):
                x = rnd(slots, T, *width)
                steps = [x[:, t:t + 1].contiguous() for t in range(T)]
                dec_red = torch.cat([red(s) for s in steps], 1)
                dec = torch.cat([fn(s, *args) for s in steps], 1)
                eq["f32"] &= bool(torch.equal(red(x), dec_red))
                eq["out"] &= bool(torch.equal(fn(x, *args), dec))
                eq["per_step"] &= bool(torch.equal(
                    per_step(fn, x, *args), dec))
            rec[slots] = eq
        out[name] = rec
    return out


def spec_row_order(dev, params, cfg) -> dict:
    """What the verify path's design rests on, observed at the phase's
    shapes (4 slots, K = 8: 36 rows; 16 slots: 144): whether the plain
    batched version of each op gives a decode row's bits (the verify path
    does not use them where they do not), and whether the verify path
    does.  Observations, not gates: the gates are the streams."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import decode_attention, verify_attention

    g = torch.Generator(device=dev).manual_seed(9)
    lp = params["layers"][0]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    out = {}
    for slots in (4, 16):
        for name, w in (("down", lp["ffn"]["down"]),
                        ("q", lp["mixer"]["wq"])):
            xw = torch.randn(slots, 9, w.shape[0], generator=g,
                             device=dev).to(torch.bfloat16)
            rows = torch.cat([ops.abft_matmul(xw[:, t:t + 1].contiguous(),
                                              w)[0] for t in range(9)], 1)
            out[f"k1_{name}_unpinned_equal_{slots}"] = bool(torch.equal(
                ops.abft_matmul(xw, w)[0], rows))
            out[f"k1_{name}_pinned_equal_{slots}"] = bool(torch.equal(
                ops.abft_matmul(xw, w, decode_rows=slots)[0], rows))
            mm = torch.cat([torch.matmul(xw[:, t:t + 1].contiguous(), w)
                            for t in range(9)], 1)
            out[f"matmul_{name}_equal_{slots}"] = bool(torch.equal(
                torch.matmul(xw, w), mm))
    k = torch.randn(4, SPEC_MAX_LEN, KV, hd, generator=g,
                    device=dev).to(torch.bfloat16)
    q = torch.randn(4, 9, H, hd, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.tensor([130, 250, 511, 900], dtype=torch.int32, device=dev)
    rows = torch.cat([decode_attention(q[:, t:t + 1].contiguous(), k, k,
                                       pos + 1 + t) for t in range(9)], 1)
    out["verify_attention_equal"] = bool(torch.equal(
        verify_attention(q, k, k, pos + 1), rows))
    # a batched alternative: the T queries of a row as one einsum
    kf = k.float()
    qg = q.float().reshape(4, 9, KV, H // KV, hd)
    s = torch.einsum("btkgd,bskd->btkgs", qg, kf) * hd ** -0.5
    lim = (pos + 1)[:, None] + torch.arange(9, device=dev)[None, :]
    valid = torch.arange(SPEC_MAX_LEN, device=dev)[None, None, :] < \
        lim[:, :, None]
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, -1e30))
    p = torch.softmax(s, -1).to(k.dtype).float()
    batched = torch.einsum("btkgs,bskv->btkgv", p, kf).reshape(
        4, 9, H, hd).to(q.dtype)
    out["attention_batched_equal"] = bool(torch.equal(batched, rows))
    out["norms"] = norm_row_order(dev)
    emit("spec_row_order", **out)
    return out


def spec_llama(dev, params=None) -> dict:
    """Full-width llama3.2-1b: copy and fresh traffic unsped (dense,
    paged) and with n-gram drafts at K = 4 and ``"auto"`` (dense, paged);
    on copy traffic also an oracle proposer at K = 4 and 8, self-draft
    (2 layers over 16 tokens), n-gram with sharing and chunks of 256, a
    verify fault, a sticky campaign fault, sampling, and a ``global``
    pair (an observation).  Every greedy stream held to the unsped run's
    on the same traffic; K1 at the verify step's M = 36; the row-order
    observations."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultModel, FaultSpec
    from repro_torch.core.policy import FixedPolicy
    from repro_torch.core.schemes import Scheme
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    cfg = get_config(ENGINE_ARCH)
    model = Model(cfg)
    if params is None:
        params, _ = engine_inputs(dev)
    traffic = spec_traffic(cfg.vocab_size)

    def run(kind, label, **kw):
        return spec_serve(model, params, traffic[kind], dev,
                          f"{kind} {label}", **kw)

    ngram4 = dict(spec_decode="ngram", draft_len=4)
    spec_serve(model, params, traffic["copy"][:2], dev, "warmup",
               **ngram4)
    runs = {}
    for kind in ("copy", "fresh"):
        ref = runs[f"{kind} unsped"] = run(kind, "unsped")
        refp = runs[f"{kind} unsped_paged"] = run(kind, "unsped_paged",
                                                  cache_kind="paged")
        _same_spec_streams(refp, ref, f"{kind} unsped_paged")
        for label, kw in (("ngram_k4", ngram4),
                          ("ngram_k4_paged", dict(ngram4,
                                                  cache_kind="paged")),
                          ("ngram_auto", dict(spec_decode="ngram",
                                              draft_len="auto")),
                          ("ngram_auto_paged", dict(spec_decode="ngram",
                                                    draft_len="auto",
                                                    cache_kind="paged"))):
            rec = runs[f"{kind} {label}"] = run(kind, label, **kw)
            _same_spec_streams(rec, ref, f"{kind} {label}")
            need(rec["draft_proposed"] > 0, f"spec {label}: no draft")
    ref = runs["copy unsped"]
    oracle = _OracleProposer(ref["streams"])
    for label, kw in (
            ("oracle_k4", dict(spec_decode=oracle, draft_len=4)),
            ("oracle_k8", dict(spec_decode=oracle, draft_len=8)),
            ("self_draft_2at16", dict(spec_decode="self_draft", draft_len=4,
                                      draft_units=2, draft_window=16)),
            ("ngram_k4_sharing_chunk256", dict(
                ngram4, cache_kind="paged", prefix_sharing=True,
                chunk_tokens=SPEC_CHUNK))):
        rec = runs[f"copy {label}"] = run("copy", label, **kw)
        _same_spec_streams(rec, ref, label)
    need(runs["copy ngram_k4_sharing_chunk256"]["prefill_chunks"] > 0,
         "spec sharing+chunks: no chunk ran")
    need(runs["copy oracle_k4"]["acceptance"] == 1.0,
         "spec oracle: a draft of the unsped stream was rejected")
    m36 = runs["copy oracle_k8"]["k1_verify_launches_by_m"].get(
        SPEC_SLOTS * 9, 0)
    need(m36 > 0, "spec oracle_k8: no verify call of 36 rows launched K1")

    # a fault at a verify step: retried, the window only
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    rec = runs["copy verify_fault"] = run("copy", "verify_fault",
                                          fault_step=(3, fault), **ngram4)
    _same_spec_streams(rec, ref, "verify_fault", clean=False)
    need(rec["faults_detected"] == 1 and rec["verify_retries"] == 1
         and rec["retries"] == 1 and rec["hard_faults"] == 0,
         f"spec verify fault: not retried within the window ({rec})")
    need(rec["steps"] == runs["copy ngram_k4"]["steps"],
         "spec verify fault: the step count moved")
    # a sticky permanent fault: the resident slots are evicted
    # (seed 6: one onset, at the 7th step, for one step; the next at the
    # 194th, past the run's end)
    fm = FaultModel(transient_rate=0.0, permanent_rate=0.03,
                    permanent_duration=1, seed=6, layers=cfg.n_layers,
                    dtype=torch.float32, magnitude=1e4,
                    sites=("mlp_down",))
    rec = runs["copy sticky_fault"] = run("copy", "sticky_fault",
                                          fault_model=fm, **ngram4)
    survivors = [u for u in rec["streams"] if u not in rec["errors"]]
    need(rec["hard_faults"] == 1 and len(rec["errors"]) == SPEC_SLOTS
         and set(rec["errors"].values()) == {"hard_fault:verify"},
         f"spec sticky fault: the resident slots were not evicted with "
         f"hard_fault:verify ({rec['errors']})")
    need(survivors and all(rec["streams"][u] == ref["streams"][u]
                           for u in survivors),
         "spec sticky fault: a surviving stream changed")
    # sampling through the rejection rule
    rec = runs["copy sampled"] = run("copy", "sampled", temperature=0.8,
                                     top_k=50, **ngram4)
    need(not rec["errors"] and all(
        len(s) == SPEC_NEW and all(0 <= t < cfg.vocab_size for t in s)
        for s in rec["streams"].values()), "spec sampled: bad stream")
    need(rec["acceptance"] is not None, "spec sampled: no draft")
    # the plain product of ``global`` and ``none`` (``torch.matmul``, not
    # K1): a verify step runs it at the decode step's shape step by step
    plain = {}
    for scheme in (Scheme.GLOBAL, Scheme.NONE):
        pol = FixedPolicy(scheme)
        pref = runs[f"copy {scheme.value}_unsped"] = run(
            "copy", f"{scheme.value}_unsped", policy=pol)
        rec = runs[f"copy {scheme.value}_ngram_k4"] = run(
            "copy", f"{scheme.value}_ngram_k4", policy=pol, **ngram4)
        _same_spec_streams(rec, pref, f"{scheme.value}_ngram_k4")
        need(rec["launches"]["abft_matmul"] == 0,
             f"spec {scheme.value}: K1 launched under a plain scheme")
        plain[scheme.value] = True
    verify_t = k1_timing(dev, params, SPEC_SLOTS * 9, split_rows=SPEC_SLOTS)
    summary = dict(
        arch=ENGINE_ARCH,
        tokens_per_s={k: r["tokens_per_s"] for k, r in runs.items()},
        step_ms={k: (r["step_kind"], r["step_ms_median"])
                 for k, r in runs.items()},
        acceptance={k: r["acceptance"] for k, r in runs.items()},
        tokens_per_step={k: r["tokens_per_step"] for k, r in runs.items()},
        proposer_ms_per_step={k: r["proposer_ms_per_step"]
                              for k, r in runs.items()},
        auto_draft_len={k: r["auto_draft_len"] for k, r in runs.items()
                        if r["auto_draft_len"] is not None},
        launches={k: r["launches"] for k, r in runs.items()},
        plain_scheme_streams_equal=plain,
        k1_verify_m36=verify_t,
        k1_verify_m36_launches=m36,
        row_order=spec_row_order(dev, params, cfg))
    emit("spec", **summary)
    return summary


def spec_qwen(dev) -> dict:
    """qwen3-14b at full width (G = 5, q/k norm; ``SIDE_LAYERS`` layers):
    copy traffic unsped, with ngram ``"auto"`` and with the oracle at K =
    8 (every step at T > 1 while a draft is left: the batched q/k norms at
    4 x 9 rows), dense; streams equal."""
    from repro_torch.models.model import Model

    arch = SIDE_ARCH
    cfg = side_config()
    model = Model(cfg)
    free_memory()
    params, _ = engine_inputs(dev, cfg=cfg)
    copy = spec_traffic(cfg.vocab_size)["copy"]
    ref = spec_serve(model, params, copy, dev, f"{arch} unsped")
    auto = spec_serve(model, params, copy, dev, f"{arch} ngram_auto",
                      spec_decode="ngram", draft_len="auto")
    _same_spec_streams(auto, ref, f"{arch} ngram_auto")
    oracle = spec_serve(model, params, copy, dev, f"{arch} oracle_k8",
                        spec_decode=_OracleProposer(ref["streams"]),
                        draft_len=8)
    _same_spec_streams(oracle, ref, f"{arch} oracle_k8")
    need(oracle["acceptance"] == 1.0,
         f"spec {arch} oracle: a draft of the unsped stream was rejected")
    rec = dict(arch=arch, layers=cfg.n_layers, streams_equal=True,
               tokens_per_s={"unsped": ref["tokens_per_s"],
                             "ngram_auto": auto["tokens_per_s"],
                             "oracle_k8": oracle["tokens_per_s"]},
               step_ms={"decode": ref["step_ms_median"],
                        "verify": auto["step_ms_median"],
                        "verify_oracle_k8": oracle["step_ms_median"]},
               acceptance=auto["acceptance"],
               tokens_per_step=auto["tokens_per_step"],
               oracle_tokens_per_step=oracle["tokens_per_step"],
               auto_draft_len=auto["auto_draft_len"],
               launches={"unsped": ref["launches"],
                         "ngram_auto": auto["launches"],
                         "oracle_k8": oracle["launches"]})
    emit("spec_family", **rec)
    del params
    free_memory()
    return rec


def spec_runs(dev, params=None) -> dict:
    out = {"llama": spec_llama(dev, params)}
    free_memory()
    out["qwen"] = spec_qwen(dev)
    return out


# ------------------------------------------------------------------ moe

MOE_ARCH = "qwen2-moe-a2.7b"
# expert capacity at a decode step of 4 slots and at an admission of 4
# prompts padded to 256 tokens (1024 tokens, top-4 of 60, factor 1.25)
MOE_C = (4, 88)
MOE_E = 60                          # its routed experts; (K, N) a GEMM
MOE_SHAPES = {"up": (2048, 1408), "down": (1408, 2048)}


def _moe_clamp(C, k, n):
    return tuple(min(b, -(-d // 8) * 8) for b, d in
                 ((256, C), (512, k), (256, n)))


def _moe_fault_check(x, w, mode, name) -> None:
    """A value fault at (C - 1, N / 2 + 3) — not batched, so in every
    expert — is flagged in every expert at its (block_i, block_j, row),
    by the kernel and by the plain version alike."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    E, C, k = x.shape
    n = w.shape[2]
    row, col = C - 1, n // 2 + 3
    bm, bk, bn = _moe_clamp(C, k, n)
    fault = FaultSpec.value(row, col, 1e5)
    _, chk = ops.abft_matmul_batched(x, w, mode=mode, fault=fault)
    fidx = (row // bm, col // bn, row % bm, col % bn, 1, -1)
    _, resp, _ = abft_matmul_batched_ref(x, w, fidx, 1e5, mode=mode, bm=bm,
                                         bk=bk, bn=bn, out_dtype=x.dtype)
    need(bool(chk.flag), f"batched K1 missed the fault {name} {mode}")
    flagged = (chk.residual > chk.threshold).reshape(E, -1).any(1)
    need(bool(flagged.all()), f"batched K1 {name} {mode}: the fault "
         f"flagged in {int(flagged.sum())} of {E} experts")
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    flat = int(np.ravel_multi_index(want, tuple(chk.residual.shape[1:])))
    for who, res in (("kernel", chk.residual), ("plain", resp)):
        at = res.nan_to_num(float("inf")).reshape(E, -1).argmax(1)
        need(bool((at == flat).all()), f"batched K1 {who} fault {name} "
             f"{mode}: not at {want} in every expert")


def moe_k1_checks(dev) -> dict:
    """K1 batched over experts against its plain version
    (``abft_matmul_batched_ref``), one launch a call: qwen2-moe-a2.7b's
    expert GEMMs (E = 60; K, N = 2048, 1408 and 1408, 2048) at the
    capacities of a decode step (C = 4), an admission (88) and a ragged
    one (13): bf16 1s and 2s on the tensor cores, replica on the CUDA-core
    tiles, f32 1s on the GEMV (C = 4) and the SIMT pass (13, 88); then
    the scaled-down shapes (E = 8; K, N = 64, 32 and 32, 64; C = 2 and 8),
    whose K of 32 is a ragged TMA box, and an expert stride that is no
    16-byte multiple (the tiles).  A value fault is flagged in every
    expert at its block and row.

    Tolerances as ``k1_checks``: y within 2^-7 x max|y| in bf16 (one
    rounding of either side), 1e-4 x max|y| in f32 (sums in another
    order); bounds within 1e-4 relative; clean residuals under the
    threshold on both sides (rounding noise, not comparable element by
    element)."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.kernels import abft_matmul
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, plan
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    gen = torch.Generator(device=dev).manual_seed(19)
    ratios, worst, cases, routes_taken = {}, {}, 0, {}

    def case(E, C, k, n, dtype, mode, name, fault=False, odd=False):
        nonlocal cases
        if odd:     # expert e starts 2 e bytes off a 16-byte boundary
            buf = (0.02 * torch.randn(E * (k * n + 1), generator=gen,
                                      device=dev)).to(dtype)
            w = buf.as_strided((E, k, n), (k * n + 1, n, 1))
        else:
            w = (0.02 * torch.randn(E, k, n, generator=gen,
                                    device=dev)).to(dtype)
        x = torch.randn(E, C, k, generator=gen, device=dev).to(dtype)
        bm, bk, bn = _moe_clamp(C, k, n)
        kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=dtype)
        tau_of = (lambda b: ATOL
                  + tolerance_scale(-(-k // bk) * bk) * b)
        yp, resp, bndp = abft_matmul_batched_ref(x, w, **kw)
        l0, b0 = K1.launches, K1B.launches
        y, res, bnd = abft_matmul_kernel(x, w, **kw)
        torch.cuda.synchronize()
        need(K1.launches - l0 == 1 and K1B.launches - b0 == 1,
             f"batched K1 {name}: {K1.launches - l0} launches for one call")
        need(res.shape == resp.shape and y.shape == yp.shape,
             f"batched K1 {name}: shapes {tuple(res.shape)}")
        scale = yp.float().abs().max().item()
        tol = (1e-4 if dtype == torch.float32 else 2 ** -7) * scale
        err = (y.float() - yp.float()).abs().max().item()
        tag = f"{name} E={E} C={C} K={k} N={n} {str(dtype)[6:]} {mode}"
        need(err <= tol, f"batched K1 y {tag}: err {err} > {tol}")
        berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max()
        need(berr.item() <= 1e-4, f"batched K1 bnd {tag}: {berr.item()}")
        r = ("tiled" if odd else plan(x[0], w[0], mode=mode, bm=bm, bk=bk,
                                      bn=bn, experts=E).route)
        key = f"{r}_{str(dtype)[6:]}_{mode}"
        ratios[key] = max(ratios.get(key, 0.0),
                          (res / tau_of(bnd)).max().item(),
                          (resp / tau_of(bndp)).max().item())
        worst[key] = max(worst.get(key, 0.0), err)
        routes_taken[tag] = r
        cases += 1
        if fault:
            _moe_fault_check(x, w, mode, name)

    for name, (k, n) in MOE_SHAPES.items():
        for C in (*MOE_C, 13):
            for mode in ("1s", "2s"):
                case(MOE_E, C, k, n, torch.bfloat16, mode, name,
                     fault=C != 13)
            case(MOE_E, C, k, n, torch.float32, "1s", name, fault=C == 4)
        case(MOE_E, 4, k, n, torch.bfloat16, "replica", name, fault=True)
    for (k, n), name in (((64, 32), "small_up"), ((32, 64), "small_down")):
        for C in (2, 8):
            for dtype in (torch.bfloat16, torch.float32):
                case(8, C, k, n, dtype, "1s", name, fault=True)
        case(8, 8, k, n, torch.bfloat16, "1s", f"{name}_odd_stride",
             odd=True)
    need(all(v < 1 for v in ratios.values()),
         f"batched K1 clean residual at or over its threshold: {ratios}")
    return {"cases": cases, "max_abs_err_y": worst,
            "worst_clean_residual_over_threshold": ratios,
            "routes": sorted(set(routes_taken.values()))}


def moe_k1_timing(dev, params) -> dict:
    """One MoE layer's expert GEMMs (layer 0: up and gate at K, N = 2048,
    1408, down at 1408, 2048; E = 60) at each capacity of ``MOE_C``, bf16
    mode 1s, by CUDA-graph replay: K1 batched (3 launches), its plain
    version, ``torch.bmm`` and the bound (each input read and each output
    written once, the residual and bound arrays included; 2 E C K N FLOP
    at the bf16 tensor-core rate)."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    ffn = params["layers"][0]["ffn"]
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for C in MOE_C:
        calls = []
        b_ms, by = 0.0, set()
        for wname in ("w_up", "w_gate", "w_down"):
            w = ffn[wname]
            E, k, n = w.shape
            x = torch.randn(E, C, k, generator=gen, device=dev).to(w.dtype)
            bm, bk, bn = _moe_clamp(C, k, n)
            calls.append((x, w, dict(mode="1s", bm=bm, bk=bk, bn=bn,
                                     out_dtype=w.dtype)))
            t, b = _gemm_bound(C, k, n, 2, 2,
                               -(-C // bm) * -(-n // bn) * bm)
            b_ms += E * t
            by.add(b)

        def kern():
            for x, w, kw in calls:
                abft_matmul_kernel(x, w, **kw)

        def plain():
            for x, w, kw in calls:
                abft_matmul_batched_ref(x, w, **kw)

        def lib():
            for x, w, _ in calls:
                torch.bmm(x, w)

        out[f"experts_c{C}"] = {
            "C": C, "gemms": 3, "launches": 3,
            "ms": timed_graph(kern, iters=10),
            "ms_eager": timed(kern, iters=10),
            "plain_ms": timed_graph(plain, iters=3),
            "library_ms": timed_graph(lib, iters=10),
            "bound_ms": b_ms,
            "bound_by": by.pop() if len(by) == 1 else "mixed"}
    emit("moe_k1_timing", **out)
    return out


@contextlib.contextmanager
def _routing_log():
    """Records each MoE layer's top-k expert ids, sorted within a token,
    while the block is open (wraps ``moe.top_k``; one entry a layer)."""
    from repro_torch.models import moe as moe_mod

    top_k, log = moe_mod.top_k, []

    def logged(probs, k):
        vals, idx = top_k(probs, k)
        log.append(idx.sort(-1).values)
        return vals, idx

    moe_mod.top_k = logged
    try:
        yield log
    finally:
        moe_mod.top_k = top_k


def _routing_diff(a, b, pos_err, L) -> dict:
    """Two runs' routing logs (one (T, K) entry a layer, T = 1 x L) and one
    run's per-position logit error: the share of tokens whose top-k set
    differs in each layer, the positions routed alike in every layer and
    the error there, and the error before the first position whose
    routing differs in any layer (attention carries a difference only
    forward, so those positions saw the same experts at every step)."""
    differ = torch.stack([(x != y).any(-1) for x, y in zip(a, b)])
    alike = ~differ.any(0)
    first = int(differ.any(0).float().argmax().item()) \
        if bool(differ.any()) else L
    err = pos_err.reshape(-1)
    return {"differs_share_per_layer": differ.float().mean(1).tolist(),
            "positions_routed_alike": int(alike.sum().item()),
            "max_abs_err_routed_alike": (err[alike].max().item()
                                         if bool(alike.any()) else None),
            "max_abs_err_routed_apart": (err[~alike].max().item()
                                         if not bool(alike.all()) else None),
            "first_position_routed_apart": first,
            "max_abs_err_before_it": (err[:first].max().item()
                                      if first else None)}


def moe_score(dev, model, params) -> dict:
    """``Model.forward`` at 1 x 1024 under ``IntensityGuidedPolicy`` with
    K2 on: logits finite and of the expected shape, no flag, K2 once a
    layer, K1 batched three times a MoE layer, and the load-balance loss
    (recorded, a sum over the layers); the chunked path beside it, and
    both against the same weights run in f32 layer by layer (the head in
    column chunks): errors and argmax agreement recorded (a router near a
    tie may send a token elsewhere on another path, and the token's later
    positions with it).  The routing of each path is logged and held
    against the f32 run's (``_routing_diff``): the error at positions
    routed alike separates arithmetic from routing, and there too the
    flash path's error is at most 1.5 x the chunked path's."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import LayerCtx

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    K2 = flash_attention.FULL_KERNEL
    cfg = model.cfg
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(SCORE_B, SCORE_L)).astype(np.int64)).to(dev)

    def run(flash):
        ctx = LayerCtx(abft=ABFTConfig.from_policy(
            IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
            flash_attention=flash))
        torch.cuda.synchronize()
        K1.launches = K1B.launches = K2.launches = 0     # THIS run's
        t = time.perf_counter()
        with torch.no_grad(), _routing_log() as routes:
            out = model.forward(params, {"tokens": tokens}, ctx, device=dev)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t), {
            "abft_matmul": K1.launches, "abft_matmul_batched": K1B.launches,
            "flash_attention": K2.launches}, routes

    flash, ms, launches, routes_f = run(True)
    chunked, ms_chunked, _, routes_c = run(False)
    lf = flash.logits
    need(lf.shape == (SCORE_B, SCORE_L, cfg.vocab_size)
         and lf.dtype == torch.float32, f"moe logits {tuple(lf.shape)}")
    need(bool(torch.isfinite(lf).all()), "moe: non-finite logits")
    need(not bool(flash.flag) and not bool(chunked.flag),
         "moe: clean forward raised a flag")
    need(launches["flash_attention"] == cfg.n_layers,
         f"moe: K2 launched {launches['flash_attention']} times")
    need(launches["abft_matmul_batched"] == 3 * cfg.n_layers,
         f"moe: batched K1 launched {launches['abft_matmul_batched']} "
         f"times, expected {3 * cfg.n_layers}")
    aux = float(flash.aux_loss)
    need(np.isfinite(aux), "moe: aux loss not finite")
    lc = chunked.logits
    with torch.no_grad():
        with _routing_log() as routes_32:
            h32 = _forward_f32_layerwise(model, params, tokens)
        head = params["lm_head"]
        pos_f = torch.zeros(lf.shape[:2], device=dev)
        pos_c = torch.zeros(lf.shape[:2], device=dev)
        best32 = torch.full(lf.shape[:2], -float("inf"), device=dev)
        arg32 = torch.zeros(lf.shape[:2], dtype=torch.long, device=dev)
        for c0 in range(0, cfg.vocab_size, 16384):
            c1 = min(c0 + 16384, cfg.vocab_size)
            l32 = h32 @ head[:, c0:c1].float()
            pos_f = torch.maximum(pos_f, (lf[..., c0:c1] - l32).abs()
                                  .amax(-1))
            pos_c = torch.maximum(pos_c, (lc[..., c0:c1] - l32).abs()
                                  .amax(-1))
            m, a = l32.max(-1)
            take = m > best32
            best32 = torch.where(take, m, best32)
            arg32 = torch.where(take, a + c0, arg32)
        del h32, l32
    err_f, err_c = pos_f.max().item(), pos_c.max().item()
    need(err_f <= 1.5 * err_c, f"moe: flash vs f32 err {err_f} > 1.5 x "
         f"the chunked path's {err_c}")
    need(len(routes_f) == len(routes_c) == len(routes_32) == cfg.n_layers,
         f"moe: routing logged for {len(routes_f)}, {len(routes_c)}, "
         f"{len(routes_32)} layers")
    routing = {"flash_vs_f32": _routing_diff(routes_f, routes_32, pos_f,
                                             SCORE_L),
               "chunked_vs_f32": _routing_diff(routes_c, routes_32, pos_c,
                                               SCORE_L),
               "flash_vs_chunked": _routing_diff(
                   routes_f, routes_c, (lf - lc).abs().amax(-1), SCORE_L)}
    alike_f = routing["flash_vs_f32"]["max_abs_err_routed_alike"]
    alike_c = routing["chunked_vs_f32"]["max_abs_err_routed_alike"]
    need(alike_f is not None and alike_c is not None
         and alike_f <= 1.5 * alike_c,
         f"moe: at positions routed as the f32 run routes them, flash vs "
         f"f32 err {alike_f} > 1.5 x the chunked path's {alike_c}")
    rec = dict(B=SCORE_B, L=SCORE_L, launches=launches, ms=ms,
               chunked_ms=ms_chunked, aux_loss=aux,
               aux_loss_per_layer=aux / cfg.n_layers,
               logits_max_abs_err_flash_vs_f32=err_f,
               logits_max_abs_err_chunked_vs_f32=err_c,
               argmax_agreement_flash_vs_f32=(
                   lf.argmax(-1) == arg32).float().mean().item(),
               argmax_agreement_chunked_vs_f32=(
                   lc.argmax(-1) == arg32).float().mean().item(),
               argmax_agreement_flash_vs_chunked=(
                   lf.argmax(-1) == chunked.logits.argmax(-1)).float()
               .mean().item(),
               logits_max_abs_diff_flash_vs_chunked=(
                   lf - chunked.logits).abs().max().item(),
               logits_scale=lf.abs().max().item(), routing=routing)
    del flash, chunked, lf, lc
    emit("moe_score", **rec)
    return rec


def moe_runs(dev) -> dict:
    """qwen2-moe-a2.7b at full width (published dims, all 24 layers; bf16
    weights from seed 0, made on the card): the batched K1 against its
    plain version, the plan, serving (4 slots, max_len 512, 8 requests of
    16-256 tokens, 16 new each, flash on: dense and paged streams equal,
    no clean flag, K1 batched three times a MoE layer each decode step,
    an ``expert_up`` and a ``router`` fault each flagged and recomputed
    to the clean streams, a ``global`` run), the decode step's profile,
    the score at 1 x 1024 and the expert GEMMs' times.  Before serving,
    every 2-D K1 site (attention, router, shared experts, head) and K2 at
    its heads are held against their plain versions at full width
    (``family_checks``), and K3 on the dense engine's cache layer by layer
    (``k3_timing``).  Frees its weights before it returns."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.schemes import Scheme
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model, layer_tags

    t0 = time.perf_counter()
    checks = moe_k1_checks(dev)
    emit("moe_k1_check", **checks)
    cfg = get_config(MOE_ARCH)
    model = Model(cfg)
    n_moe = sum(t == "attn:moe:0" for t in layer_tags(cfg))
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params, prompts = engine_inputs(dev, MOE_ARCH)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    emit("moe_plan", arch=MOE_ARCH, init_s=time.perf_counter() - t1,
         weights_gb=weights / 1e9, moe_layers=n_moe, **family_plan(cfg))
    fchecks = family_checks(dev, cfg, params)
    emit("moe_family_check", arch=MOE_ARCH, **fchecks)

    def serve(cache_kind, policy=None, fault_at=None, label="", reqs=None,
              new=16):
        return engine_serve(model, params, prompts if reqs is None else reqs,
                            dev, cache_kind, policy or IntensityGuidedPolicy(),
                            fault_at=fault_at, label=f"{MOE_ARCH} {label}",
                            phase="moe_engine", max_new_tokens=new)

    serve("dense", label="warmup", reqs=prompts[:1], new=2)
    free_memory()
    dense, rec_dense, eng = serve("dense", label="dense")
    prof = decode_profile(dev, {"engine": eng, "params": params,
                                "prompts": prompts, "dense": rec_dense})
    emit("moe_decode_profile", **prof)
    t3 = k3_timing(dev, eng, prompts, long_context=False)
    del eng
    free_memory()
    paged, rec_paged, _ = serve("paged", label="paged")
    free_memory()
    for rec in (rec_dense, rec_paged):
        need(rec["launches"]["abft_matmul"] > 0
             and rec["launches"]["flash_decode"] > 0,
             f"moe {rec['label']}: K1 or K3 never launched")
        need(rec["batched_launches_per_step"] == {
            str(3 * n_moe): rec["decode_steps"]},
             f"moe {rec['label']}: batched K1 launches a decode step "
             f"{rec['batched_launches_per_step']}, expected {3 * n_moe}")
        need(rec["faults_detected"] == 0, f"moe {rec['label']}: a clean "
             f"run raised a flag")
    need(paged == dense, "moe: paged streams differ from dense")
    faults = {}
    for site in ("expert_up", "router"):
        fault = ModelFault.at(1, site, FaultSpec.value(0, 1, 1e5))
        faulted, rec_fault, _ = serve("dense", fault_at=(3, fault),
                                      label=f"dense_{site}_fault")
        free_memory()
        need(rec_fault["faults_detected"] >= 1
             and rec_fault["retries"] >= 1,
             f"moe: {site} fault not detected and retried")
        need(faulted == dense, f"moe: the {site} fault run's streams "
             f"differ from the clean run")
        faults[site] = dict(faults_detected=rec_fault["faults_detected"],
                            retries=rec_fault["retries"])
    glob, rec_glob, _ = serve("dense", FixedPolicy(Scheme.GLOBAL),
                              label="dense_global")
    free_memory()
    need(rec_glob["faults_detected"] == 0, "moe: global scheme false flag")
    need(rec_glob["launches"]["abft_matmul"] == 0,
         "moe: the global run launched K1")
    score = moe_score(dev, model, params)
    free_memory()
    timing = moe_k1_timing(dev, params)
    t2 = k2_timing(dev, (SCORE_B, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim), SCORE_L, arch=MOE_ARCH)
    peak = torch.cuda.max_memory_allocated()
    del params
    free_memory()
    agree_g = float(np.mean([a == b for k in dense
                             for a, b in zip(dense[k], glob[k])]))
    rec = dict(
        arch=MOE_ARCH, layers=cfg.n_layers, experts=cfg.n_experts,
        top_k=cfg.experts_per_token, weights_gb=weights / 1e9,
        decode_bound_ms=weights / HBM_BW * 1e3,
        tokens_per_s=rec_dense["tokens_per_s"],
        paged_tokens_per_s=rec_paged["tokens_per_s"],
        decode_step_ms_median=rec_dense["decode_step_ms_median"],
        paged_decode_step_ms_median=rec_paged["decode_step_ms_median"],
        prefill_ms_per_admission=rec_dense["prefill_ms"],
        launches=rec_dense["launches"],
        paged_launches=rec_paged["launches"],
        batched_launches_per_step=rec_dense["batched_launches_per_step"],
        dense_equals_paged=True, faults_recomputed=faults,
        global_tokens_per_s=rec_glob["tokens_per_s"],
        global_decode_step_ms_median=rec_glob["decode_step_ms_median"],
        dense_vs_global_tokens=agree_g,
        schemes=sorted({e.split(":")[1]
                        for e in rec_dense["selection_trace"]}),
        decode_device_ms=prof["device_ms_per_step"],
        decode_idle_share=prof["idle_share"],
        score=score, peak_memory_gb=peak / 1e9,
        seconds=time.perf_counter() - t0)
    emit("moe", **rec)
    return {"rec": rec, "checks": checks, "timing": timing,
            "family_checks": fchecks, "k2": t2, "k3": t3}


def _add_moe(kernels, moe) -> None:
    """K1's line gets ``moe``: its launches (all, and batched over
    experts) on the dense MoE serving run, the worst errors of the batched
    checks and of the 2-D sites' checks at full width, and the expert
    GEMMs' times at C = 4 and 88; K2's and K3's lines get ``by_arch``
    rows for the MoE arch: launches on the score and the serving run,
    times, bound and error at its shapes."""
    rec = moe["rec"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        if entry["name"] == "abft_matmul":
            entry["moe"] = {
                "launches": rec["launches"]["abft_matmul"],
                "batched_launches": rec["launches"]["abft_matmul_batched"],
                "batched_launches_per_step":
                    rec["batched_launches_per_step"],
                "max_abs_err": max(moe["checks"]["max_abs_err_y"].values()),
                "sites_max_abs_err":
                    moe["family_checks"]["k1_max_abs_err"],
                "by_shape": {name: {"launches": t["launches"],
                                    **{k: t[k] for k in keys}}
                             for name, t in moe["timing"].items()}}
            continue
        if entry["name"] == "flash_attention":
            t, n = moe["k2"], rec["score"]["launches"]["flash_attention"]
        else:
            t, n = moe["k3"], rec["launches"]["flash_decode"]
        entry.setdefault("by_arch", {})[MOE_ARCH] = {
            "launches": n, "max_abs_err": t["max_abs_err"],
            **{k: t[k] for k in keys}}


# ------------------------------------------------------------------ timing

def _gemm_bound(m, k, n, in_bytes, out_bytes, gm_gn_rows):
    byts = m * k * in_bytes + k * n * in_bytes + m * n * out_bytes \
        + 2 * 4 * gm_gn_rows
    flops = 2.0 * m * k * n
    peak = PEAK_BF16 if in_bytes == 2 else PEAK_F32
    t_b, t_f = byts / HBM_BW, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def k1_timing(dev, params, m: int, arch: str = ENGINE_ARCH,
              one_slice: bool = False,
              split_rows: int | None = None) -> dict:
    """K1 over one step's GEMMs at M=m, using a run's own weights
    (distinct per layer, so weights come from HBM as in a real step), in
    their dtype: kernel, plain version, torch.matmul, and the bound (bf16
    at the tensor-core rate, f32 at the CUDA-core rate).  ``ms`` etc. are
    device times (CUDA-graph replay); ``ms_eager`` includes the host
    launch overhead of the eager loop.  The numbers behind two route
    choices (``fork``): at decode (bf16, M <= 8) the row-major GEMMs,
    which take the tensor-core pass 1, are also timed on the GEMV pass 1
    forced in their place; in f32 above 8 rows (the train step) every
    GEMM, which takes the SIMT pass 1, also on the CUDA-core tiles.
    ``one_slice``: the kernel runs one K slice at any M, as the serving
    prefill paths run it, and no fork is timed; ``split_rows``: the K
    split is that row count's, as the speculative verify step runs it
    (``abft_matmul.plan``), and no fork is timed."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref

    layers = params["layers"]
    groups = {
        "q": [l["mixer"]["wq"] for l in layers],
        "kv": [l["mixer"][w] for l in layers for w in ("wk", "wv")],
        "o": [l["mixer"]["wo"] for l in layers],
        "up_gate": [l["ffn"][w] for l in layers for w in ("up", "gate")],
        "down": [l["ffn"]["down"] for l in layers],
        "head": [params["lm_head"] if "lm_head" in params
                 else params["embed"].t()],
    }
    gen = torch.Generator(device=dev).manual_seed(4)
    per = {}
    tot = {"ms": 0.0, "ms_eager": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "gemms": 0}
    bound_by = set()
    dtype = params["embed"].dtype
    bf16 = dtype == torch.bfloat16
    forced = "gemv" if bf16 and m <= 8 else ("tiled" if not bf16 and m > 8
                                             else None)
    if one_slice or split_rows is not None:
        forced = None
    fork = {"route": "tc" if bf16 else "simt", "forced": forced,
            "gemms": 0, "ms": 0.0, "forced_ms": 0.0}
    for name, ws in groups.items():
        k, n = ws[0].shape
        out_dtype = torch.float32 if name == "head" else dtype
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                      ((256, m), (512, k), (256, n)))
        kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)

        def kern():
            for w in ws:
                abft_matmul_kernel(x, w, **kw, one_slice=one_slice,
                                   split_rows=split_rows)

        def plain():
            for w in ws:
                abft_matmul_ref(x, w, **kw)

        def lib():
            for w in ws:
                torch.matmul(x, w)

        rows = -(-m // bm) * -(-n // bn) * bm
        b_ms, by = _gemm_bound(m, k, n, dtype.itemsize, out_dtype.itemsize,
                               rows)
        rec = {"gemms": len(ws), "m": m, "k": k, "n": n,
               "ms": timed_graph(kern, iters=5),
               "ms_eager": timed(kern, iters=5),
               "plain_ms": timed_graph(plain, iters=2),
               "library_ms": timed_graph(lib, iters=5),
               "bound_ms": b_ms * len(ws), "bound_by": by}
        if forced and not (forced == "gemv" and name == "head"):
            def kern_forced():
                for w in ws:
                    abft_matmul_kernel(x, w, **kw, force=forced)

            rec[f"{forced}_ms"] = timed_graph(kern_forced, iters=5)
            fork["gemms"] += len(ws)
            fork["ms"] += rec["ms"]
            fork["forced_ms"] += rec[f"{forced}_ms"]
        per[name] = rec
        bound_by.add(by)
        for key in ("ms", "ms_eager", "plain_ms", "library_ms",
                    "bound_ms"):
            tot[key] += rec[key]
        tot["gemms"] += len(ws)
    tot["bound_by"] = "bytes" if bound_by == {"bytes"} else (
        "operations" if bound_by == {"operations"} else "mixed")
    emit("k1_timing", arch=arch, m=m, dtype=str(dtype)[6:],
         one_slice=one_slice, split_rows=split_rows, per_shape=per,
         step_total=tot, **({"fork": fork} if fork["gemms"] else {}))
    return tot


def k3_timing(dev, eng, prompts, long_context: bool = True) -> dict:
    """K3 over one decode step's layers at the lengths of the first
    four requests' last decode step: on the engine's dense cache (the
    128-key block) and on paged pools of 16-key blocks holding the same
    keys through a permuted table (the paged engine's layout, W = 32).
    Each at the ``decode_splits`` count and at ``splits=1`` (one CTA a
    row and kv head), against the plain version,
    ``scaled_dot_product_attention`` (GQA, length mask) and the bound:
    the valid keys' K and V bytes, q, o and the check vectors once; QK and
    PV over the valid keys at the bf16 tensor-core rate.  Every layer's
    launch at the chosen count is held against the plain version (o
    within 2^-7 x max|o|, bounds within 1e-4 relative).  Then, with
    ``long_context``, one layer at 8192 keys (B = 1 and 4), chosen count
    against ``splits=1`` and SDPA: the traffic the split merge is for."""
    from repro_torch.kernels.flash_attention import (
        decode_splits,
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
    dense_block, BS = min(128, -(-S // 8) * 8), 16
    Wp = -(-S // BS)
    perm = torch.randperm(B * Wp, generator=gen, device=dev)
    table = perm.reshape(B, Wp).to(torch.int32).contiguous()
    pools = []                      # the same keys, paged
    for c in caches:
        pk = torch.empty(B * Wp, BS, KV, D, dtype=c["k"].dtype, device=dev)
        pv = torch.empty_like(pk)
        pk[table.long()] = c["k"][:, :Wp * BS].reshape(B, Wp, BS, KV, D)
        pv[table.long()] = c["v"][:, :Wp * BS].reshape(B, Wp, BS, KV, D)
        pools.append((pk, pv))
    layouts = {"dense": ([(c["k"], c["v"]) for c in caches], None,
                         dense_block, -(-S // dense_block)),
               "paged": (pools, table, BS, Wp)}

    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)

    def lib():
        for c in caches:
            torch.nn.functional.scaled_dot_product_attention(
                qt, c["k"].transpose(1, 2), c["v"].transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

    valid = int(lengths.sum().item())
    byts = len(caches) * (2 * valid * KV * D * 2 + 2 * B * H * D * 2
                          + 4 * B * H * 4 + B * 4)
    flops = len(caches) * 4.0 * valid * H * D
    t_b, t_f = byts / HBM_BW, flops / PEAK_BF16
    library_ms = timed_graph(lib, iters=10)
    rec = {"arch": cfg.name, "launches_timed": len(caches), "B": B, "S": S,
           "lengths": lengths.tolist(), "library_ms": library_ms,
           "bound_ms": max(t_b, t_f) * 1e3,
           "bound_by": "bytes" if t_b >= t_f else "operations"}
    for kind, (kv, tb, block, width) in layouts.items():
        chosen = decode_splits(B, KV, width, block)

        def kern(splits=None):
            for kc, vc in kv:
                flash_decode_kernel(q, kc, vc, tb, lengths, block=block,
                                    splits=splits)

        def plain():
            for kc, vc in kv:
                flash_decode_ref(q, kc, vc, tb, lengths, block=block)

        worst = 0.0
        for li, (kc, vc) in enumerate(kv):
            got = flash_decode_kernel(q, kc, vc, tb, lengths, block=block)
            ref = flash_decode_ref(q, kc, vc, tb, lengths, block=block)
            worst = max(worst, _k3_close(
                got, ref, 2 ** -7, f"timing {kind} layer {li} "
                f"splits={chosen}"))
        rec[kind] = {
            "block": block, "W": width, "splits": chosen,
            "ms": timed_graph(kern, iters=20),
            "ms_splits_1": timed_graph(lambda: kern(1), iters=20),
            "ms_eager": timed(kern, iters=10),
            "plain_ms": timed_graph(plain, iters=2),
            "max_abs_err": worst}
    for key in ("ms", "plain_ms", "max_abs_err"):
        rec[key] = rec["dense"][key]
    del pools
    if long_context:
        rec["long_context"] = _k3_long_context(dev, H, KV, D)
    emit("k3_timing", **rec)
    return rec


def _k3_long_context(dev, H, KV, D, S=8192) -> dict:
    """One layer's K3 launch at ``S`` keys a row, full lengths, B = 1 and
    4, on a dense cache (128-key blocks) and 16-key pools: the chosen
    split count against ``splits=1`` and SDPA, each held against the
    plain version first."""
    from repro_torch.kernels.flash_attention import (
        decode_splits,
        flash_decode_kernel,
        flash_decode_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for B in (1, 4):
        q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(
            torch.bfloat16)
        kd, vd = (torch.randn(B, S, KV, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        W = S // 16
        table = torch.randperm(B * W, generator=gen, device=dev).reshape(
            B, W).to(torch.int32).contiguous()
        kp = torch.empty(B * W, 16, KV, D, dtype=kd.dtype, device=dev)
        vp = torch.empty_like(kp)
        kp[table.long()] = kd.reshape(B, W, 16, KV, D)
        vp[table.long()] = vd.reshape(B, W, 16, KV, D)
        qt = q.transpose(1, 2)
        sdpa = timed_graph(lambda: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kd.transpose(1, 2), vd.transpose(1, 2),
                               enable_gqa=True), iters=20)
        for kind, (kc, vc, tb, block) in (("dense", (kd, vd, None, 128)),
                                          ("paged", (kp, vp, table, 16))):
            width = S // block
            chosen = decode_splits(B, KV, width, block, H // KV)
            got = flash_decode_kernel(q, kc, vc, tb, lengths, block=block)
            ref = flash_decode_ref(q, kc, vc, tb, lengths, block=block)
            _k3_close(got, ref, 2 ** -7, f"long context B={B} {kind}")
            out[f"B{B}_{kind}"] = {
                "keys": S, "splits": chosen,
                "ms": timed_graph(lambda: flash_decode_kernel(
                    q, kc, vc, tb, lengths, block=block), iters=20),
                "ms_splits_1": timed_graph(lambda: flash_decode_kernel(
                    q, kc, vc, tb, lengths, block=block, splits=1),
                    iters=20),
                "library_ms": sdpa,
                "bound_ms": 2 * B * S * KV * D * 2 / HBM_BW * 1e3}
    return out


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


def _add_sharing(kernels, share) -> None:
    """K1's line gets the chunk shape (M = 256, one K slice) with the
    launches of the chunked paged run; K1's and K3's lines get their
    launches on every run of the ``sharing`` phase."""
    runs = share["llama"]["launches"]
    fam = share["qwen"]["launches"]
    for entry in kernels:
        key = {"abft_matmul": "abft_matmul",
               "flash_decode": "flash_decode"}.get(entry["name"])
        if key is None:
            continue
        entry["sharing_launches"] = {
            **{k: v[key] for k, v in runs.items()},
            **{f"{SIDE_ARCH} ({SIDE_LAYERS} layers) {k}": v[key]
               for k, v in fam.items()}}
        if key == "abft_matmul":
            t = share["llama"]["k1_chunk"]
            entry["by_shape"]["chunk_m256"] = {
                "launches": runs["prefix_chunk256_paged"][key],
                **{k: t["one_slice"][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "split_ms": t["split"]["ms"]}


def _add_spec(kernels, spec) -> None:
    """Each kernel's line gets ``spec_launches``, its launches on every
    run of the ``spec`` phase (K2 and K3: 0, flash is off, each counted
    and held to 0); K1's gets the verify step's shape (4 slots x (K+1) =
    36 rows, the decode split) with K1's launches inside the verify calls
    of 36 rows in the copy-traffic oracle K=8 run."""
    runs = spec["llama"]["launches"]
    fam = spec["qwen"]["launches"]
    for entry in kernels:
        key = entry["name"]
        entry["spec_launches"] = {
            **{k: v[key] for k, v in runs.items()},
            **{f"{SIDE_ARCH} ({SIDE_LAYERS} layers) {k}": v[key]
               for k, v in fam.items()}}
        if key == "abft_matmul":
            t = spec["llama"]["k1_verify_m36"]
            entry["by_shape"]["verify_m36"] = {
                "launches": spec["llama"]["k1_verify_m36_launches"],
                **{k: t[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}


def _add_family(kernels, fam) -> None:
    """Each kernel's line gets ``by_arch``: its launches on that arch's
    main path (the dense serving run for K1 and K3, the score for K2) and
    its times, bound and error at that arch's shapes."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        entry["by_arch"] = {}
        for arch, f in fam.items():
            rec = f["rec"]
            if entry["name"] == "abft_matmul":
                row = {"launches": rec["launches"]["abft_matmul"],
                       "max_abs_err": f["checks"]["k1_max_abs_err"],
                       "one_slice_max_abs_err":
                           f["checks"]["k1_one_slice_max_abs_err"],
                       **{k: f["k1"][k] for k in keys}}
            elif entry["name"] == "flash_attention":
                row = {"launches": rec["score"]["launches"]
                       ["flash_attention"],
                       "max_abs_err": f["k2"]["max_abs_err"],
                       **{k: f["k2"][k] for k in keys}}
            else:
                row = {"launches": rec["launches"]["flash_decode"],
                       "max_abs_err": f["k3"]["max_abs_err"],
                       **{k: f["k3"][k] for k in keys}}
            entry["by_arch"][arch] = row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if "timing" in phases and not {"engine", "forward"} <= phases:
        fail("the timing phase needs the engine and forward phases")
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
    tensor_core = {n: tensor_core_instructions(library.BUILD / f"lib{n}.so")
                   for n in library.SOURCES}
    emit("build", seconds=time.perf_counter() - t, sources=built,
         tensor_core_instructions=tensor_core,
         ptxas={n: [ln.strip() for ln in
                    (library.BUILD / f"{n}.log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln][:6]
                for n in library.SOURCES})
    need(tensor_core["abft_matmul"]["HGMMA"] > 0
         and tensor_core["flash_attention"]["HMMA"] > 0,
         f"tensor-core instructions missing from the SASS: {tensor_core}")
    k1_res = None
    if "k1" in phases:
        k1_res = k1_checks(dev)
        emit("k1_check", **k1_res)
    if "k2" in phases:
        emit("k2_check", **k2_checks(dev))
    if "k3" in phases:
        emit("k3_check", **k3_checks(dev))
    kernels = None
    eng_out = fwd = None
    if "engine" in phases:
        eng_out = engine_runs(dev)
        emit("decode_profile", **decode_profile(dev, eng_out))
    if "campaign" in phases or "profile" in phases:
        if eng_out is not None:
            params, prompts = eng_out["params"], eng_out["prompts"]
            ref_streams = eng_out["streams"]
        else:
            params, prompts = engine_inputs(dev)
            ref_streams = None
        if "campaign" in phases:
            camp = campaign_runs(dev, params, prompts, ref_streams)
            ref_streams = camp["clean"]["results"]
        if "profile" in phases:
            profile_runs(dev, params, prompts, ref_streams)
        del params
    if "forward" in phases:
        fwd = forward_runs(dev)
    train_params = None
    if "train" in phases:
        with tempfile.TemporaryDirectory() as workdir:
            tr = train_runs(dev, workdir)
        train_params = tr["params"]
    if "timing" in phases:
        launches = eng_out["dense"]["launches"]
        t1 = k1_timing(dev, eng_out["params"], 4)
        # the serving prefill runs one K slice; the split plan beside it
        t1_pre = k1_timing(dev, eng_out["params"], 512, one_slice=True)
        t1_pre_split = k1_timing(dev, eng_out["params"], 512)
        t1_fwd = k1_timing(dev, eng_out["params"], FWD_B * FWD_L)
        t3 = k3_timing(dev, eng_out["engine"], eng_out["prompts"])
        t2 = k2_timing(dev)
        t1_train = (k1_timing(dev, train_params, TRAIN_B * TRAIN_L)
                    if train_params is not None else None)
        kernels = [
            {"name": "abft_matmul", "route": "cuda",
             "source": abft_matmul.KERNEL.source,
             "replaces": "src/repro/kernels/abft_matmul.py:188",
             "launches": launches["abft_matmul"],
             "max_abs_err": k1_max_err(dev, eng_out["params"]),
             "one_slice_max_abs_err": (k1_res["one_slice_max_abs_err"]
                                       if k1_res is not None else None),
             "split_rows_max_abs_err": (k1_res["split_rows_max_abs_err"]
                                        if k1_res is not None else None),
             "ms": t1["ms"], "plain_ms": t1["plain_ms"],
             "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
             "library_ms": t1["library_ms"],
             "by_shape": {f"{name}_m{m}": {key: rec[key] for key in (
                 "ms", "plain_ms", "bound_ms", "library_ms")}
                 for name, m, rec in (("decode", 4, t1),
                                      ("prefill", 512, t1_pre),
                                      ("prefill_split", 512, t1_pre_split),
                                      ("forward", FWD_B * FWD_L, t1_fwd),
                                      ("train_f32", TRAIN_B * TRAIN_L,
                                       t1_train)) if rec is not None}},
            {"name": "flash_attention", "route": "cuda",
             "source": flash_attention.FULL_KERNEL.source,
             "replaces": "src/repro/kernels/flash_attention.py:343",
             "launches": fwd["launches"]["flash_attention"],
             "max_abs_err": t2["max_abs_err"],
             "ms": t2["ms"], "plain_ms": t2["plain_ms"],
             "bound_ms": t2["bound_ms"], "bound_by": t2["bound_by"],
             "library_ms": t2["library_ms"]},
            {"name": "flash_decode", "route": "cuda",
             "source": flash_attention.KERNEL.source,
             "replaces": "src/repro/kernels/flash_attention.py:267",
             "launches": launches["flash_decode"],
             "max_abs_err": t3["max_abs_err"],
             "ms": t3["ms"], "plain_ms": t3["plain_ms"],
             "bound_ms": t3["bound_ms"], "bound_by": t3["bound_by"],
             "library_ms": t3["library_ms"],
             "by_layout": {kind: {key: t3[kind][key] for key in (
                 "splits", "ms", "ms_splits_1", "plain_ms")}
                 for kind in ("dense", "paged")}},
        ]
    if "sharing" in phases:
        share = sharing_runs(dev, eng_out["params"]
                             if eng_out is not None else None)
        if kernels is not None:
            _add_sharing(kernels, share)
    if "spec" in phases:
        spec = spec_runs(dev, eng_out["params"]
                         if eng_out is not None else None)
        if kernels is not None:
            _add_spec(kernels, spec)
    if "family" in phases:
        # drop every earlier phase's weights, engines and caches
        eng_out = fwd = train_params = camp = tr = None
        free_memory()
        fam = family_runs(dev)
        if kernels is not None:
            _add_family(kernels, fam)
    if "moe" in phases:
        eng_out = fwd = train_params = camp = tr = fam = None
        free_memory()
        moe = moe_runs(dev)
        if kernels is not None:
            _add_moe(kernels, moe)
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
