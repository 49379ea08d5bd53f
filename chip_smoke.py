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
their paths' shapes.  Each phase prints one JSON line; any failure exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
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
          "campaign", "profile", "timing")
HBM_BW = 3.35e12          # H100 SXM data sheet, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # f32 outside the tensor cores (TF32 off)
# the llama3.2-1b GEMMs (K, N) and token counts K1 is checked at
K1_SHAPES = {"q": (2048, 2048), "kv": (2048, 512), "up": (2048, 8192),
             "down": (8192, 2048), "head": (2048, 128256)}
K1_M = (4, 8, 40, 333, 512, 2048)     # 2048: the forward's B x L rows
K1_FAULT_M = (4, 40, 333, 512, 2048)
ENGINE_ARCH = "llama3.2-1b"
# K2 at llama3.2-1b's attention shapes: (B, H, KV, D)
K2_HEADS = (2, 32, 8, 64)
FWD_B, FWD_L = 2, 1024          # the forward phase's batch
TRAIN_B, TRAIN_L, TRAIN_STEPS = 4, 128, 4


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

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = K1_SHAPES
    worst = 0.0
    cases = 0
    ratios = {}             # route -> worst clean residual / threshold
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
        del ws
    need(all(v < 1 for v in ratios.values()),
         f"K1 clean residual at or over its threshold: {ratios}")
    return {"cases": cases, "max_rel_err_y": worst,
            "worst_clean_residual_over_threshold": ratios,
            "blocks": BlockShape().__dict__}


def _ratio(chk) -> float:
    """Worst clean residual / threshold of a CheckResult (the reference's
    thresholds; a flag is raised at > 1)."""
    return (chk.residual / chk.threshold).max().item()


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


def k2_timing(dev) -> dict:
    """K2 at the forward phase's shapes (B=2, L=1024, llama heads, bf16),
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
    B, H, KV, D = K2_HEADS
    L = FWD_L
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
    rec = {"B": B, "L": L, "H": H, "KV": KV, "D": D,
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

def engine_inputs(dev) -> tuple:
    """Full-width llama3.2-1b weights (bf16, seed 0) on the card and the
    8 prompts of 16-256 tokens every engine run serves."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = get_config(ENGINE_ARCH)
    params = Model(cfg).init_params(0, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, size=8)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    return params, prompts


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
    params, prompts = engine_inputs(dev)

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


# ------------------------------------------------------------------ timing

def _gemm_bound(m, k, n, in_bytes, out_bytes, gm_gn_rows):
    byts = m * k * in_bytes + k * n * in_bytes + m * n * out_bytes \
        + 2 * 4 * gm_gn_rows
    flops = 2.0 * m * k * n
    peak = PEAK_BF16 if in_bytes == 2 else PEAK_F32
    t_b, t_f = byts / HBM_BW, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def k1_timing(dev, params, m: int) -> dict:
    """K1 over one step's GEMMs at M=m, using a run's own weights
    (distinct per layer, so weights come from HBM as in a real step), in
    their dtype: kernel, plain version, torch.matmul, and the bound (bf16
    at the tensor-core rate, f32 at the CUDA-core rate).  ``ms`` etc. are
    device times (CUDA-graph replay); ``ms_eager`` includes the host
    launch overhead of the eager loop.  The numbers behind two route
    choices (``fork``): at decode (bf16, M <= 8) the row-major GEMMs,
    which take the tensor-core pass 1, are also timed on the GEMV pass 1
    forced in their place; in f32 above 8 rows (the train step) every
    GEMM, which takes the SIMT pass 1, also on the CUDA-core tiles."""
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
    dtype = params["embed"].dtype
    bf16 = dtype == torch.bfloat16
    forced = "gemv" if bf16 and m <= 8 else ("tiled" if not bf16 and m > 8
                                             else None)
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
                abft_matmul_kernel(x, w, **kw)

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
    emit("k1_timing", m=m, dtype=str(dtype)[6:], per_shape=per,
         step_total=tot, **({"fork": fork} if fork["gemms"] else {}))
    return tot


def k3_timing(dev, eng, prompts) -> dict:
    """K3 over one decode step's 16 layers at the lengths of the first
    four requests' last decode step: on the engine's dense cache (the
    128-key block) and on paged pools of 16-key blocks holding the same
    keys through a permuted table (the paged engine's layout, W = 32).
    Each at the ``decode_splits`` count and at ``splits=1`` (one CTA a
    row and kv head), against the plain version,
    ``scaled_dot_product_attention`` (GQA, length mask) and the bound:
    the valid keys' K and V bytes, q, o and the check vectors once; QK and
    PV over the valid keys at the bf16 tensor-core rate.  Every layer's
    launch at the chosen count is held against the plain version (o
    within 2^-7 x max|o|, bounds within 1e-4 relative).  Then one layer
    at a long context (8192 keys, B = 1 and 4), chosen count against
    ``splits=1`` and SDPA: the traffic the split merge is for."""
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
    rec = {"launches_timed": len(caches), "B": B, "S": S,
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
    if "k1" in phases:
        emit("k1_check", **k1_checks(dev))
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
        t1_pre = k1_timing(dev, eng_out["params"], 512)
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
             "ms": t1["ms"], "plain_ms": t1["plain_ms"],
             "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
             "library_ms": t1["library_ms"],
             "by_shape": {f"{name}_m{m}": {key: rec[key] for key in (
                 "ms", "plain_ms", "bound_ms", "library_ms")}
                 for name, m, rec in (("decode", 4, t1),
                                      ("prefill", 512, t1_pre),
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
