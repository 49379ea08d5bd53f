"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes its path gives
it, and drives full-width llama3.2-1b (random weights from a seed) three
ways: served through ``repro_torch.serve.engine.ServeEngine`` on the dense
and the paged cache (with a fault-injected run and a ``global``-scheme
run), a full-sequence ``Model.forward`` with the flash attention kernel on
and off, and four f32 training steps through
``repro_torch.train.trainer.Trainer`` (and one bf16 step of the scaled
llama held against the CPU's).  The ``campaign`` phase runs the
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
``family`` serves and scores the rest of the dense family; ``moe``
holds K1 batched over experts against its plain version, then serves,
scores and times full-width qwen2-moe-a2.7b; and ``mla`` does the same
for deepseek-v3-671b at its published widths and 4 layers with its MTP
head (MLA on K1 alone: K2 and K3 held to 0 launches), speculates on it
(every stream that met no expert overflow held to the unsped run's), and
serves the all-dense 3-layer MLA stack cut from its weights under prefix
sharing, chunked prefill and speculation, every greedy stream held to the
plain run's; ``ssm`` serves, faults and scores the Mamba2 family
(mamba2-1.3b whole, jamba-v0.1-52b at its published widths and one
8-layer unit of its interleave), each recovered stream and every slot's
recurrent state held to the clean run's; ``cross`` scores, serves
(model-level prefill and decode with each request's memory, dense and
paged) and faults whisper-tiny whole and llama-3.2-vision-11b at its
published widths and depth, and trains whisper on audio; ``audit``
walks every config's served step at full width inside the phases that
build each model (``repro_torch.analysis``: every GEMM under a registered
ABFT scheme, the H100 plan and the executed sites a bijection, every
kernel launch in the op inventory, a decode step's products against
``models/counting.py``) and holds the scaled-down ``launch/audit.py
--all`` on the card against the CPU's; ``tp`` serves full-width
llama3.2-1b with tensor parallelism over two ranks sharing the card
(``repro_torch.distributed.spawn``, gloo), every rank's streams and
counters equal, dense = paged, faulted = clean, shared + chunked = plain
and oracle-sped = unsped at TP=2, against the one-process run (logits, and a
divergent stream only at a near-tie), K1 at the shard shapes against its
plain version, K1/K3/collectives a decode step a rank, the rank-0 audit;
``tp_hybrid`` does the same for jamba-v0.1-52b at its published widths
and one 8-layer unit (GQA attention, Mamba2 mixers, dense and
expert-parallel MoE FFNs), each rank drawing only its shard, with
``expert_up``, ``ssm_in`` and ``ssm_out`` faults recovered and every
slot's state held to the clean run's; ``tp_mla`` does the same for
deepseek-v3-671b as ``mla`` serves it (MLA's heads split, its latent
replicated, 128 experts a rank, the MTP head), against the TP=1 run the
``mla`` phase keeps on the host, with a ``mla.q_b`` fault on rank 1's
columns and an ``expert_up`` fault recovered, the latent cache held to
the clean run's, the score's ``mtp_logits`` held to TP=1's; and the
``tp`` phase holds llama with its heads padded for TP (40 / 10, K2 and
K3 at the padded heads) against the unpadded model.  ``dp`` serves the
same llama over a (data=2, model=2) mesh of four ranks sharing the card
(each data rank decoding its two of four slots, the logits gathered over
``data``): dense against the TP=1 twin, shared + chunked = paged with a
512-token prefix shared across the data ranks, a decode fault on data
rank 1's row recovered, eviction; a one-slot 2048-token cell whose dense
cache splits its positions over the data ranks (K3 with its
log-sum-exp, the partials merged); and qwen1.5-32b at 2 layers under
FSDP (each rank a quarter of each weight), each against its one-process
twin.  ``dp_train`` trains that llama, f32, over the same mesh (ZeRO-1,
a faulted step retried, a checkpoint restored onto (1, 2)), and
``dp_train_families`` trains mamba2-1.3b, deepseek-v3-671b's first layer
with its MTP head and llama-3.2-vision-11b's first cross layer at their
published widths over (2, 2) and (1, 2) meshes, each against its
one-process twin.  ``pod`` lays a ``pod`` axis out as the reference
does (the batch over pod x data, FSDP, ZeRO-1 and sequence shards over
data): full-width llama at (pod=2, data=1, model=2) served bit-equal to
(2, 2) with a decode fault on pod rank 1 recovered, trained in f32 at
(2, 2, 1) against its twin, and whisper-tiny trained at (1, 4) with its
6 / 6 heads padded to 8 / 8 by default, bit-equal to an explicit
``pad_heads_to``.  ``roofline`` walks full-width llama3.2-1b's 4-slot
decode step and 512-token prefill under the roofline's cost walker
(``repro_torch.roofline``) twice, on the card and on the meta device,
holds the two walks equal op for op and the kernels' records equal to
their launches, sets the predicted terms beside the step's measured
device time and peak memory, and runs the dry run's decode_32k cell at
(16, 16) (``launch/dryrun.py``).
Each phase prints JSON lines; any failure exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k2", "k3", "engine", "forward", "train",
          "campaign", "profile", "timing", "sharing", "spec", "family",
          "moe", "mla", "ssm", "cross", "audit", "tp", "tp_hybrid",
          "tp_mla", "dp", "dp_train", "dp_train_families", "pod",
          "roofline")
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
# and 5 of its 40 layers (its gates hold the paths at another arch's
# widths, which the depth does not change; the run keeps to its time:
# PERF.md §4, each cut with the run that forced it)
SIDE_ARCH, SIDE_LAYERS = "qwen3-14b", 5
# the llama those two phases, tp, dp and the training phases serve: full
# width, 2 of its 16 layers (the same reason; their kernel timings keep
# the full model's GEMMs; PR 29 cut 4 to 2 after a 1301 s run on a slow
# host)
SERVED_LAYERS = 2
# the spec phase keeps llama at 8 and qwen3-14b at 10 layers: at 4
# layers its copy traffic's n-gram proposer drafts nothing, and its gates
# need drafts (measured on one H100)
SPEC_LAYERS, SPEC_SIDE_LAYERS = 8, 10


# the layers the family, moe and ssm phases keep of these archs'
# published depth (full width; PERF.md §4: the script's time, each cut
# with the run that forced it: PR 29 halved them after a 1301 s run on a
# slow host), and the tp phase's llama keeps SERVED_LAYERS
DEPTH_CUTS = {"qwen3-14b": 3, "qwen1.5-32b": 4, "qwen2-moe-a2.7b": 4,
              "mamba2-1.3b": 24}


def side_config(layers: int = SIDE_LAYERS):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SIDE_ARCH), n_layers=layers)


def cut_config(arch):
    """``arch`` at full width and its ``DEPTH_CUTS`` depth, if any."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n = DEPTH_CUTS.get(arch)
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def served_config(layers: int = SERVED_LAYERS):
    """llama3.2-1b at full width and ``layers`` layers (the sharing, tp
    and dp phases' ``SERVED_LAYERS``; the spec phase's ``SPEC_LAYERS``)."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(ENGINE_ARCH), n_layers=layers)


def served_llama(dev, layers: int = SERVED_LAYERS) -> tuple:
    """The sharing and spec phases' llama3.2-1b: full width, ``layers``
    layers, bf16 weights from seed 0 on the card."""
    from repro_torch.models.model import Model

    model = Model(served_config(layers))
    return model, model.init_params(0, dtype=torch.bfloat16, device=dev)


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t``: the script's seconds so far."""
    print(json.dumps({"phase": phase, **kw,
                      "t": round(time.perf_counter() - T0, 1)}), flush=True)


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
              arch: str = ENGINE_ARCH, causal: bool = True) -> dict:
    """K2 at the forward phase's shapes (B=2, L=1024, llama heads, bf16;
    ``heads`` = (B, H, KV, D) and ``L`` for another path's; ``causal``
    off for whisper's encoder), one launch: kernel, plain version,
    ``scaled_dot_product_attention`` (same mask, GQA) and the bound.
    Bytes: q, k, v and o once, and the four (B, H, L) check vectors;
    operations at the bf16 tensor-core rate: S over every (query, key)
    pair, since the score check is taken before the causal mask
    (2 B H L^2 D), and PV over the pairs the mask admits (2 B H D
    L(L+1)/2 causal, as p is exactly 0 on the others; 2 B H L^2 D
    without the mask)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel,
        flash_attention_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, KV, D = heads
    q, k, v = _k2_inputs(gen, dev, B, L, H, KV, D, torch.bfloat16)
    kw = dict(causal=causal, **_k2_blocks(L))
    o = flash_attention_kernel(q, k, v, **kw)[0]
    op = flash_attention_ref(q, k, v, **kw)[0]
    err = (o.float() - op.float()).abs().max().item()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib():
        torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)

    byts = 2 * (2 * B * L * H * D + 2 * B * L * KV * D) + 4 * 4 * B * H * L
    flops = 2.0 * B * H * L * L * D + 2.0 * B * H * D * (
        L * (L + 1) / 2 if causal else L * L)
    t_b, t_f = byts / HBM_BW, flops / PEAK_BF16
    rec = {"arch": arch, "B": B, "L": L, "H": H, "KV": KV, "D": D,
           "causal": causal,
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
    per step count the forward twice (the per-layer recompute) but each
    layer's FFN ``down`` once (it runs outside the recomputed region).
    One bf16 AdamW step of scaled llama3.2-1b (tied head) on the card is
    held against the same step on the CPU (``train_bf16_gate``).

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
    rec["k1_launches_predicted"] = 2 * 7 * cfg.n_layers - cfg.n_layers + 1
    need(per_step == rec["k1_launches_predicted"],
         f"train: K1 launched {per_step} times a step, the layer list "
         f"predicts {rec['k1_launches_predicted']}")
    rec["bf16"] = train_bf16_gate(dev)
    emit("train", **rec)
    out = {"rec": rec, "params": trainer.params}
    del trainer
    return out


# the bf16 train step's bounds against the CPU's (``train_bf16_gate``):
# the two sum bf16 GEMMs' f32 partials in other orders and round
# activations to bf16 (2^-8 relative) at other points
BF16_LOSS_TOL = 1e-2        # relative
BF16_GRAD_NORM_TOL = 2e-2   # relative
# each leaf's gradient, |g_card - g_cpu| / |g_cpu| (norms): bf16 against
# f32 on the CPU differ by at most 0.0066 a leaf at this size; a wrong or
# sign-flipped gradient by 1 or more
BF16_GRAD_TOL = 3e-2


def train_bf16_gate(dev) -> dict:
    """One AdamW step of scaled-down llama3.2-1b (2 layers, tied head) in
    bf16 from seed 5's bf16 params and one batch, on the card (K1) and on
    the CPU (its plain version): each leaf's gradient within
    ``BF16_GRAD_TOL`` of the CPU's (norm-relative), the loss within
    ``BF16_LOSS_TOL`` and the grad norm within ``BF16_GRAD_NORM_TOL``
    relative, every param within 2 lr plus one bf16 step (2^-7 relative)
    of the CPU's (AdamW's first step moves an entry by lr sign(g), and a
    gradient near 0 may take the other sign), no flag, K1 launched."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import abft_matmul
    from repro_torch.launch.train import abft_config
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.serve.executor import tree_to
    from repro_torch.train import (
        OptConfig,
        TrainConfig,
        init_opt_state,
        make_train_step,
    )
    from repro_torch.train.train_step import make_grad_fn

    cfg = scaled_down(get_config(ENGINE_ARCH), n_layers=2)
    need(cfg.tie_embeddings, "the bf16 gate's llama has no tied head")
    model = Model(cfg)
    params = model.init_params(5, dtype=torch.bfloat16)
    batch = SyntheticLM(DataConfig(global_batch=2, seq_len=64,
                                   vocab_size=cfg.vocab_size)).batch(0)
    ocfg = OptConfig(lr=3e-4)
    out = {}
    for d in (torch.device("cpu"), dev):
        p = tree_to(params, d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        _, _, grads = make_grad_fn(model, abft_config("auto"),
                                   TrainConfig(opt=ocfg), device=d)(
            p, b, ModelFault.none())
        step = make_train_step(model, abft_config("auto"),
                               TrainConfig(opt=ocfg), device=d)
        k1 = abft_matmul.KERNEL.launches
        newp, _, met = step(p, init_opt_state(p, ocfg), b)
        out[d.type] = {"loss": float(met["loss"]),
                       "grad_norm": float(met["grad_norm"]),
                       "flag": bool(met["abft_flag"]),
                       "k1": abft_matmul.KERNEL.launches - k1,
                       "grads": [t.float().cpu() for t in tree_leaves(grads)],
                       "params": [t.float().cpu() for t in tree_leaves(newp)]}
    cpu, card = out["cpu"], out["cuda"]
    rec = {"loss": card["loss"], "cpu_loss": cpu["loss"],
           "loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "grad_norm_rel": abs(card["grad_norm"] - cpu["grad_norm"])
           / cpu["grad_norm"], "k1": card["k1"], "worst_grad_rel": 0.0,
           "worst_param_excess": 0.0}
    for a, b in zip(card["grads"], cpu["grads"]):
        rec["worst_grad_rel"] = max(rec["worst_grad_rel"], float(
            (a - b).norm() / b.norm().clamp_min(1e-30)))
    for a, b in zip(card["params"], cpu["params"]):
        bound = 2 * ocfg.lr + 2.0 ** -7 * b.abs()
        rec["worst_param_excess"] = max(rec["worst_param_excess"], float(
            ((a - b).abs() - bound).max()))
    need(np.isfinite(card["loss"]) and not card["flag"] and not cpu["flag"]
         and card["k1"] > 0 and rec["loss_rel"] <= BF16_LOSS_TOL
         and rec["grad_norm_rel"] <= BF16_GRAD_NORM_TOL
         and rec["worst_grad_rel"] <= BF16_GRAD_TOL
         and rec["worst_param_excess"] <= 0.0,
         f"bf16 train step on the card against the CPU: {rec}")
    return rec


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
    also per decode step), K2 and K3 counted from 0 for this run.  Emits
    the run's line under ``phase``; returns (streams, record, engine)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import Request, ServeEngine

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    K1B, K2 = abft_matmul.BATCHED, flash_attention.FULL_KERNEL
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
    K1.launches = K3.launches = K1B.launches = K2.launches = 0  # this run
    t0 = time.perf_counter()
    results = eng.run(reqs, fault_at=fault_at)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del eng.admit, eng.step         # the timers close a cycle through eng
    launches = {"abft_matmul": K1.launches, "flash_decode": K3.launches,
                "abft_matmul_batched": K1B.launches,
                "flash_attention": K2.launches}
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
    audit_engine(dev, model, params, prompts)
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
    ``torch.profiler`` (``_profile_steps``), against the unprofiled
    median decode step of the main run."""
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

    def step():
        need(eng.step(), "profiled decode step decoded nothing")

    return _profile_steps(step, steps,
                          eng_out["dense"]["decode_step_ms_median"])


def _profile_steps(step, steps: int, step_ms: float) -> dict:
    """``step()`` once, then ``steps`` more calls under ``torch.profiler``.
    Device ms per step is the sum of the kernels' device time (one stream:
    no overlap).  The profiler slows the host, so the idle share is taken
    against the unprofiled median step ``step_ms``: 1 - device / that
    median."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_name = sorted(((e.key, e.device_time_total / 1e3 / steps,
                       e.count / steps) for e in kernels),
                     key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in by_name)
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


def emit_memory(where: str) -> None:
    """This process's allocated and reserved device memory and the card's
    free memory, after ``free_memory``: what a later phase's ranks find."""
    free_memory()
    free, total = torch.cuda.mem_get_info()
    emit("memory", where=where,
         allocated_gb=torch.cuda.memory_allocated() / 1e9,
         reserved_gb=torch.cuda.memory_reserved() / 1e9,
         card_free_gb=free / 1e9, card_total_gb=total / 1e9)


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
    """The 2-D GEMM sites of the first layer of each kind (attention
    mixer, Mamba2 mixer, dense FFN, MoE FFN), the head and the MTP head:
    name -> (weight, output dtype).  A GQA mixer gives ``q``, ``kv`` and
    ``o``; an MLA mixer ``q_a``, ``q_b``, ``kv_a`` and ``o``; a Mamba2
    mixer ``ssm_in_z``, ``ssm_in_x``, ``ssm_in_bc``, ``ssm_in_dt`` and
    ``ssm_out``.  A dense FFN gives ``up`` and ``down``; an MoE FFN gives
    the router (N = E, f32 out) and the shared experts' ``shared_up`` and
    ``shared_down`` (its expert GEMMs are ``moe_k1_checks``',
    ``mla_k1_checks``' and ``ssm_batched_checks``').  ``mtp_proj``: the
    MTP head's projection (K = 2 d_model)."""
    layers = params["layers"]
    bf, f32 = params["embed"].dtype, torch.float32

    def first(pred):
        return next((lp for lp in layers if pred(lp)), None)

    sites = {}
    att = first(lambda lp: "A_log" not in lp["mixer"])
    if att is not None:
        mx = att["mixer"]
        if "wq_a" in mx:
            sites.update(q_a=(mx["wq_a"], bf), q_b=(mx["wq_b"], bf),
                         kv_a=(mx["wkv_a"], bf), o=(mx["wo"], bf))
        else:
            sites.update(q=(mx["wq"], bf), kv=(mx["wk"], bf),
                         o=(mx["wo"], bf))
    ssm = first(lambda lp: "A_log" in lp["mixer"])
    if ssm is not None:
        mx = ssm["mixer"]
        sites.update(ssm_in_z=(mx["in_z"], bf), ssm_in_x=(mx["in_x"], bf),
                     ssm_in_bc=(mx["in_bc"], bf),
                     ssm_in_dt=(mx["in_dt"], bf),
                     ssm_out=(mx["out_proj"], bf))
    dense = first(lambda lp: "ffn" in lp and "router" not in lp["ffn"])
    if dense is not None:
        sites["up"] = (dense["ffn"]["up"], bf)
        sites["down"] = (dense["ffn"]["down"], bf)
    ffn = first(lambda lp: "ffn" in lp and "router" in lp["ffn"])
    if ffn is not None:
        ffn = ffn["ffn"]
        sites["router"] = (ffn["router"], f32)
        if "shared" in ffn:
            sites["shared_up"] = (ffn["shared"]["up"], bf)
            sites["shared_down"] = (ffn["shared"]["down"], bf)
    sites["head"] = (params["lm_head"] if "lm_head" in params
                     else params["embed"].t(), f32)
    if "mtp" in params:
        sites["mtp_proj"] = (params["mtp"]["proj"], bf)
    return sites


def _k1_site_check(dev, gen, cfg, tag, w, out_dtype, m: int, *,
                   one_slice: bool = False, faulted: bool = False) -> tuple:
    """K1 against its plain version at one GEMM site: x (m, K) from
    ``gen``, mode 1s on the route the path takes (with ``one_slice``, on
    that plan); y, bounds and no false flag, with ``family_checks``'
    tolerances; a value fault and a bit flip placed
    (``_k1_fault_check``) where ``faulted``.  Returns (max abs error of
    y, max|y|, clean residual / threshold, route)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, route
    from repro_torch.kernels.ref import abft_matmul_ref

    k, n = w.shape
    x = torch.randn(m, k, generator=gen, device=dev).to(w.dtype)
    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                  ((256, m), (512, k), (256, n)))
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    y, _, bnd = abft_matmul_kernel(x, w, **kw, one_slice=one_slice)
    yp, _, bndp = abft_matmul_ref(x, w, **kw)
    scale = yp.float().abs().max().item()
    tol = (1e-4 if out_dtype == torch.float32 else 2 ** -7) * scale
    err = (y.float() - yp.float()).abs().max().item()
    need(err <= tol, f"K1 {cfg.name} {tag}: err {err} > {tol}")
    berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max()
    need(berr.item() <= 1e-4, f"K1 {cfg.name} bnd {tag}: {berr.item()}")
    del y, yp, bnd, bndp
    _, chk = ops.abft_matmul(x, w, mode="1s", out_dtype=out_dtype,
                             one_slice=one_slice)
    need(not bool(chk.flag), f"K1 false flag {cfg.name} {tag} (K={k})")
    if faulted:
        _k1_fault_check(ops, FaultSpec, x, w, "1s", out_dtype,
                        f"{cfg.name} {tag}", one_slice=one_slice)
    return err, scale, _ratio(chk), route(x, w, bn, "1s")


def family_checks(dev, cfg, params, k2: bool = True) -> dict:
    """K1 and K2 against their plain versions at ``cfg``'s shapes, before
    its main path runs.  K1: each 2-D GEMM site's real weights
    (``_gemm_sites``; K up to 27392, N from 60 to 152064) at M = 4 (a
    decode step) and 1024 (the score's rows), and with ``one_slice`` (the
    serving prefill's plan) at M = 256 (a chunk) and 1024 (an admission),
    mode 1s on the route the path takes, and a value fault and a bit flip
    in the FFN's down projection (``down``, ``shared_down``), MLA's
    latent projections (``q_a``, ``kv_a``) and Mamba2's ``ssm_in_x`` and
    ``ssm_out`` flagged at their block and row.  K2 (unless ``k2`` is off: MLA never reaches it): causal
    bf16 at B = 1, L = 1024 with ``cfg``'s heads (D = 64 or 128, G = 1 or
    5).  K3 is held against its plain version layer by layer in
    ``k3_timing`` on the engine's own cache.

    Tolerances as ``k1_checks`` and ``k2_checks``: y within 2^-7 x max|y|
    in bf16 (one rounding of either side; 1e-4 in f32, the head's and the
    router's output) at the deepest K; bounds within 1e-4 relative; clean
    residuals under the threshold on both sides."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel,
        flash_attention_ref,
        tc_path,
    )

    gemms = _gemm_sites(params)
    gen = torch.Generator(device=dev).manual_seed(11)
    ratios, worst, worst_abs, routes_taken = {}, 0.0, 0.0, {}
    one_abs = 0.0
    for m, one in ((4, False), (1024, False), (256, True), (1024, True)):
        for name, (w, out_dtype) in gemms.items():
            tag = f"{name}_m{m}" + ("_one_slice" if one else "")
            err, scale, ratios[tag], routes_taken[tag] = _k1_site_check(
                dev, gen, cfg, tag, w, out_dtype, m, one_slice=one,
                faulted=name in ("down", "shared_down", "q_a", "kv_a",
                                 "ssm_in_x", "ssm_out"))
            worst = max(worst, err / max(scale, 1e-30))
            if one:
                one_abs = max(one_abs, err)
            else:
                worst_abs = max(worst_abs, err)
    need(all(v < 1 for v in ratios.values()),
         f"K1 clean residual at or over its threshold: {ratios}")
    rec = {"k1_max_rel_err_y": worst, "k1_max_abs_err": worst_abs,
           "k1_one_slice_max_abs_err": one_abs,
           "k1_routes": routes_taken,
           "k1_worst_clean_residual_over_threshold": max(ratios.values())}
    if not k2:
        return rec
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
    return {**rec, "k2_tc": tc_path(q, k, v, kw["bk"]),
            "k2_bf16_worst_err_over_tolerance": share.item(),
            "k2_max_abs_err": (got[0].float() - o_ref).abs().max().item(),
            "k2_worst_clean_residual_over_threshold": k2_ratio}


def _forward_f32_layerwise(model, params, tokens, mem=None):
    """Final hidden states of ``params`` run in f32, cast one layer at a
    time (the whole model in f32 does not fit beside its bf16 weights at
    14B and 32B): plain matmuls (ABFT off, TF32 off) and chunked
    attention, through the model's own ``apply_layer``; ``mem`` (f32,
    ``_memory_f32``) reaches each cross layer, and whisper's embeddings
    get their sinusoids."""
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx, norm
    from repro_torch.models.model import sinusoid_pos

    cfg = model.cfg
    ctx = LayerCtx(abft=ABFTConfig(enabled=False))
    B, L = tokens.shape
    x = params["embed"][tokens].float()
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    if cfg.is_encoder_decoder:
        x = x + sinusoid_pos(positions, cfg.d_model)
    for i, lp in enumerate(params["layers"]):
        x, _, _, _ = model.apply_layer(x, tree_map(lambda t: t.float(), lp),
                                       ctx.with_layer(i), positions, "full",
                                       None, mem=mem)
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
    """One dense-family config at full width (published dims; its
    ``DEPTH_CUTS`` depth; bf16 weights from seed 0, made on the card): the plan, the
    kernel checks at its shapes, serving (dense and paged streams equal,
    a clean run raises no flag, an ``mlp_down`` fault is recomputed to
    the clean streams), scoring, and the kernels' times at its shapes.
    Frees its weights before it returns."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    cfg = cut_config(arch)
    model = Model(cfg)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, prompts = engine_inputs(dev, cfg=cfg)
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
    audit_served(dev, model, params, prompts, arch)
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
    """Full-width llama3.2-1b (``served_llama``'s depth): the prefix and
    long-prompt traffic through the reference run (paged, neither
    feature) and every feature, faults included; the gates of the slice
    (see ``main``'s docstring); K1 at a chunk's M over the full model's
    GEMMs (``params``)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    model, served = served_llama(dev)
    cfg = model.cfg
    if params is None:
        params, _ = engine_inputs(dev)
    prefix, long = sharing_traffic(cfg.vocab_size)

    def run(traffic, label, **kw):
        return share_serve(model, served, traffic, dev, label, **kw)

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
        arch=ENGINE_ARCH, layers=SERVED_LAYERS,
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

SPEC_SLOTS, SPEC_MAX_LEN, SPEC_BLOCK, SPEC_NEW = 4, 1024, 16, 32
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
    of ``prompts`` (``SPEC_NEW`` new tokens each, all pending from the start)
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


def norm_row_order(dev, only=None) -> dict:
    """Whether a norm over the (slots, T) rows of a verify step reduces
    each row in the order of decode's (slots, 1) rows, at the dense
    family's norm widths: ``rms_norm`` over d_model 2048 (llama3.2-1b)
    and 5120 (qwen3-14b), ``layer_norm`` over 2048 (stablelm-1.6b), and
    qwen3-14b's q/k norms over head_dim 128 (40 and 8 heads a row); and
    deepseek-v3's: d_model 7168 and MLA's latent norms over 512
    (``kv_a_norm``) and 1536 (``q_a_norm``).  ``only``: those cases.  For
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
             "k_norm_8x128": ((8, 128), rms_red, rms_norm, (rnd(128),)),
             "rms_norm_7168": ((7168,), rms_red, rms_norm, (rnd(7168),)),
             "kv_a_norm_512": ((512,), rms_red, rms_norm, (rnd(512),)),
             "q_a_norm_1536": ((1536,), rms_red, rms_norm, (rnd(1536),))}
    out = {}
    for name, (width, red, fn, args) in cases.items():
        if only is not None and name not in only:
            continue
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
    """Full-width llama3.2-1b (``served_llama``'s depth; K1 at the verify
    step's M and the row-order observations on the full model's
    ``params``): copy and fresh traffic unsped (dense,
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

    cfg = get_config(ENGINE_ARCH)
    model, served = served_llama(dev, SPEC_LAYERS)
    if params is None:
        params, _ = engine_inputs(dev)
    traffic = spec_traffic(cfg.vocab_size)

    def run(kind, label, **kw):
        return spec_serve(model, served, traffic[kind], dev,
                          f"{kind} {label}", **kw)

    ngram4 = dict(spec_decode="ngram", draft_len=4)
    spec_serve(model, served, traffic["copy"][:2], dev, "warmup",
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
                    permanent_duration=1, seed=6,
                    layers=model.cfg.n_layers,
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
        arch=ENGINE_ARCH, layers=SPEC_LAYERS,
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
    """qwen3-14b at full width (G = 5, q/k norm; ``SPEC_SIDE_LAYERS``
    layers): copy traffic unsped, with ngram ``"auto"`` and with the oracle at K =
    8 (every step at T > 1 while a draft is left: the batched q/k norms at
    4 x 9 rows), dense; streams equal."""
    from repro_torch.models.model import Model

    arch = SIDE_ARCH
    cfg = side_config(SPEC_SIDE_LAYERS)
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


def moe_k1_timing(dev, params, caps=MOE_C, phase="moe_k1_timing") -> dict:
    """The first MoE layer's expert GEMMs (qwen2-moe's layer 0: up and
    gate at K, N = 2048, 1408, down at 1408, 2048; E = 60) at each
    capacity of ``caps``, bf16 mode 1s, by CUDA-graph replay: K1 batched
    (3 launches), its plain version, ``torch.bmm`` and the bound (each
    input read and each output written once, the residual and bound
    arrays included; 2 E C K N FLOP at the bf16 tensor-core rate)."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    ffn = next(lp["ffn"] for lp in params["layers"]
               if "ffn" in lp and "router" in lp["ffn"])
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for C in caps:
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
    emit(phase, **out)
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


@contextlib.contextmanager
def _route_log(log: list):
    """Appends each MoE layer's routing to ``log`` while the block is
    open: (top-k expert ids sorted within a token, the router's f32
    probabilities), as host arrays (they cross process boundaries)."""
    from repro_torch.models import moe as moe_mod

    top_k = moe_mod.top_k

    def logged(probs, k):
        vals, idx = top_k(probs, k)
        log.append((idx.sort(-1).values.cpu().numpy(),
                    probs.float().cpu().numpy()))
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
    """qwen2-moe-a2.7b at full width (published dims, 12 of its 24 layers:
    ``DEPTH_CUTS``; bf16 weights from seed 0, made on the card): the batched K1 against its
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
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.schemes import Scheme
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model, layer_tags

    t0 = time.perf_counter()
    checks = moe_k1_checks(dev)
    emit("moe_k1_check", **checks)
    cfg = cut_config(MOE_ARCH)
    model = Model(cfg)
    n_moe = sum(t == "attn:moe:0" for t in layer_tags(cfg))
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params, prompts = engine_inputs(dev, cfg=cfg)
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
    audit_served(dev, model, params, prompts, MOE_ARCH)
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


# ------------------------------------------------------------------ mla

MLA_ARCH = "deepseek-v3-671b"
# published widths cut to 4 layers (3 dense + 1 MoE: the least depth that
# holds an MoE layer and the most that fits; with the MTP head 26.7e9
# parameters, 53.4 GB in bf16); the first 3 layers' weights form the
# all-dense MLA stack
MLA_LAYERS, MLA_DENSE_LAYERS = 4, 3
MLA_SHAPES = {"up": (7168, 2048), "down": (2048, 7168)}
MLA_MAX_LEN, MLA_CHUNK, MLA_NEW, MLA_SPEC_K = 1024, 256, 16, 4
# the score's logits gate: error against f32 routed alike, as a share of
# the logits' scale (bf16 through 4 layers: ~0.005)
MLA_SCORE_TOL = 0.05


def mla_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)


def _batched_case(dev, gen, w, C, name) -> tuple:
    """K1 batched over w's experts (bf16 mode 1s) against its plain
    version at capacity C on random rows: one launch, y within 2^-7 x
    max|y|, bounds within 1e-4 relative, a value fault flagged in every
    expert at its block and row (``_moe_fault_check``).  Returns the
    worst y error and clean residual over threshold."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.kernels import abft_matmul
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    E, k, n = w.shape
    x = torch.randn(E, C, k, generator=gen, device=dev).to(w.dtype)
    bm, bk, bn = _moe_clamp(C, k, n)
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=w.dtype)
    yp, resp, bndp = abft_matmul_batched_ref(x, w, **kw)
    l0, b0 = K1.launches, K1B.launches
    y, res, bnd = abft_matmul_kernel(x, w, **kw)
    torch.cuda.synchronize()
    need(K1.launches - l0 == 1 and K1B.launches - b0 == 1,
         f"batched K1 {name}: not one launch")
    scale = yp.float().abs().max().item()
    err = (y.float() - yp.float()).abs().max().item()
    need(err <= 2 ** -7 * scale, f"batched K1 y {name}: err {err}")
    berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max()
    need(berr.item() <= 1e-4, f"batched K1 bnd {name}")
    tau = ATOL + tolerance_scale(-(-k // bk) * bk) * bnd
    taup = ATOL + tolerance_scale(-(-k // bk) * bk) * bndp
    ratio = max((res / tau).max().item(), (resp / taup).max().item())
    del y, yp, res, resp, bnd, bndp
    _moe_fault_check(x, w, "1s", name)
    return err, ratio


def mla_k1_checks(dev) -> dict:
    """K1 batched over deepseek-v3's 256 experts (K, N = 7168, 2048 and
    2048, 7168), bf16 mode 1s, against its plain version at the
    capacities of a decode step (C = 4) and of an admission of 4 x 256
    tokens (``moe.capacity``: 40), with a value fault flagged in every
    expert at its block and row (``_moe_fault_check``); then one layer's
    three expert GEMMs timed at both (the gate GEMM reads the up weights
    again: 7.5 GB apart, no cache holds them).  Run on the card before
    the model loads: the plain version widens a GEMM's 7.5 GB of weights
    to f32 (15 GB), on random weights of the real shapes.  Tolerances as
    ``moe_k1_checks``.  Timing: K1 and ``torch.bmm`` by CUDA-graph
    replay, the plain version eagerly (its 15 GB widening a GEMM takes
    milliseconds; the host's share is under 1%), the bound each input
    read and each output written once (7.52 GB a GEMM)."""
    from repro_torch.kernels import abft_matmul
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_batched_ref
    from repro_torch.models.moe import capacity

    cfg = mla_config()
    E, bf = cfg.n_experts, torch.bfloat16
    c_admit = capacity(cfg, 4 * 256)
    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    gen = torch.Generator(device=dev).manual_seed(29)
    ws = {name: (0.02 * torch.randn(E, k, n, generator=gen, device=dev))
          .to(bf) for name, (k, n) in MLA_SHAPES.items()}
    ratio, worst, cases = 0.0, 0.0, 0
    for name, w in ws.items():
        for C in (4, c_admit):
            err, r = _batched_case(dev, gen, w, C, f"mla {name} C={C}")
            worst, ratio, cases = max(worst, err), max(ratio, r), cases + 1
    need(ratio < 1, f"mla batched K1 clean residual at {ratio} of its "
         f"threshold")
    timing = {}
    for C in (4, c_admit):
        calls, b_ms, by = [], 0.0, set()
        for w in (ws["up"], ws["up"], ws["down"]):
            _, k, n = w.shape
            x = torch.randn(E, C, k, generator=gen, device=dev).to(bf)
            bm, bk, bn = _moe_clamp(C, k, n)
            calls.append((x, w, dict(mode="1s", bm=bm, bk=bk, bn=bn,
                                     out_dtype=bf)))
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

        timing[f"experts_c{C}"] = {
            "C": C, "E": E, "gemms": 3, "launches": 3,
            "ms": timed_graph(kern, iters=10),
            "ms_eager": timed(kern, iters=10),
            "plain_ms": timed(plain, iters=2, warmup=1),
            "library_ms": timed_graph(lib, iters=10),
            "bound_ms": b_ms, "bound_by": by.pop()}
        del calls
    del ws
    free_memory()
    rec = {"cases": cases, "capacity_admission": c_admit,
           "max_abs_err_y": worst,
           "worst_clean_residual_over_threshold": ratio}
    emit("mla_k1_check", **rec)
    emit("mla_k1_timing", **timing)
    return {"checks": rec, "timing": timing}


def mla_serve(model, params, traffic, dev, label, *, cache_kind="dense",
              flash=False, capture=None, hook=None, **kw) -> dict:
    """One bf16 engine run (4 slots, max_len ``MLA_MAX_LEN``, block 16,
    ``IntensityGuidedPolicy`` on the H100) of ``traffic`` ((prompt, new
    tokens, arrival iteration) a request) through ``admit``/``step``; K1
    (2-D and batched over experts), K2 and K3 counted from 0 for this run
    and K2 and K3 held to 0 (MLA never takes them, ``flash`` on or off);
    every step timed to a synchronize; ``check_invariants`` after every
    paged step.  ``capture`` collects each request's prompt latent cells
    (every layer) once it turns active; ``hook(engine)`` runs once the
    engine is built.  Returns the run's record."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import Request, ServeEngine

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    K2, K3 = flash_attention.FULL_KERNEL, flash_attention.KERNEL
    abft = ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                  hardware=NVIDIA_H100_SXM,
                                  flash_attention=flash)
    eng = ServeEngine(model, params, slots=4, max_len=MLA_MAX_LEN,
                      block_size=16, abft=abft, dtype=torch.bfloat16,
                      device=dev, cache_kind=cache_kind, seed=0, **kw)
    if hook is not None:
        hook(eng)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n, _) in enumerate(traffic)]
    due = {r.uid: a for r, (_, _, a) in zip(reqs, traffic)}
    pending, later, step_ms, it = [], list(reqs), [], 0
    torch.cuda.synchronize()
    K1.launches = K1B.launches = K2.launches = K3.launches = 0  # this run
    t0 = time.perf_counter()
    while pending or later or eng.active or eng._prefill_cursors:
        for r in [r for r in later if due[r.uid] <= it]:
            pending.append(r)
            later.remove(r)
        if pending and eng.free_slots():
            eng.admit(pending)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - ts))
        if eng.pool is not None:
            eng.pool.check_invariants()
        if capture is not None:
            for s, r in eng.active.items():
                if r.uid in capture:
                    continue
                pos = torch.arange(len(r.prompt), device=dev)
                if eng.pool is not None:
                    t = torch.as_tensor(eng.pool.tables[s], device=dev)
                    idx = (t[pos // 16].long(), pos % 16)
                else:
                    idx = (s, pos)
                capture[r.uid] = [leaf[idx].clone() for layer in eng.cache
                                  for leaf in layer.values()]
        it += 1
        need(it < 4000, f"mla {label}: the run does not end")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = eng.stats
    rec = dict(
        label=label, cache=cache_kind, seconds=seconds, iterations=it,
        tokens=st.tokens, tokens_per_s=st.tokens / seconds,
        step_ms_median=float(np.median(step_ms)),
        launches={"abft_matmul": K1.launches,
                  "abft_matmul_batched": K1B.launches,
                  "flash_attention": K2.launches,
                  "flash_decode": K3.launches},
        streams={r.uid: list(r.generated) for r in reqs},
        errors={r.uid: r.error for r in reqs if r.error},
        prompt_tokens=st.prompt_tokens_total,
        prefill_tokens_computed=sum(e["prefill"]
                                    for e in st.selection_trace),
        **{k: getattr(st, k) for k in (
            "steps", "faults_detected", "retries", "hard_faults",
            "evictions", "prefix_tokens_shared", "cow_copies",
            "prefill_chunks", "draft_proposed", "draft_accepted")})
    rec["acceptance"] = (st.draft_accepted / st.draft_proposed
                         if st.draft_proposed else None)
    need(not rec["errors"], f"mla {label}: errors {rec['errors']}")
    need(K1.launches > 0, f"mla {label}: K1 never launched")
    need(K2.launches == 0 and K3.launches == 0,
         f"mla {label}: K2 or K3 launched on the MLA path")
    need(rec["faults_detected"] == 0, f"mla {label}: a clean run flagged")
    if eng.pool is not None:
        need(eng.pool.blocks_free == eng.pool.num_blocks,
             f"mla {label}: blocks leaked")
    emit("mla_run", **{k: v for k, v in rec.items() if k != "streams"})
    del eng
    return rec


def _cells_equal(a: dict, b: dict, what: str) -> None:
    need(a.keys() == b.keys(), f"mla {what}: captured {sorted(a)} vs "
         f"{sorted(b)}")
    for uid in a:
        need(all(torch.equal(x, y) for x, y in zip(a[uid], b[uid],
                                                    strict=True)),
             f"mla {what}: request {uid}'s prompt latent cells differ")


def absorb_row_order(dev, params) -> dict:
    """The absorbed product ``q_nope @ w_uk`` (layer 0's, 128 heads,
    K = 128, N = 512) on the card: whether a row's bits depend on the
    call's row count when batched (a 1024-row prefill against the same
    rows in 8-row calls), and whether ``_absorb``'s fixed row blocks and
    its stepwise order give every call the same bits (a suffix, a chunk;
    a verify step against decode).  Observations behind the design; the
    gates are the streams and the cells."""
    from repro_torch.models.attention import _absorb

    w = params["layers"][0]["mixer"]["w_uk"]
    g = torch.Generator(device=dev).manual_seed(31)
    a = torch.randn(1, 1024, w.shape[0], w.shape[1], generator=g,
                    device=dev).to(torch.bfloat16)
    out = {}
    for order in (None, "rows"):
        whole = _absorb(a, w, torch.bfloat16, order)
        parts = torch.cat([_absorb(a[:, s:s + 8], w, torch.bfloat16, order)
                           for s in range(0, 1024, 8)], 1)
        tail = _absorb(a[:, 1000:], w, torch.bfloat16, order)
        out[order or "batched"] = {
            "rows_8_equal_1024": bool(torch.equal(whole, parts)),
            "suffix_24_equal_1024": bool(torch.equal(whole[:, 1000:],
                                                     tail))}
    v = torch.randn(4, 9, w.shape[0], w.shape[1], generator=g,
                    device=dev).to(torch.bfloat16)
    dec = torch.cat([_absorb(v[:, t:t + 1].contiguous(), w, torch.bfloat16)
                     for t in range(9)], 1)
    out["verify_36_rows"] = {
        "batched_equal_decode": bool(torch.equal(
            _absorb(v, w, torch.bfloat16), dec)),
        "steps_equal_decode": bool(torch.equal(
            _absorb(v, w, torch.bfloat16, "steps"), dec))}
    return out


def _f32_layerwise_routed(model, params, tokens, routes) -> tuple:
    """``_forward_f32_layerwise`` for a stack with MoE layers, and its MTP
    head where it has one: every leaf widened to f32 a layer at a time
    except the expert weights (deepseek's: 45 GB in f32 beside 53 GB of
    bf16), which the expert GEMMs widen 32 experts at a time (f32
    products of the same bf16 values).  Each MoE layer takes the experts
    ``routes`` gives it (one (T, K) entry a MoE layer, in order: another
    run's routing), weighted by its own f32 probabilities, so both runs
    drop the same tokens at capacity; the experts its own probabilities
    pick are logged.  Returns the final hidden states, the MTP head's
    pre-head hidden states (f32; None without the head) and that log."""
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import LayerCtx, norm

    cfg = model.cfg
    ctx = LayerCtx(abft=ABFTConfig(enabled=False))

    def widen(tree):
        if isinstance(tree, dict):
            return {k: (v if k in ("w_up", "w_gate", "w_down")
                        else widen(v)) for k, v in tree.items()}
        return tree.float()

    def grouped(x_e, w_e, ctx, site, tag=None, split_rows=None, par=None):
        y = torch.empty(x_e.shape[:2] + (w_e.shape[2],), dtype=x_e.dtype,
                        device=x_e.device)
        for e0 in range(0, w_e.shape[0], 32):
            y[e0:e0 + 32] = torch.bmm(x_e[e0:e0 + 32].float(),
                                      w_e[e0:e0 + 32].float())
        return y, torch.zeros((), dtype=torch.bool, device=x_e.device)

    own, forced = [], iter(routes)
    top_k = moe_mod.top_k

    def routed(probs, k):
        own.append(top_k(probs, k)[1].sort(-1).values)
        idx = next(forced)
        return probs.gather(-1, idx), idx

    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    batched, moe_mod.batched_dense = moe_mod.batched_dense, grouped
    moe_mod.top_k = routed
    try:
        x = params["embed"][tokens].float()
        for i, lp in enumerate(params["layers"]):
            x, _, _, _ = model.apply_layer(x, widen(lp), ctx.with_layer(i),
                                           positions, "full", None)
        h = norm(x, widen(params["final_norm"]), cfg.norm, cfg.norm_eps)
        hm = None
        if "mtp" in params:
            mp = params["mtp"]
            nxt = params["embed"][torch.roll(tokens, -1, 1)].float()
            comb = torch.cat([norm(h, widen(mp["norm"]), "rmsnorm",
                                   cfg.norm_eps), nxt], -1)
            hm, _, _, _ = model.apply_layer(comb @ mp["proj"].float(),
                                            widen(mp["layer"]), ctx,
                                            positions, "full", None)
    finally:
        moe_mod.batched_dense = batched
        moe_mod.top_k = top_k
    return h, hm, own


def mla_score(dev, model, params) -> dict:
    """``Model.forward`` of the 4-layer model at 1 x 1024 under
    ``IntensityGuidedPolicy`` with ``flash_attention`` on (MLA ignores
    it: K2 launches 0 times): logits and ``mtp_logits`` finite, (1, 1024,
    V) f32, no flag; K1 batched three times in each MoE layer (layer 3
    and the MTP head's); the MTP loss term (``mtp_loss_coef`` x the NLL of
    token t + 2, the tokens as their own labels).  Both held against the
    same weights run in f32 layer by layer (``_f32_layerwise_routed``; the
    heads in column chunks) routed as this run routes, so both drop the
    same tokens at an expert's capacity (40 of a 1024-token call's 8192
    assignments an expert: a token routed apart moves which later tokens
    drop): the logits and the MTP logits each within ``MLA_SCORE_TOL`` of
    their own scale at every position; and the experts the f32 run's own
    probabilities pick against this run's (``_routing_diff``, the share
    routed apart a layer)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import LayerCtx
    from repro_torch.train.train_step import TrainConfig

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    K2 = flash_attention.FULL_KERNEL
    cfg = model.cfg
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(SCORE_B, SCORE_L)).astype(np.int64)).to(dev)
    ctx = LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
        flash_attention=True))
    torch.cuda.synchronize()
    K1.launches = K1B.launches = K2.launches = 0        # THIS run's
    t = time.perf_counter()
    with torch.no_grad(), _routing_log() as routes:
        out = model.forward(params, {"tokens": tokens}, ctx, device=dev)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    launches = {"abft_matmul": K1.launches,
                "abft_matmul_batched": K1B.launches,
                "flash_attention": K2.launches}
    lg, lm = out.logits, out.mtp_logits
    shape = (SCORE_B, SCORE_L, cfg.vocab_size)
    need(lm is not None and lg.shape == lm.shape == shape
         and lg.dtype == lm.dtype == torch.float32,
         f"mla score: logits {tuple(lg.shape)}, mtp {lm is not None}")
    need(bool(torch.isfinite(lg).all()) and bool(torch.isfinite(lm).all()),
         "mla score: non-finite logits")
    need(not bool(out.flag), "mla score: clean forward raised a flag")
    need(K2.launches == 0, f"mla score: K2 launched {K2.launches} times")
    need(K1B.launches == 6, f"mla score: batched K1 launched "
         f"{K1B.launches} times, expected 3 in each of 2 MoE layers")
    need(len(routes) == 2, f"mla score: {len(routes)} MoE layers routed")
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    mask = (labels >= 0).float()
    m2 = mask * torch.roll(mask, -1, 1)
    lp2 = torch.gather(torch.log_softmax(lm, -1), -1,
                       torch.roll(labels, -1, 1).clamp_min(0)[..., None])
    mtp_nll = float(-(lp2[..., 0] * m2).sum() / mask.sum())
    with torch.no_grad():
        h32, hm32, routes_32 = _f32_layerwise_routed(model, params, tokens,
                                                     routes)
        head = params["lm_head"]
        err = torch.zeros(lg.shape[:2], device=dev)
        err_m = torch.zeros(lg.shape[:2], device=dev)
        best32 = torch.full(lg.shape[:2], -float("inf"), device=dev)
        arg32 = torch.zeros(lg.shape[:2], dtype=torch.long, device=dev)
        for c0 in range(0, cfg.vocab_size, 16384):
            w = head[:, c0:c0 + 16384].float()
            l32 = h32 @ w
            err = torch.maximum(err, (lg[..., c0:c0 + 16384] - l32)
                                .abs().amax(-1))
            m, a = l32.max(-1)
            arg32 = torch.where(m > best32, a + c0, arg32)
            best32 = torch.maximum(best32, m)
            err_m = torch.maximum(err_m, (lm[..., c0:c0 + 16384]
                                          - hm32 @ w).abs().amax(-1))
        del h32, hm32
    main = _routing_diff(routes[:1], routes_32[:1], err, SCORE_L)
    both = _routing_diff(routes, routes_32, err_m, SCORE_L)
    scale = lg.abs().max().item()
    worst = err.max().item()
    rec = dict(B=SCORE_B, L=SCORE_L, launches=launches, ms=ms,
               aux_loss=float(out.aux_loss), mtp_nll=mtp_nll,
               mtp_loss_term=TrainConfig().mtp_loss_coef * mtp_nll,
               logits_scale=scale, mtp_logits_scale=lm.abs().max().item(),
               logits_max_abs_err_vs_f32=worst,
               mtp_logits_max_abs_err_vs_f32=err_m.max().item(),
               argmax_agreement_vs_f32=(lg.argmax(-1) == arg32).float()
               .mean().item(),
               routing_vs_f32_own=main, mtp_routing_vs_f32_own=both)
    del out, lg, lm
    emit("mla_score", **rec)
    need(worst <= MLA_SCORE_TOL * scale, f"mla score: logits vs f32 "
         f"routed alike {worst} > {MLA_SCORE_TOL} x scale {scale}")
    # the MTP head adds one MoE layer behind the stack: the same bound
    m_worst, m_scale = rec["mtp_logits_max_abs_err_vs_f32"], \
        rec["mtp_logits_scale"]
    need(m_worst <= MLA_SCORE_TOL * m_scale, f"mla score: MTP logits vs "
         f"f32 routed alike {m_worst} > {MLA_SCORE_TOL} x scale {m_scale}")
    return rec


def mla_dense_stack(dev, model, params) -> dict:
    """The all-dense MLA stack: the first ``MLA_DENSE_LAYERS`` layers of
    the same weights (no copy), served with flash off on share traffic
    (the prefix prompts of ``sharing_traffic``: four of one 512-token
    system prefix and the COW twins, arriving one every other step) and
    copy traffic (``spec_traffic``'s first six), ``MLA_NEW`` new tokens a
    request.  Gates: dense streams equal paged; under prefix sharing,
    chunks of ``MLA_CHUNK`` (dense and paged) and both, the greedy
    streams equal the plain run's and every request's prompt latent cells
    (every layer) are bit-equal to the plain dense run's; n-gram and an
    oracle proposer (the unsped run's own tokens) at K = ``MLA_SPEC_K``,
    dense and paged, give the unsped streams, the oracle accepting every
    draft."""
    from repro_torch.models.model import Model, layer_tags

    cfg = dataclasses.replace(model.cfg, n_layers=MLA_DENSE_LAYERS)
    need(set(layer_tags(cfg)) == {"mla:dense:0"},
         f"mla dense stack tags {layer_tags(cfg)}")
    m3 = Model(cfg)
    p3 = {k: params[k] for k in ("embed", "final_norm", "lm_head")}
    p3["layers"] = params["layers"][:MLA_DENSE_LAYERS]
    prefix = sharing_traffic(cfg.vocab_size)[0]
    share_t = [(p, MLA_NEW, 2 * i)
               for i, (p, _, _) in enumerate(prefix[:4] + prefix[-2:])]
    copy_t = [(p, MLA_NEW, 0)
              for p in spec_traffic(cfg.vocab_size)["copy"][:6]]
    runs, cells = {}, {}

    def run(name, traffic, kind, capture=False, **kw):
        c = {} if capture else None
        runs[name] = mla_serve(m3, p3, traffic, dev, f"dense_stack {name}",
                               cache_kind=kind, capture=c, **kw)
        if capture:
            cells[name] = c
        return runs[name]

    plain = run("share_plain", share_t, "dense", capture=True)
    for name, kind, kw in (
            ("share_plain_paged", "paged", {}),
            ("shared", "paged", dict(prefix_sharing=True)),
            ("chunk_dense", "dense", dict(chunk_tokens=MLA_CHUNK)),
            ("chunk_paged", "paged", dict(chunk_tokens=MLA_CHUNK)),
            ("shared_chunks", "paged", dict(prefix_sharing=True,
                                            chunk_tokens=MLA_CHUNK))):
        rec = run(name, share_t, kind, capture=True, **kw)
        need(rec["streams"] == plain["streams"],
             f"mla dense stack {name}: streams differ from the plain run")
        _cells_equal(cells[name], cells["share_plain"], name)
    need(runs["shared"]["prefix_tokens_shared"] > 0
         and runs["shared"]["cow_copies"] > 0,
         "mla dense stack: nothing shared or copied on write")
    need(runs["chunk_dense"]["prefill_chunks"] > len(share_t),
         "mla dense stack: no prompt was chunked")
    unsped = {kind: run(f"copy_unsped_{kind}", copy_t, kind)
              for kind in ("dense", "paged")}
    need(unsped["dense"]["streams"] == unsped["paged"]["streams"],
         "mla dense stack: copy traffic dense streams differ from paged")
    for kind in ("dense", "paged"):
        for prop in ("ngram", "oracle"):
            spec = (_OracleProposer(unsped[kind]["streams"])
                    if prop == "oracle" else "ngram")
            rec = run(f"{prop}_k{MLA_SPEC_K}_{kind}", copy_t, kind,
                      spec_decode=spec, draft_len=MLA_SPEC_K)
            need(rec["streams"] == unsped[kind]["streams"],
                 f"mla dense stack {prop} {kind}: streams differ from "
                 f"unsped")
            need(rec["draft_proposed"] > 0, f"mla dense stack {prop} "
                 f"{kind}: nothing proposed")
            if prop == "oracle":
                need(rec["draft_accepted"] == rec["draft_proposed"],
                     f"mla dense stack oracle {kind}: a draft rejected")
    out = {name: {k: r[k] for k in (
        "seconds", "steps", "tokens_per_s", "step_ms_median", "launches",
        "prompt_tokens", "prefill_tokens_computed", "prefix_tokens_shared",
        "cow_copies", "prefill_chunks", "draft_proposed", "draft_accepted",
        "acceptance")} for name, r in runs.items()}
    emit("mla_dense_stack", layers=MLA_DENSE_LAYERS, streams_equal=True,
         latent_cells_equal=True, runs=out)
    return out


@contextlib.contextmanager
def _drop_log(cfg):
    """Every MoE layer call's drops while the block is open: the token
    indices an expert dropped at capacity and those experts, by
    ``moe_forward``'s dispatch rule (each token's experts in ascending
    id, an expert's rows in token order, rows past ``capacity(cfg, T)``
    dropped).  Wraps ``moe.top_k``; reads each call's drops to the host."""
    from repro_torch.models import moe as moe_mod

    top_k, log = moe_mod.top_k, []

    def logged(probs, k):
        vals, idx = top_k(probs, k)
        flat = idx.sort(-1).values.reshape(-1)
        order = torch.argsort(flat, stable=True)
        se = flat[order]
        pos = torch.arange(flat.numel(), device=flat.device) \
            - torch.searchsorted(se, se, side="left")
        drop = pos >= moe_mod.capacity(cfg, idx.shape[0])
        log.append(((order // k)[drop].tolist(), se[drop].tolist()))
        return vals, idx

    moe_mod.top_k = logged
    try:
        yield log
    finally:
        moe_mod.top_k = top_k


def _charge_drops(log, drops, verify_calls):
    """An engine hook (``mla_serve``'s ``hook``) that charges each token a
    model call dropped to the request in its row: ``drops[uid]`` counts
    them by expert, and each verify call appends its own count by expert
    to ``verify_calls``.  A decode or verify row is a slot (its request read
    from ``active`` during the call; an inactive slot's padding charges
    no one); a prefill row is its admission slot, read once ``admit``
    returns.  Only a row's valid tokens are charged (a prefill row's
    ``lengths``, a verify row's ``valid``): a padding token's output is
    never read, though it takes an expert's capacity in token order."""
    def hook(eng):
        pending = []

        def charge(slot_uid):
            for slot, e in pending:
                uid = slot_uid(slot)
                if uid is not None:
                    per = drops.setdefault(uid, {})
                    per[e] = per.get(e, 0) + 1
            pending.clear()

        def active_uid(slot):
            req = eng.active.get(int(slot))
            return req.uid if req is not None else None

        def wrap(runner, name):
            inner = getattr(runner, name)

            def call(p, toks, *a, **k):
                mark = len(log)
                B, T = toks.shape[:2]
                slots = (a[1].tolist() if name == "prefill"
                         else list(range(B)))
                valid = a[2].tolist() if name != "decode" else [1] * B
                out = inner(p, toks, *a, **k)
                start = len(pending)
                for tok, experts in log[mark:]:
                    pending.extend((slots[t // T], e)
                                   for t, e in zip(tok, experts)
                                   if t % T < valid[t // T])
                if name == "verify":
                    per = {}
                    for _, e in pending[start:]:
                        per[e] = per.get(e, 0) + 1
                    verify_calls.append(per)
                if name != "prefill":
                    charge(active_uid)
                return out

            setattr(runner, name, call)

        for runner in eng._level_runners:
            for name in ("prefill", "decode", "verify"):
                wrap(runner, name)
        admit = eng.admit

        def admitted(*a, **k):
            out = admit(*a, **k)
            charge(active_uid)
            return out

        eng.admit = admitted

    return hook


def mla_moe_spec(dev, model, params) -> dict:
    """Speculation on the 4-layer MLA + MoE model (flash off): copy
    traffic (``spec_traffic``'s first six prompts, ``MLA_NEW`` new tokens
    each) unsped, then through n-gram and an oracle proposer (the unsped
    run's own tokens) at K = ``MLA_SPEC_K``.  The verify window is the
    reference's K + 1 tokens a slot, and its 4 x 5 rows set each expert's
    capacity, so its drops differ from decode's; every call's drops are
    charged to the requests in their rows (``_drop_log``,
    ``_charge_drops``), in the unsped run too, and each verify call's
    drops are counted by expert.  Gates: the oracle's
    drafts accepted (random weights give n-gram lookup little to find:
    its proposals are recorded, and its verify windows run K + 1 wide
    all the same); every stream that met no drop in either run equals its
    unsped stream, and at least one such stream exists; K1 launched, K2
    and K3 never.  Records how many streams were held equal and the drops
    of the others by expert."""
    cfg = model.cfg
    traffic = [(p, MLA_NEW, 0)
               for p in spec_traffic(cfg.vocab_size)["copy"][:6]]
    runs, drops, calls = {}, {}, {}
    with _drop_log(cfg) as log:
        for name in ("unsped", "ngram", "oracle"):
            drops[name], calls[name] = {}, []
            kw = {}
            if name != "unsped":
                kw = dict(spec_decode=("ngram" if name == "ngram" else
                                       _OracleProposer(
                                           runs["unsped"]["streams"])),
                          draft_len=MLA_SPEC_K)
            runs[name] = mla_serve(
                model, params, traffic, dev, f"4-layer spec {name}",
                hook=_charge_drops(log, drops[name], calls[name]), **kw)
    base = runs["unsped"]["streams"]
    out = {"runs": {}, "K": MLA_SPEC_K, "requests": len(traffic),
           "unsped_drops": {str(u): d for u, d in drops["unsped"].items()}}
    for name in ("ngram", "oracle"):
        rec = runs[name]
        need(name == "ngram" or rec["draft_accepted"] > 0,
             f"mla spec {name}: no draft accepted")
        clean = [u for u in base
                 if u not in drops["unsped"] and u not in drops[name]]
        differ = [u for u in base if rec["streams"][u] != base[u]]
        need(not set(clean) & set(differ), f"mla spec {name}: streams "
             f"{sorted(set(clean) & set(differ))} met no drop and differ "
             f"from the unsped run")
        need(clean, f"mla spec {name}: every stream met a drop")
        by_expert = {}
        for per in calls[name]:
            for e, n in per.items():
                by_expert[str(e)] = by_expert.get(str(e), 0) + n
        out["runs"][name] = {
            "verify_calls": len(calls[name]),
            "verify_calls_with_drops": sum(1 for per in calls[name] if per),
            "verify_drops_by_expert": by_expert,
            "streams_held_equal": len(clean),
            "streams_with_drops": len(base) - len(clean),
            "streams_differing": len(differ),
            "drops": {str(u): d for u, d in drops[name].items()},
            **{k: rec[k] for k in ("seconds", "steps", "tokens_per_s",
                                   "step_ms_median", "launches",
                                   "draft_proposed", "draft_accepted",
                                   "acceptance")}}
    out["runs"]["unsped"] = {k: runs["unsped"][k] for k in (
        "seconds", "steps", "tokens_per_s", "step_ms_median", "launches")}
    emit("mla_moe_spec", **out)
    return out


def mla_runs(dev) -> dict:
    """deepseek-v3-671b at its published widths, cut to ``MLA_LAYERS``
    layers (3 dense + 1 MoE) with its MTP head (bf16 weights from seed 0,
    made on the card): K1 batched over its 256 experts against its plain
    version and timed (``mla_k1_checks``, before the model loads); every
    2-D K1 site against its plain version (``family_checks``: q_a, q_b,
    kv_a, o, the dense FFN, the router, the shared expert, the head and
    the MTP projection; faults at q_a, kv_a and the down projections);
    serving (4 slots, max_len 512, 8 requests of 16-256 tokens, 16 new
    each, flash on, which MLA ignores: dense and paged streams equal, no
    clean flag, K1 batched three times a decode step, K2 and K3 never; a
    fault at ``kv_a`` in layer 0, ``q_a`` in layer 3 and ``expert_up``
    in layer 3 each flagged and recomputed to the clean streams; a
    ``global`` run; prefix sharing with chunks of 256 on the prefix
    traffic; n-gram and oracle speculation at K = 4 on copy traffic
    (``mla_moe_spec``)); the decode step's profile; the all-dense 3-layer stack
    (``mla_dense_stack``); the score (``mla_score``); K1 over a decode
    step's 2-D GEMMs against ``torch.matmul``; the observations
    ``absorb_row_order`` and ``norm_row_order`` at MLA's widths.  Frees
    its weights before it returns."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.schemes import Scheme
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model, layer_tags

    t0 = time.perf_counter()
    batched = mla_k1_checks(dev)
    emit_memory("mla_k1_checks")
    cfg = mla_config()
    model = Model(cfg)
    n_moe = sum(t.endswith(":moe:0") for t in layer_tags(cfg))
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params, prompts = engine_inputs(dev, cfg=cfg)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    mtp_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(params["mtp"]))
    emit("mla_plan", arch=MLA_ARCH, layers=cfg.n_layers,
         tags=layer_tags(cfg), init_s=time.perf_counter() - t1,
         weights_gb=weights / 1e9, mtp_gb=mtp_bytes / 1e9,
         **family_plan(cfg))
    fchecks = family_checks(dev, cfg, params, k2=False)
    emit("mla_family_check", arch=MLA_ARCH, **fchecks)

    def serve(cache_kind, policy=None, fault_at=None, label="", reqs=None,
              new=16):
        return engine_serve(model, params, prompts if reqs is None else reqs,
                            dev, cache_kind, policy or IntensityGuidedPolicy(),
                            fault_at=fault_at, label=f"{MLA_ARCH} {label}",
                            phase="mla_engine", max_new_tokens=new)

    serve("dense", label="warmup", reqs=prompts[:1], new=2)
    audit_served(dev, model, params, prompts, MLA_ARCH)
    dense, rec_dense, eng = serve("dense", label="dense")
    prof = decode_profile(dev, {"engine": eng, "params": params,
                                "prompts": prompts, "dense": rec_dense})
    emit("mla_decode_profile", **prof)
    del eng
    free_memory()
    paged, rec_paged, _ = serve("paged", label="paged")
    for rec in (rec_dense, rec_paged):
        need(rec["launches"]["abft_matmul"] > 0,
             f"mla {rec['label']}: K1 never launched")
        need(rec["launches"]["flash_decode"] == 0
             and rec["launches"]["flash_attention"] == 0,
             f"mla {rec['label']}: K2 or K3 launched {rec['launches']}")
        need(rec["batched_launches_per_step"] == {
            str(3 * n_moe): rec["decode_steps"]},
             f"mla {rec['label']}: batched K1 launches a decode step "
             f"{rec['batched_launches_per_step']}, expected {3 * n_moe}")
        need(rec["faults_detected"] == 0, f"mla {rec['label']}: a clean "
             f"run raised a flag")
    need(paged == dense, "mla: paged streams differ from dense")
    faults = {}
    for layer, site in ((0, "kv_a"), (3, "q_a"), (3, "expert_up")):
        fault = ModelFault.at(layer, site, FaultSpec.value(0, 1, 1e5))
        faulted, rec_fault, _ = serve("dense", fault_at=(3, fault),
                                      label=f"dense_{site}_l{layer}_fault")
        need(rec_fault["faults_detected"] >= 1
             and rec_fault["retries"] >= 1,
             f"mla: {site} (layer {layer}) fault not detected and retried")
        need(faulted == dense, f"mla: the {site} fault run's streams "
             f"differ from the clean run")
        faults[f"{site}_l{layer}"] = dict(
            faults_detected=rec_fault["faults_detected"],
            retries=rec_fault["retries"])
    glob, rec_glob, _ = serve("dense", FixedPolicy(Scheme.GLOBAL),
                              label="dense_global")
    free_memory()
    need(rec_glob["faults_detected"] == 0, "mla: global scheme false flag")
    need(rec_glob["launches"]["abft_matmul"] == 0,
         "mla: the global run launched K1")
    spec4 = mla_moe_spec(dev, model, params)
    free_memory()
    shared4 = mla_serve(
        model, params, [(p, MLA_NEW, a) for p, _, a in
                        sharing_traffic(cfg.vocab_size)[0]], dev,
        "4-layer shared_chunks", cache_kind="paged", flash=True,
        prefix_sharing=True, chunk_tokens=MLA_CHUNK)
    need(shared4["prefill_tokens_computed"] < shared4["prompt_tokens"],
         "mla: sharing computed every prompt token")
    free_memory()
    stack = mla_dense_stack(dev, model, params)
    free_memory()
    score = mla_score(dev, model, params)
    free_memory()
    tp1 = mla_tp1(dev, model, params, prompts)
    emit_memory("mla_tp1")
    t1 = k1_timing(dev, params, 4, arch=MLA_ARCH)
    observe = {"absorb_row_order": absorb_row_order(dev, params),
               "norm_row_order": norm_row_order(
                   dev, only=("rms_norm_7168", "kv_a_norm_512",
                              "q_a_norm_1536"))}
    emit("mla_row_order", **observe)
    peak = torch.cuda.max_memory_allocated()
    decode_bytes = weights - mtp_bytes - params["embed"].numel() \
        * params["embed"].element_size()
    del params
    free_memory()
    agree_g = float(np.mean([a == b for k in dense
                             for a, b in zip(dense[k], glob[k])]))
    rec = dict(
        arch=MLA_ARCH, layers=cfg.n_layers, experts=cfg.n_experts,
        top_k=cfg.experts_per_token, weights_gb=weights / 1e9,
        decode_bytes_gb=decode_bytes / 1e9,
        decode_bound_ms=decode_bytes / HBM_BW * 1e3,
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
        dense_vs_global_tokens=agree_g,
        shared_chunks_4_layers={k: shared4[k] for k in (
            "prompt_tokens", "prefill_tokens_computed",
            "prefix_tokens_shared", "cow_copies", "prefill_chunks",
            "step_ms_median", "launches")},
        spec_4_layers=spec4,
        schemes=sorted({e.split(":")[1]
                        for e in rec_dense["selection_trace"]}),
        decode_device_ms=prof["device_ms_per_step"],
        decode_idle_share=prof["idle_share"],
        k1_decode_step=t1, score=score, peak_memory_gb=peak / 1e9,
        seconds=time.perf_counter() - t0)
    emit("mla", **rec)
    return {"rec": rec, "batched": batched, "family_checks": fchecks,
            "k1": t1, "stack": stack, "spec": spec4, "tp1": tp1,
            "prompts": prompts}


def mla_tp1(dev, model, params, prompts) -> dict:
    """The TP=1 side of the ``tp_mla`` phase, kept on the host so that the
    4-layer model need not be drawn twice: ``tp_serve``'s dense run of the
    engine cell's traffic (its first prefill and decode logits, every
    emitted token's top-two gap, every model call, every routing decision
    with the router's probabilities), its eviction run under
    ``_mla_tp_faults``' hard fault, and the 1 x ``HYBRID_SCORE_L`` score
    with its ``mtp_logits`` and routing (``_hybrid_score``)."""
    faults = _mla_tp_faults(model.cfg)
    routes = []
    _, rec, timing, cap = tp_serve(model, params, prompts, dev, "tp1",
                                   capture=prompts, routes=routes)
    _, hard, _, _ = tp_serve(model, params, prompts, dev, "tp1_hard",
                             fault_at=(1, faults["hard"]), max_retries=0,
                             capture=False)
    score = _hybrid_score(model, params, dev, model.cfg)
    emit("tp_mla_reference", tokens=rec["stats"]["tokens"],
         decode_step_ms_median=float(np.median(timing["step_ms"])),
         k1_per_step=timing["k1_per_step"],
         k1_batched_per_step=timing["k1b_per_step"],
         evicted=sorted(hard["errors"]), routing_entries=len(routes))
    return {"rec": rec, "timing": timing, "hard": hard, "score": score,
            "logits": {k: v.numpy() for k, v in cap.first.items()},
            "gaps": cap.gaps, "calls": cap.calls, "routes": routes}


def _add_mla(kernels, mla) -> None:
    """K1's line gets ``mla``: its launches (2-D and batched over
    experts) on the dense serving run of the 4-layer model, the worst
    errors of the batched checks at E = 256 and of the 2-D sites' checks,
    and the times of a layer's expert GEMMs at C = 4 and 40 and of a
    decode step's 2-D GEMMs; K2's and K3's lines get ``mla_launches``:
    0 on every run of the MLA path (each counted and held to 0)."""
    rec = mla["rec"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        if entry["name"] == "abft_matmul":
            entry["mla"] = {
                "launches": rec["launches"]["abft_matmul"],
                "batched_launches": rec["launches"]["abft_matmul_batched"],
                "batched_launches_per_step":
                    rec["batched_launches_per_step"],
                "max_abs_err": mla["batched"]["checks"]["max_abs_err_y"],
                "sites_max_abs_err":
                    mla["family_checks"]["k1_max_abs_err"],
                "by_shape": {
                    **{name: {"launches": t["launches"],
                              **{k: t[k] for k in keys}}
                       for name, t in mla["batched"]["timing"].items()},
                    "decode_step_m4": {"launches": mla["k1"]["gemms"],
                                       **{k: mla["k1"][k] for k in keys}}}}
        else:
            key = entry["name"]
            entry["mla_launches"] = {
                "serve_dense": rec["launches"][key],
                "serve_paged": rec["paged_launches"][key],
                "score": rec["score"]["launches"].get(key, 0),
                **{f"dense_stack {n}": r["launches"][key]
                   for n, r in mla["stack"].items()},
                **{f"4-layer {n}": r["launches"][key]
                   for n, r in mla["spec"]["runs"].items()}}


# ------------------------------------------------------------------ ssm

SSM_ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
# jamba at its published widths cut to 8 of its 32 layers: one unit of
# its interleave (mamba:moe, mamba:dense x 3 around attn:moe at 4), so
# every layer kind it has runs (13.3e9 parameters, 26.5 GB in bf16; the
# whole model's 102.9 GB does not fit the card); mamba2-1.3b runs whole
JAMBA_LAYERS = 8
# the score's logits gate: error against the f32 run (routed alike), as
# a share of the logits' scale (MLA_SCORE_TOL's bound)
SSM_SCORE_TOL = 0.05
# decode-time faults a stack's engine cell recovers: (layer, site)
SSM_FAULTS = {"mamba2-1.3b": ((1, "ssm_in"), (23, "ssm_out")),
              "jamba-v0.1-52b": ((0, "ssm_in"), (2, "expert_up"),
                                 (4, "qkv"))}


def ssm_config(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_LAYERS)
    elif arch in DEPTH_CUTS:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUTS[arch])
    return cfg


def _ssm_states(eng) -> list:
    """Copies of every per-slot state leaf of ``eng``'s cache."""
    return [t.clone() for layer, st in zip(eng.cache, eng.model.state_layers)
            if st for t in layer.values()]


def _states_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def ssm_batched_checks(dev, cfg, params) -> dict:
    """K1 batched over jamba's 16 experts (K, N = 4096, 14336 and 14336,
    4096; the model's own layer-0 weights), bf16 mode 1s, against its
    plain version at the capacities of a decode step (C = 4) and of an
    admission of 4 x 256 tokens (``moe.capacity``: 160), one launch a
    call, with a value fault flagged in every expert at its block and row
    (``_moe_fault_check``); then the layer's three expert GEMMs timed at
    both (``moe_k1_timing``).  Tolerances as ``moe_k1_checks``."""
    from repro_torch.models.moe import capacity

    ffn = params["layers"][0]["ffn"]
    caps = (capacity(cfg, 4), capacity(cfg, 4 * 256))
    gen = torch.Generator(device=dev).manual_seed(37)
    ratio, worst, cases = 0.0, 0.0, 0
    for name in ("w_up", "w_down"):
        for C in caps:
            err, r = _batched_case(dev, gen, ffn[name], C,
                                   f"jamba {name} C={C}")
            worst, ratio, cases = max(worst, err), max(ratio, r), cases + 1
    need(ratio < 1, f"ssm batched K1 clean residual at {ratio} of its "
         f"threshold")
    free_memory()
    rec = {"E": cfg.n_experts, "capacities": caps, "cases": cases,
           "max_abs_err_y": worst,
           "worst_clean_residual_over_threshold": ratio}
    emit("ssm_k1_batched_check", arch=cfg.name, **rec)
    return {"checks": rec,
            "timing": moe_k1_timing(dev, params, caps,
                                    phase="ssm_k1_batched_timing")}


def ssm_score(dev, model, params) -> dict:
    """``Model.forward`` at 1 x 1024 under ``IntensityGuidedPolicy`` with
    ``flash_attention`` on: logits finite, (1, 1024, V) f32, no flag; K2
    once an attention layer (none in mamba2), K1 batched three times a
    MoE layer.  Held against the same weights run in f32 layer by layer
    (``_f32_layerwise_routed``: plain f32 products, MoE layers routed as
    this run routes, so both drop the same tokens at capacity; the head
    in column chunks): the logits within ``SSM_SCORE_TOL`` of their scale
    at every position; the argmax agreement and, with MoE layers, the
    experts the f32 run's own probabilities pick (``_routing_diff``)
    recorded."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.models.layers import LayerCtx
    from repro_torch.models.model import layer_tags

    K1, K1B = abft_matmul.KERNEL, abft_matmul.BATCHED
    K2 = flash_attention.FULL_KERNEL
    cfg = model.cfg
    tags = layer_tags(cfg)
    n_moe = sum(t.split(":")[1] == "moe" for t in tags)
    n_attn = sum(t.startswith("attn") for t in tags)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(SCORE_B, SCORE_L)).astype(np.int64)).to(dev)
    ctx = LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
        flash_attention=True))
    torch.cuda.synchronize()
    K1.launches = K1B.launches = K2.launches = 0        # THIS run's
    t = time.perf_counter()
    with torch.no_grad(), _routing_log() as routes:
        out = model.forward(params, {"tokens": tokens}, ctx, device=dev)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    launches = {"abft_matmul": K1.launches,
                "abft_matmul_batched": K1B.launches,
                "flash_attention": K2.launches}
    lg = out.logits
    need(lg.shape == (SCORE_B, SCORE_L, cfg.vocab_size)
         and lg.dtype == torch.float32, f"ssm score: logits "
         f"{tuple(lg.shape)}")
    need(bool(torch.isfinite(lg).all()), f"{cfg.name} score: non-finite "
         f"logits")
    need(not bool(out.flag), f"{cfg.name} score: a clean forward flagged")
    need(K2.launches == n_attn, f"{cfg.name} score: K2 launched "
         f"{K2.launches} times, expected {n_attn}")
    need(K1B.launches == 3 * n_moe and len(routes) == n_moe,
         f"{cfg.name} score: batched K1 launched {K1B.launches} times, "
         f"{len(routes)} MoE layers routed; expected {3 * n_moe}, {n_moe}")
    need(K1.launches > 0, f"{cfg.name} score: K1 never launched")
    with torch.no_grad():
        h32, _, routes_32 = _f32_layerwise_routed(model, params, tokens,
                                                  routes)
        head = params["lm_head"] if "lm_head" in params \
            else params["embed"].t()
        err = torch.zeros(lg.shape[:2], device=dev)
        best32 = torch.full(lg.shape[:2], -float("inf"), device=dev)
        arg32 = torch.zeros(lg.shape[:2], dtype=torch.long, device=dev)
        for c0 in range(0, cfg.vocab_size, 16384):
            l32 = h32 @ head[:, c0:c0 + 16384].float()
            err = torch.maximum(err, (lg[..., c0:c0 + 16384] - l32)
                                .abs().amax(-1))
            m, a = l32.max(-1)
            arg32 = torch.where(m > best32, a + c0, arg32)
            best32 = torch.maximum(best32, m)
        del h32, l32
    scale = lg.abs().max().item()
    worst = err.max().item()
    rec = dict(B=SCORE_B, L=SCORE_L, launches=launches, ms=ms,
               tokens_per_s=SCORE_B * SCORE_L / (ms / 1e3),
               aux_loss=float(out.aux_loss), logits_scale=scale,
               logits_max_abs_err_vs_f32=worst,
               tolerance=SSM_SCORE_TOL * scale,
               argmax_agreement_vs_f32=(lg.argmax(-1) == arg32).float()
               .mean().item())
    if n_moe:
        rec["routing_vs_f32_own"] = _routing_diff(routes, routes_32, err,
                                                  SCORE_L)
    del out, lg
    emit("ssm_score", arch=cfg.name, **rec)
    need(worst <= SSM_SCORE_TOL * scale, f"{cfg.name} score: logits vs "
         f"f32 {worst} > {SSM_SCORE_TOL} x scale {scale}")
    return rec


def ssm_arch(dev, arch) -> dict:
    """One SSM-family config at published widths (mamba2-1.3b whole,
    jamba-v0.1-52b cut to ``JAMBA_LAYERS``; bf16 weights from seed 0,
    made on the card): the plan; K1 at every 2-D site against its plain
    version (``family_checks``; faults at ``ssm_in_x`` and ``ssm_out``),
    K2 at the attention heads and K1 batched over the experts
    (``ssm_batched_checks``) where the stack has them; serving (4 slots,
    max_len 512, 8 requests of 16-256 tokens, 16 new each, flash on):
    dense and paged streams equal, no clean flag, K1 every run, K3 once an
    attention layer a decode step (never in mamba2), K1 batched three
    times a MoE layer a decode step; each fault of ``SSM_FAULTS`` at
    decode step 3 detected, retried and giving the clean streams, with
    every slot's ``ssm``/``conv_*`` state after the run bit-equal to the
    clean run's; a sticky ``ssm_out`` fault evicting its residents with
    ``hard_fault:decode``; ``global`` clean without K1; a protected
    campaign corrected to the clean streams and an unprotected one whose
    shadow runs record ``tokens_match`` and ``state_match``; the decode
    profile; K3 held layer by layer on the engine's cache (``k3_timing``);
    the score (``ssm_score``); K1 over a decode step's 2-D GEMMs and K2 at
    the score's shape timed.  Frees its weights before it returns."""
    from repro_torch.core.faults import FaultModel, FaultSpec
    from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
    from repro_torch.core.schemes import Scheme
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model, layer_tags

    t0 = time.perf_counter()
    cfg = ssm_config(arch)
    model = Model(cfg)
    tags = layer_tags(cfg)
    n_moe = sum(t.split(":")[1] == "moe" for t in tags)
    n_attn = sum(t.startswith("attn") for t in tags)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params, prompts = engine_inputs(dev, cfg=cfg)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    emit("ssm_plan", arch=arch, layers=cfg.n_layers, tags=tags,
         init_s=time.perf_counter() - t1, weights_gb=weights / 1e9,
         **family_plan(cfg))
    batched = ssm_batched_checks(dev, cfg, params) if n_moe else None
    fchecks = family_checks(dev, cfg, params, k2=bool(n_attn))
    emit("ssm_family_check", arch=arch, **fchecks)

    def serve(cache_kind="dense", policy=None, fault_at=None, label="",
              reqs=None, new=16):
        return engine_serve(model, params, prompts if reqs is None else reqs,
                            dev, cache_kind, policy or IntensityGuidedPolicy(),
                            fault_at=fault_at, label=f"{arch} {label}",
                            phase="ssm_engine", max_new_tokens=new)

    serve(label="warmup", reqs=prompts[:1], new=2)
    audit_served(dev, model, params, prompts, arch)
    free_memory()
    dense, rec_dense, eng = serve(label="dense")
    clean_state = _ssm_states(eng)
    prof = decode_profile(dev, {"engine": eng, "params": params,
                                "prompts": prompts, "dense": rec_dense})
    emit("ssm_decode_profile", arch=arch, **prof)
    t3 = k3_timing(dev, eng, prompts, long_context=False) \
        if n_attn else None
    del eng
    free_memory()
    paged, rec_paged, _ = serve("paged", label="paged")
    free_memory()
    for rec in (rec_dense, rec_paged):
        lc = rec["launches"]
        need(lc["abft_matmul"] > 0, f"{arch} {rec['label']}: K1 never "
             f"launched")
        need(lc["flash_decode"] == n_attn * rec["decode_steps"],
             f"{arch} {rec['label']}: K3 launched {lc['flash_decode']} "
             f"times over {rec['decode_steps']} decode steps, expected "
             f"{n_attn} a step")
        need(n_attn or lc["flash_attention"] == 0,
             f"{arch} {rec['label']}: K2 launched without attention")
        need(not n_moe or rec["batched_launches_per_step"] == {
            str(3 * n_moe): rec["decode_steps"]},
             f"{arch} {rec['label']}: batched K1 launches a decode step "
             f"{rec['batched_launches_per_step']}, expected {3 * n_moe}")
        need(rec["faults_detected"] == 0, f"{arch} {rec['label']}: a clean "
             f"run raised a flag")
    need(paged == dense, f"{arch}: paged streams differ from dense")
    faults = {}
    for layer, site in SSM_FAULTS[arch]:
        fault = ModelFault.at(layer, site, FaultSpec.value(0, 1, 1e5))
        faulted, rec_fault, eng = serve(fault_at=(3, fault),
                                        label=f"dense_{site}_l{layer}_fault")
        same_state = _states_equal(_ssm_states(eng), clean_state)
        del eng
        free_memory()
        need(rec_fault["faults_detected"] >= 1
             and rec_fault["retries"] >= 1,
             f"{arch}: {site} (layer {layer}) fault not detected and "
             f"retried")
        need(faulted == dense, f"{arch}: the {site} fault run's streams "
             f"differ from the clean run")
        need(same_state, f"{arch}: after the {site} fault run a slot's "
             f"state differs from the clean run's")
        faults[f"{site}_l{layer}"] = dict(
            faults_detected=rec_fault["faults_detected"],
            retries=rec_fault["retries"], state_equal=True)
    glob, rec_glob, _ = serve(policy=FixedPolicy(Scheme.GLOBAL),
                              label="dense_global")
    free_memory()
    need(rec_glob["faults_detected"] == 0, f"{arch}: global false flag")
    need(rec_glob["launches"]["abft_matmul"] == 0,
         f"{arch}: the global run launched K1")

    def fm(**kw):
        base = dict(transient_rate=CAMPAIGN_RATE, seed=0,
                    layers=cfg.n_layers, dtype=torch.float32,
                    magnitude=CAMPAIGN_MAG, sites=("ssm_in", "ssm_out"))
        base.update(kw)
        return FaultModel(**base)

    def run(label, **kw):
        out = _serve_run(model, params, prompts, dev, f"{arch} {label}",
                         **kw)
        emit("ssm_campaign", **out["rec"])
        free_memory()
        return out

    perm = run("permanent", policy=FixedPolicy(Scheme.BLOCK_1S),
               fault_model=fm(transient_rate=0.0, permanent_rate=0.2,
                              permanent_duration=4, sites=("ssm_out",)))
    prc = perm["rec"]
    errs = {r.error for r in perm["reqs"] if r.error}
    need(prc["hard_faults"] >= 1 and prc["evictions"] >= 1
         and errs == {"hard_fault:decode"},
         f"{arch}: sticky fault did not become a hard fault: {prc} {errs}")
    prot = run("protected", fault_model=fm())
    pr = prot["rec"]
    need(pr["faults_injected"] > 0 and pr["sdc_faults"] == 0
         and _accounted(pr), f"{arch} protected campaign: {pr}")
    need(prot["results"] == dense, f"{arch}: the protected campaign's "
         f"streams differ from the clean run")
    off = run("abft_off", abft_on=False, fault_model=fm(), classify=True)
    orc = off["rec"]
    log = off["eng"].stats.injection_log
    need(orc["faults_injected"] > 0 and _accounted(orc)
         and orc["faults_detected"] == 0
         and all("state_match" in e and "tokens_match" in e for e in log),
         f"{arch}: unprotected campaign not shadow-classified: {orc}")
    campaign = dict(
        permanent=dict(hard_faults=prc["hard_faults"],
                       evictions=prc["evictions"]),
        protected={k: pr[k] for k in ("faults_injected", "faults_corrected",
                                      "seconds")},
        abft_off={**{k: orc[k] for k in ("faults_injected", "sdc_faults",
                                         "masked_faults", "shadow_runs",
                                         "shadow_ms")},
                  "state_match": sum(bool(e["state_match"]) for e in log),
                  "tokens_match": sum(bool(e["tokens_match"])
                                      for e in log)})
    del perm, prot, off
    free_memory()
    score = ssm_score(dev, model, params)
    free_memory()
    t1 = k1_timing(dev, params, 4, arch=arch)
    t2 = (k2_timing(dev, (SCORE_B, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim), SCORE_L, arch=arch)
          if n_attn else None)
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(t.numel() * t.element_size() for t in clean_state)
    del params, clean_state
    free_memory()
    agree_g = float(np.mean([a == b for k in dense
                             for a, b in zip(dense[k], glob[k])]))
    rec = dict(
        arch=arch, layers=cfg.n_layers, tags=sorted(set(tags)),
        weights_gb=weights / 1e9, state_gb=state_bytes / 1e9,
        decode_bound_ms=(weights + 2 * state_bytes) / HBM_BW * 1e3,
        tokens_per_s=rec_dense["tokens_per_s"],
        paged_tokens_per_s=rec_paged["tokens_per_s"],
        decode_step_ms_median=rec_dense["decode_step_ms_median"],
        paged_decode_step_ms_median=rec_paged["decode_step_ms_median"],
        prefill_ms_per_admission=rec_dense["prefill_ms"],
        launches=rec_dense["launches"],
        paged_launches=rec_paged["launches"],
        batched_launches_per_step=rec_dense["batched_launches_per_step"],
        dense_equals_paged=True, faults_recomputed=faults,
        campaign=campaign, global_tokens_per_s=rec_glob["tokens_per_s"],
        dense_vs_global_tokens=agree_g,
        schemes=sorted({e.split(":")[1]
                        for e in rec_dense["selection_trace"]}),
        decode_device_ms=prof["device_ms_per_step"],
        decode_idle_share=prof["idle_share"],
        kernels_per_decode_step=prof["kernels_per_step"],
        k1_decode_step=t1, score=score, peak_memory_gb=peak / 1e9,
        seconds=time.perf_counter() - t0)
    emit("ssm", **rec)
    return {"rec": rec, "checks": fchecks, "batched": batched, "k1": t1,
            "k2": t2, "k3": t3}


def ssm_runs(dev) -> dict:
    """mamba2-1.3b, then jamba-v0.1-52b (``ssm_arch``)."""
    out = {}
    for arch in SSM_ARCHS:
        out[arch] = ssm_arch(dev, arch)
        free_memory()
    return out


def _add_ssm(kernels, ssm) -> None:
    """Each kernel's line gets ``by_arch`` rows for the SSM family: its
    launches on the dense serving run (K1, K3) or the score (K2), and its
    time, plain time, bound and library time at that arch's shapes (K1: a
    decode step's 2-D GEMMs, and jamba's expert GEMMs at C = 4 and 160;
    K2: the score's attention layer; K3: the decode step's layer on the
    engine's cache).  mamba2 has no attention: K2 and K3 launch 0 times
    and have no shape to time (null)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        rows = entry.setdefault("by_arch", {})
        for arch, out in ssm.items():
            rec = out["rec"]
            if entry["name"] == "abft_matmul":
                row = {"launches": rec["launches"]["abft_matmul"],
                       "batched_launches":
                           rec["launches"]["abft_matmul_batched"],
                       "max_abs_err": out["checks"]["k1_max_abs_err"],
                       **{k: out["k1"][k] for k in keys}}
                if out["batched"] is not None:
                    row["batched_max_abs_err"] = \
                        out["batched"]["checks"]["max_abs_err_y"]
                    row["by_shape"] = {
                        name: {"launches": t["launches"],
                               **{k: t[k] for k in keys}}
                        for name, t in out["batched"]["timing"].items()}
            else:
                flash = entry["name"] == "flash_attention"
                t = out["k2"] if flash else out["k3"]
                n = (rec["score"]["launches"]["flash_attention"] if flash
                     else rec["launches"]["flash_decode"])
                row = {"launches": n,
                       "max_abs_err": None if t is None
                       else t["max_abs_err"],
                       **{k: None if t is None else t[k] for k in keys}}
            rows[arch] = row


# ------------------------------------------------------------------ cross

CROSS_ARCHS = ("whisper-tiny", "llama-3.2-vision-11b")
# the vision model's cross gates: the reference initialises them to 0,
# where tanh(0) = 0 and the images never reach the logits, so nothing of
# the cross path would be held to anything; every gate of the phase is
# set to this (tanh(0.5) = 0.46 of each cross layer's output passes)
CROSS_GATE = 0.5
# whisper's published 30 s window: 3000 log-mel frames, 1500 after the
# stem; K2's non-causal blocks take no padding (1500 pads to 1536 and
# raises, as the reference asserts), so the paths on K2 get 2048 mel
# frames (1024 after the stem, 20.48 s of audio)
WHISPER_MELS, WHISPER_FLASH_MELS = 3000, 2048
WHISPER_L = 448                  # whisper's decoder context, the score's L
# the scores' gates: the bf16 run's memory, and whisper's logits (4
# layers), against the same weights run in f32 (layer by layer), as a
# share of each one's scale.  The vision model's logits through 40 bf16
# layers are held as ``family_score`` holds the dense family's (qwen3-14b's
# 40 bf16 layers sit 6.4% of the scale off f32 in the ``family`` phase):
# the flash path against the chunked path's own error
CROSS_SCORE_TOL = 0.05
# new tokens a request: whisper 32 decode steps after its prefill's
# token, the vision model 16 tokens
CROSS_NEW = {"whisper-tiny": 33, "llama-3.2-vision-11b": 16}
CROSS_MAX_LEN, CROSS_BS = 512, 16
# llama-3.2-vision-11b's depth run: 20 of its 40 layers (4 cross layers;
# PR 29 cut 40 to 20 after a 1301 s run on a slow host)
VISION_LAYERS = 20


def cross_config(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.vision_dim and VISION_LAYERS < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=VISION_LAYERS)
    return cfg


def _memory_inputs(cfg, B, dev, seed, mels=WHISPER_MELS):
    """Random bf16 memory inputs from ``seed``: whisper's ``audio``
    (B, mels, 80) log-mel frames, the vision model's ``images`` (B, 1601,
    1280) patch embeddings (its frontend is a stub in the reference
    too)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.is_encoder_decoder:
        shape, name = (B, mels, cfg.n_mels), "audio"
    else:
        shape, name = (B, cfg.n_image_tokens, cfg.vision_dim), "images"
    return {name: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)}


def _cross_ctx(flash: bool = True, fault=None):
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.models.layers import LayerCtx

    return LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
        flash_attention=flash), fault=fault)


def memory_k1_checks(dev, cfg, sites) -> dict:
    """K1 against its plain version at the memory path's GEMM sites:
    ``sites`` maps a name to (weight, output dtype, row counts, fault);
    ``_k1_site_check`` at each row count, its fault where set."""
    gen = torch.Generator(device=dev).manual_seed(21)
    ratios, routes_taken, worst, worst_abs = {}, {}, 0.0, 0.0
    for name, (w, out_dtype, ms, faulted) in sites.items():
        for m in ms:
            tag = f"{name}_m{m}"
            err, scale, ratios[tag], routes_taken[tag] = _k1_site_check(
                dev, gen, cfg, tag, w, out_dtype, m, faulted=faulted)
            worst = max(worst, err / max(scale, 1e-30))
            worst_abs = max(worst_abs, err)
    need(all(v < 1 for v in ratios.values()),
         f"K1 clean residual at or over its threshold: {ratios}")
    rec = {"k1_max_rel_err_y": worst, "k1_max_abs_err": worst_abs,
           "k1_routes": routes_taken,
           "k1_worst_clean_residual_over_threshold": max(ratios.values()),
           "faulted_sites": [s for s, v in sites.items() if v[3]]}
    emit("cross_k1_check", arch=cfg.name, **rec)
    return rec


def k2_noncausal_check(dev, cfg, L: int = 1024, B: int = 2) -> dict:
    """K2 non-causal at ``cfg``'s heads (whisper: H = KV = 6, D = 64) over
    L = 1024 frames, bf16, against its plain version (the tolerances of
    ``k2_checks``: each element within 2^-7 |o_ref| + 1e-5 max|o|, bounds
    within 1e-4 relative, clean residuals under their thresholds); 1500
    frames raise in the wrapper, as the reference's assert does."""
    from repro_torch.core.checksums import ATOL, tolerance_scale
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel,
        flash_attention_ref,
        tc_path,
    )
    from repro_torch.kernels.flash_ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(22)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _k2_inputs(gen, dev, B, L, H, KV, D, torch.bfloat16)
    kw = dict(causal=False, **_k2_blocks(L))
    got = flash_attention_kernel(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    o_ref = ref[0].float()
    share = ((got[0].float() - o_ref).abs()
             / (2 ** -7 * o_ref.abs() + 1e-5 * o_ref.abs().max())).max()
    need(share.item() <= 1, f"K2 non-causal {cfg.name}: an element off by "
         f"{share.item()} x its tolerance")
    for gi, ri, nm in ((got[2], ref[2], "bnd_s"), (got[4], ref[4], "bnd_pv")):
        rel = ((gi - ri).abs() / ri.abs().clamp_min(1e-30)).max().item()
        need(rel <= 1e-4, f"K2 non-causal {cfg.name} {nm}: rel {rel}")
    ratio = max(
        (got[1] / (ATOL + tolerance_scale(D) * got[2])).max().item(),
        (got[3] / (ATOL + tolerance_scale(L) * got[4])).max().item())
    need(ratio < 1, f"K2 non-causal {cfg.name}: clean residual over "
         f"threshold")
    _, chk = flash_attention(q, k, v, causal=False)
    need(not bool(chk.flag), f"K2 non-causal {cfg.name}: false flag")
    q15, k15, v15 = _k2_inputs(gen, dev, 1, 1500, H, KV, D, torch.bfloat16)
    try:
        flash_attention(q15, k15, v15, causal=False)
    except ValueError:
        pass
    else:
        fail("K2 non-causal at 1500 frames did not raise")
    rec = {"B": B, "L": L, "H": H, "KV": KV, "D": D,
           "tc": tc_path(q, k, v, kw["bk"]),
           "bf16_worst_err_over_tolerance": share.item(),
           "max_abs_err": (got[0].float() - o_ref).abs().max().item(),
           "worst_clean_residual_over_threshold": ratio,
           "raises_at_1500_frames": True}
    emit("cross_k2_check", arch=cfg.name, **rec)
    return rec


def _memory_f32(model, params, inputs):
    """The memory of ``inputs`` run in f32 (ABFT off, TF32 off): the f32
    stem and encoder (whisper: 8M parameters) or the f32 projection
    (vision), through the model's own ``_memory``."""
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    dev = params["embed"].device
    f32 = {"embed": torch.zeros(1, device=dev),
           **{k: tree_map(lambda t: t.float(), params[k])
              for k in ("encoder", "conv_stem", "vision_proj")
              if k in params}}
    mem, _ = model._memory(f32, {k: v.float() for k, v in inputs.items()},
                           LayerCtx(abft=ABFTConfig(enabled=False)), dev)
    return mem


def memory_score(dev, model, params, tokens, inputs, flash: bool,
                 label: str, moved_by=None) -> dict:
    """``Model.forward`` of ``tokens`` with its memory ``inputs`` under
    ``IntensityGuidedPolicy``, flash on or off: logits finite, f32, no
    flag; K2 once an attention layer of both stacks with flash on (the
    encoder's non-causal), never with it off.  The memory (``_memory``)
    held within ``CROSS_SCORE_TOL`` of its scale; the logits (the head in column chunks) too, unless
    ``moved_by`` is given (the vision model); both against
    ``_memory_f32`` and ``_forward_f32_layerwise``.  There the flash run is
    held as ``family_score`` holds it: the same forward on the chunked
    path, its error against f32 at most 1.5 x the chunked path's and the
    two paths apart by at most 2.5 x it; the same inputs again give
    bit-equal logits, and the other memory inputs ``moved_by`` other
    logits (the images reach them through the open gates)."""
    from repro_torch.kernels import abft_matmul, flash_attention

    K1, K2 = abft_matmul.KERNEL, flash_attention.FULL_KERNEL
    cfg = model.cfg
    batch = {"tokens": tokens, **inputs}

    def run(on, b=batch):
        torch.cuda.synchronize()
        K1.launches = K2.launches = 0
        t = time.perf_counter()
        with torch.no_grad():
            out = model.forward(params, b, _cross_ctx(on), device=dev)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t), {
            "abft_matmul": K1.launches, "flash_attention": K2.launches}

    ctx = _cross_ctx(flash)
    out, ms, launches = run(flash)
    lg = out.logits
    B, L = tokens.shape
    need(lg.shape == (B, L, cfg.vocab_size) and lg.dtype == torch.float32,
         f"{cfg.name} {label}: logits {tuple(lg.shape)}")
    need(bool(torch.isfinite(lg).all()), f"{cfg.name} {label}: non-finite "
         f"logits")
    need(not bool(out.flag), f"{cfg.name} {label}: a clean forward flagged")
    n_attn = cfg.n_layers + (cfg.n_enc_layers if cfg.is_encoder_decoder
                             else 0)
    need(K2.launches == (n_attn if flash else 0), f"{cfg.name} {label}: K2 "
         f"launched {K2.launches} times, expected {n_attn if flash else 0}")
    need(K1.launches > 0, f"{cfg.name} {label}: K1 never launched")
    lc = None
    if moved_by is not None:
        chunked, ms_c, _ = run(False)
        lc = chunked.logits
        need(not bool(chunked.flag) and bool(torch.isfinite(lc).all()),
             f"{cfg.name} {label}: the chunked forward flagged or is not "
             f"finite")
        again, _, _ = run(flash)
        same = torch.equal(again.logits, lg)
        other, _, _ = run(flash, {"tokens": tokens, **moved_by})
        moved = (other.logits - lg).abs().max().item()
        del chunked, again, other
    with torch.no_grad():
        mem, _ = model._memory(params, inputs, ctx, dev)
        mem32 = _memory_f32(model, params, inputs)
        mem_err = (mem.float() - mem32).abs().max().item()
        mem_scale = mem32.abs().max().item()
        h32 = _forward_f32_layerwise(model, params, tokens, mem32)
        del mem, mem32
        head = params["lm_head"] if "lm_head" in params \
            else params["embed"].t()
        err = err_c = diff = 0.0
        for c0 in range(0, cfg.vocab_size, 16384):
            c1 = min(c0 + 16384, cfg.vocab_size)
            l32 = h32 @ head[:, c0:c1].float()
            err = max(err, (lg[..., c0:c1] - l32).abs().max().item())
            if lc is not None:
                err_c = max(err_c, (lc[..., c0:c1] - l32).abs().max().item())
                diff = max(diff, (lg[..., c0:c1] - lc[..., c0:c1]).abs()
                           .max().item())
        del h32, l32
    scale = lg.abs().max().item()
    rec = dict(label=label, B=B, L=L, memory_shape=[
        list(v.shape) for v in inputs.values()], flash=flash,
        launches=launches, ms=ms, tokens_per_s=B * L / (ms / 1e3),
        memory_scale=mem_scale, memory_max_abs_err_vs_f32=mem_err,
        logits_scale=scale, logits_max_abs_err_vs_f32=err,
        tolerance_share=CROSS_SCORE_TOL)
    if lc is not None:
        rec.update(chunked_ms=ms_c, logits_max_abs_err_chunked_vs_f32=err_c,
                   logits_max_abs_diff_flash_vs_chunked=diff,
                   same_memory_bit_equal=same,
                   logits_moved_by_other_memory=moved)
    del out, lg, lc
    emit("cross_score", arch=cfg.name, **rec)
    need(mem_err <= CROSS_SCORE_TOL * mem_scale, f"{cfg.name} {label}: "
         f"memory vs f32 {mem_err} > {CROSS_SCORE_TOL} x {mem_scale}")
    if moved_by is None:
        need(err <= CROSS_SCORE_TOL * scale, f"{cfg.name} {label}: logits "
             f"vs f32 {err} > {CROSS_SCORE_TOL} x {scale}")
        return rec
    need(err <= 1.5 * err_c, f"{cfg.name} {label}: flash vs f32 err {err} "
         f"> 1.5 x the chunked path's {err_c}")
    need(diff <= 2.5 * err_c, f"{cfg.name} {label}: flash vs chunked "
         f"logits {diff} > 2.5 x {err_c} (chunked vs f32)")
    need(same and moved > 0, f"{cfg.name} {label}: the same images gave "
         f"bit-equal logits: {same}; other images moved them by {moved}")
    return rec


def _cross_leaves(cache) -> list:
    return [t.clone() for layer in cache
            for t in layer.get("cross", {}).values()]


def memory_serve(dev, model, params, prompts, inputs, cache_kind, *,
                 new: int, label: str, prefill_fault=None,
                 decode_fault=None, profile_steps: int = 0) -> tuple:
    """Model-level serving (the engine refuses a memory model, as the
    reference's cannot serve one): the prompts (one request a row, each
    with its own memory in ``inputs``) prefilled at once into slots
    0..B-1 of a batch-deep cache or of 16-token pools through a block
    table, ragged lengths, then ``new - 1`` greedy decode steps of every
    row, flash on; each call timed to a synchronize, K1/K2/K3 counted
    from 0.  ``prefill_fault``/``decode_fault``: a ``ModelFault`` on the
    prefill, or on decode step 3, whose call must be flagged; the clean
    call is then made again in its place (a prefill rewrites every cell
    and cross row it wrote, a decode step its cursor's cells).  The cross
    K/V after the prefill must stay unchanged through decode.
    ``profile_steps``: that many more decode steps under
    ``torch.profiler`` after the run (``_profile_steps``).  Returns
    (streams, record, cache)."""
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.paged_cache import BlockPool

    K1, K2, K3 = (abft_matmul.KERNEL, flash_attention.FULL_KERNEL,
                  flash_attention.KERNEL)
    cfg = model.cfg
    B = len(prompts)
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((B, int(lengths.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tok_t = torch.from_numpy(toks).to(dev)
    len_t = torch.from_numpy(lengths).to(dev)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    if cache_kind == "dense":
        cache = model.init_cache(B, CROSS_MAX_LEN, dtype=torch.bfloat16,
                                 device=dev)
        tables = None
    else:
        width = CROSS_MAX_LEN // CROSS_BS
        pool = BlockPool(B * width, CROSS_BS, B, width)
        for s, n in enumerate(lengths):
            pool.alloc(s, int(n) + new + profile_steps)
        cache = model.init_paged_cache(B * width, CROSS_BS,
                                       dtype=torch.bfloat16, device=dev,
                                       slots=B)
        tables = torch.from_numpy(pool.tables).to(dev)
    ctx = _cross_ctx(True)
    faults = 0

    def prefill(c):
        return model.prefill(params, tok_t, cache, c, slots=slots,
                             lengths=len_t, block_tables=tables,
                             inputs=inputs)

    torch.cuda.synchronize()
    K1.launches = K2.launches = K3.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        if prefill_fault is not None:
            _, _, flag = prefill(_cross_ctx(True, prefill_fault))
            need(bool(flag), f"{cfg.name} {label}: the prefill fault was "
                 f"not flagged")
            faults += 1
        lg, cache, flag = prefill(ctx)
        need(not bool(flag), f"{cfg.name} {label}: a clean prefill flagged")
        tok = lg[:, 0].argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k2_prefill = K2.launches
        cross0 = _cross_leaves(cache)
        streams = [[t] for t in tok.tolist()]
        pos = len_t.clone()
        step_ms, k3_steps = [], []
        for step in range(new - 1):
            t = time.perf_counter()
            k3 = K3.launches
            if decode_fault is not None and step == 3:
                _, _, flag = model.decode(params, tok[:, None], cache, pos,
                                          _cross_ctx(True, decode_fault),
                                          block_tables=tables)
                need(bool(flag), f"{cfg.name} {label}: the decode fault was "
                     f"not flagged")
                faults += 1
                k3 = K3.launches
            lg, cache, flag = model.decode(params, tok[:, None], cache, pos,
                                           ctx, block_tables=tables)
            need(not bool(flag), f"{cfg.name} {label}: a clean decode step "
                 f"flagged")
            tok = lg[:, 0].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            k3_steps.append(K3.launches - k3)
            for i, t in enumerate(tok.tolist()):
                streams[i].append(t)
            pos = pos + 1
    seconds = time.perf_counter() - t0
    need(all(torch.equal(a, b) for a, b in zip(cross0,
                                               _cross_leaves(cache))),
         f"{cfg.name} {label}: the cross K/V changed during decode")
    need(all(0 <= t < cfg.vocab_size for s in streams for t in s),
         f"{cfg.name} {label}: token out of range")
    rec = dict(label=label, cache=cache_kind, requests=B,
               prompt_lengths=lengths.tolist(), new_tokens=new,
               prefill_ms=prefill_ms, k2_prefill_launches=k2_prefill,
               decode_step_ms_median=float(np.median(step_ms)),
               decode_tokens_per_s=B * len(step_ms) / (sum(step_ms) / 1e3),
               seconds=seconds,
               launches={"abft_matmul": K1.launches,
                         "flash_attention": K2.launches,
                         "flash_decode": K3.launches},
               flash_decode_per_step=sorted(set(k3_steps)),
               faults_flagged=faults, cross_unchanged_in_decode=True)
    if profile_steps:
        rec["profile"] = _profile_steps(
            lambda: model.decode(params, tok[:, None], cache, pos, ctx,
                                 block_tables=tables),
            profile_steps, rec["decode_step_ms_median"])
    emit("cross_serve", arch=cfg.name, **rec)
    return streams, rec, cache


def _decode_bound_ms(params, cache, lengths) -> tuple:
    """The least a decode step of ``cache``'s rows can take: the bytes it
    must read once (every weight a decode step reads: not the memory path's
    stem, encoder, projection and cross K/V weights, nor the embedding
    table beyond its rows; the self-attention K/V at ``lengths``; every
    cross K/V) over the card's memory rate.  Returns (ms, bytes)."""
    from repro_torch.core.tree import tree_leaves_with_path

    byts = 0
    for path, t in tree_leaves_with_path(params):
        if path[0] in ("embed", "encoder", "conv_stem", "vision_proj") or (
                "cross" in path and path[-1] in ("wk", "wv")):
            continue
        byts += t.numel() * t.element_size()
    for layer in cache:
        if "k" in layer:
            per_tok = layer["k"][0, 0].numel() * layer["k"].element_size()
            byts += 2 * per_tok * int(sum(lengths))
        for t in layer.get("cross", {}).values():
            byts += t.numel() * t.element_size()
    return byts / HBM_BW * 1e3, byts


def whisper_train(dev, cfg) -> dict:
    """Two f32 train steps of full-size whisper-tiny with ``audio``
    (``make_train_step``, 2 x 128 tokens, 2 x 3000 x 80 mel frames, flash
    off: K2 has no backward), each held against the same step from the
    same state under ``--abft off``: loss within 1e-5 relative, grad norm
    within 1e-4 (``train_runs``' gate); finite, no flag, K1 launched."""
    from repro_torch.kernels import abft_matmul
    from repro_torch.launch.train import abft_config
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    K1 = abft_matmul.KERNEL
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 129))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev),
             **{k: v.float() for k, v in _memory_inputs(
                 cfg, 2, dev, 5).items()}}
    tcfg = TrainConfig(opt=OptConfig(lr=3e-4))
    on = make_train_step(model, abft_config("auto"), tcfg, device=dev)
    off = make_train_step(model, abft_config("off"), tcfg, device=dev)
    state = init_opt_state(params, tcfg.opt)
    steps = []
    for _ in range(2):
        K1.launches = 0
        t = time.perf_counter()
        p1, s1, m1 = on(params, state, batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        k1 = K1.launches
        _, _, m0 = off(params, state, batch)
        loss_rel = abs(m1["loss"].item() - m0["loss"].item()) \
            / abs(m0["loss"].item())
        gn_rel = abs(m1["grad_norm"].item() - m0["grad_norm"].item()) \
            / m0["grad_norm"].item()
        need(np.isfinite(m1["loss"].item()) and not bool(m1["abft_flag"])
             and k1 > 0, f"whisper train step: {m1['loss'].item()} "
             f"flag {bool(m1['abft_flag'])} K1 {k1}")
        need(loss_rel <= 1e-5 and gn_rel <= 1e-4, f"whisper train step vs "
             f"abft off: loss rel {loss_rel}, grad norm rel {gn_rel}")
        steps.append(dict(loss=m1["loss"].item(),
                          grad_norm=m1["grad_norm"].item(),
                          loss_rel_vs_off=loss_rel,
                          grad_norm_rel_vs_off=gn_rel, k1_launches=k1,
                          ms=ms))
        params, state = p1, s1
    emit("cross_train", arch=cfg.name, steps=steps)
    return {"steps": steps}


def _cross_prompts(cfg, n: int = 4) -> list:
    """``engine_inputs``' first ``n`` prompt lengths (16-256 tokens) with
    tokens of ``cfg``'s vocabulary."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 257, size=8)[:n]
    return [rng.integers(1, cfg.vocab_size, size=int(m)).astype(np.int32)
            for m in lens]


def cross_arch(dev, arch) -> dict:
    """One memory config at full size (whisper-tiny whole, the vision
    model's published widths at ``VISION_LAYERS``; bf16 weights from seed
    0, made on the card, every vision cross gate at ``CROSS_GATE``): K1 at
    the new GEMM sites (``memory_k1_checks``), whisper's K2 non-causal
    (``k2_noncausal_check``); the scores (``memory_score``: whisper at
    2 x 448 tokens over 3000 mel frames with flash off and over 2048 with
    flash on, vision at 1 x 1024 tokens with 1601 image tokens, flash on,
    the images moving the logits); serving (``memory_serve``: 4 requests
    of 16-256 tokens, each with its own memory, dense and paged, streams
    equal; whisper with a ``mlp_down`` decode fault, vision with a
    ``cross_qkv`` prefill fault, each recomputed to the clean streams);
    whisper's two train steps; the kernels timed at its shapes.  Frees
    its weights before it returns."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model, layer_tags

    t0 = time.perf_counter()
    cfg = cross_config(arch)
    model = Model(cfg)
    whisper = cfg.is_encoder_decoder
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = model.init_params(0, dtype=torch.bfloat16, device=dev)
    for lp in params["layers"]:
        if "cross_gate" in lp:
            lp["cross_gate"].fill_(CROSS_GATE)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    tags = layer_tags(cfg)
    emit("cross_plan", arch=arch, layers=cfg.n_layers,
         enc_layers=cfg.n_enc_layers if whisper else 0,
         cross_layers=sum(t.endswith(":1") for t in tags),
         init_s=time.perf_counter() - t1, weights_gb=weights / 1e9,
         **family_plan(cfg))
    bf, f32 = torch.bfloat16, torch.float32
    gs = _gemm_sites(params)
    if whisper:
        enc = params["encoder"]["layers"][0]
        m_enc = 2 * (WHISPER_MELS // 2)           # 2 x 1500 frames
        sites = {**{n: (w, od, (4, 2 * WHISPER_L), False)
                    for n, (w, od) in gs.items()},
                 "enc_q": (enc["mixer"]["wq"], bf, (m_enc,), False),
                 "enc_kv": (enc["mixer"]["wk"], bf, (m_enc,), False),
                 "enc_o": (enc["mixer"]["wo"], bf, (m_enc,), False),
                 "enc_up": (enc["ffn"]["up"], bf, (m_enc,), False),
                 "enc_down": (enc["ffn"]["down"], bf, (m_enc,), True)}
    else:
        cl = next(lp for lp in params["layers"] if "cross" in lp)["cross"]
        n_img = cfg.n_image_tokens
        sites = {"vision_proj": (params["vision_proj"], bf,
                                 (n_img, 4 * n_img), True),
                 "cross_q": (cl["wq"], bf, (4, 1024), False),
                 "cross_kv": (cl["wk"], bf, (n_img, 4 * n_img), True),
                 "cross_o": (cl["wo"], bf, (4, 1024), False),
                 "head": (gs["head"][0], f32, (4,), False)}
    checks = memory_k1_checks(dev, cfg, sites)
    if whisper:
        head_routes = {r for t, r in checks["k1_routes"].items()
                       if t.startswith("head")}
        need(head_routes == {"tiled"}, f"whisper head (N = "
             f"{cfg.vocab_size}) took {head_routes}, expected tiled")
    k2c = k2_noncausal_check(dev, cfg) if whisper else None
    free_memory()
    rng = np.random.default_rng(1)
    scores = {}
    if whisper:
        toks = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(2, WHISPER_L))).to(dev)
        scores["flash_off"] = memory_score(
            dev, model, params, toks, _memory_inputs(cfg, 2, dev, 1), False,
            "score_3000_mels_flash_off")
        scores["flash_on"] = memory_score(
            dev, model, params, toks,
            _memory_inputs(cfg, 2, dev, 1, WHISPER_FLASH_MELS), True,
            "score_2048_mels_flash_on")
    else:
        toks = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(SCORE_B, SCORE_L))).to(dev)
        scores["flash_on"] = memory_score(
            dev, model, params, toks, _memory_inputs(cfg, SCORE_B, dev, 1),
            True, "score_1024_flash_on",
            moved_by=_memory_inputs(cfg, SCORE_B, dev, 2))
    free_memory()
    prompts = _cross_prompts(cfg)
    inputs = _memory_inputs(cfg, len(prompts), dev, 3, WHISPER_FLASH_MELS)
    new = CROSS_NEW[arch]

    def serve(kind, label, **kw):
        out = memory_serve(dev, model, params, prompts, inputs, kind,
                           new=new, label=label, **kw)
        free_memory()
        return out

    serve("dense", "warmup")
    audit_memory(dev, model, params, prompts, inputs, arch)
    dense, rec_dense, cache = serve("dense", "dense", profile_steps=4)
    # k3_timing reads an engine's model and dense cache
    t3 = k3_timing(dev, types.SimpleNamespace(model=model, cache=cache),
                   prompts, long_context=False)
    bound_ms, bound_bytes = _decode_bound_ms(
        params, cache, [len(p) + new // 2 for p in prompts])
    del cache
    free_memory()
    paged, rec_paged, _ = serve("paged", "paged")
    need(paged == dense, f"{arch}: paged streams differ from dense")
    n_dec = cfg.n_layers
    for rec in (rec_dense, rec_paged):
        need(rec["flash_decode_per_step"] == [n_dec], f"{arch} "
             f"{rec['label']}: K3 launches a decode step "
             f"{rec['flash_decode_per_step']}, expected {n_dec}")
        need(rec["launches"]["abft_matmul"] > 0, f"{arch} {rec['label']}: "
             f"K1 never launched")
        need(rec["k2_prefill_launches"] == (cfg.n_enc_layers if whisper
                                            else 0),
             f"{arch} {rec['label']}: K2 launched "
             f"{rec['k2_prefill_launches']} times in the prefill")
    if whisper:
        fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
        faulted, rec_fault, _ = serve("dense", "dense_mlp_down_fault",
                                      decode_fault=fault)
    else:
        fault = ModelFault.at(cfg.cross_attn_every - 2, "cross_qkv",
                              FaultSpec.value(0, 1, 1e5))
        faulted, rec_fault, _ = serve("dense", "dense_cross_qkv_fault",
                                      prefill_fault=fault)
    need(rec_fault["faults_flagged"] == 1 and faulted == dense,
         f"{arch}: the faulted run's recompute differs from the clean run")
    train = whisper_train(dev, cfg) if whisper else None
    free_memory()
    t1k = k1_timing(dev, params, 4, arch=arch, per_shape=True)
    if whisper:
        t2 = k2_timing(dev, (2, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim), 1024, arch=arch,
                       causal=False)
    else:
        t2 = k2_timing(dev, (SCORE_B, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim), SCORE_L, arch=arch)
    peak = torch.cuda.max_memory_allocated()
    del params
    free_memory()
    prof = rec_dense.get("profile") or {}
    rec = dict(
        arch=arch, layers=cfg.n_layers, weights_gb=weights / 1e9,
        cross_gate=None if whisper else CROSS_GATE,
        scores=scores, decode_bound_ms=bound_ms,
        decode_bound_bytes=bound_bytes,
        decode_step_ms_median=rec_dense["decode_step_ms_median"],
        paged_decode_step_ms_median=rec_paged["decode_step_ms_median"],
        decode_tokens_per_s=rec_dense["decode_tokens_per_s"],
        paged_decode_tokens_per_s=rec_paged["decode_tokens_per_s"],
        prefill_ms=rec_dense["prefill_ms"],
        decode_device_ms=prof.get("device_ms_per_step"),
        decode_idle_share=prof.get("idle_share"),
        launches=rec_dense["launches"], paged_launches=rec_paged["launches"],
        flash_decode_per_step=n_dec, dense_equals_paged=True,
        fault=rec_fault["label"], train=train,
        k1_decode_step=t1k, peak_memory_gb=peak / 1e9,
        seconds=time.perf_counter() - t0)
    emit("cross", **rec)
    return {"rec": rec, "checks": checks, "k2_check": k2c, "k1": t1k,
            "k2": t2, "k3": t3}


def cross_runs(dev) -> dict:
    """whisper-tiny, then llama-3.2-vision-11b (``cross_arch``)."""
    out = {}
    for arch in CROSS_ARCHS:
        out[arch] = cross_arch(dev, arch)
        free_memory()
    return out


def _add_cross(kernels, cross) -> None:
    """Each kernel's line gets ``by_arch`` rows for whisper-tiny and
    llama-3.2-vision-11b: launches on the dense serving run (K1, K3) or
    the flash-on score (K2: whisper's encoder non-causal and decoder
    causal; vision's 40 causal), and the time, plain time, bound and
    library time at the arch's shapes (K1: a decode step's 2-D GEMMs,
    whisper's with the N = 51865 head on the tiled route; K2: whisper's
    non-causal 1024 frames, vision's causal score; K3: the decode step's
    layers on the dense cache).  K1's whisper row adds the head alone."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        rows = entry.setdefault("by_arch", {})
        for arch, out in cross.items():
            rec = out["rec"]
            if entry["name"] == "abft_matmul":
                row = {"launches": rec["launches"]["abft_matmul"],
                       "max_abs_err": out["checks"]["k1_max_abs_err"],
                       **{k: out["k1"][k] for k in keys}}
                head = out["k1"]["per_shape"].get("head")
                if head is not None and arch.startswith("whisper"):
                    row["head_n51865"] = {k: head[k] for k in keys}
            else:
                flash = entry["name"] == "flash_attention"
                t = out["k2"] if flash else out["k3"]
                n = (rec["scores"]["flash_on"]["launches"]["flash_attention"]
                     if flash else rec["launches"]["flash_decode"])
                row = {"launches": n, "max_abs_err": t["max_abs_err"],
                       "causal": (not arch.startswith("whisper"))
                       if flash else None,
                       **{k: t[k] for k in keys}}
            rows[arch] = row


# ------------------------------------------------------------------ audit

# The full-width audits of the served steps (``audit_served``,
# ``audit_engine``, ``audit_memory``), collected while the audit phase is
# on, by the phases that already build each model; None while it is off.
AUDITS = None
# prefill-only plan sites: a decode step never runs them
PREFILL_SITES = ("cross.k", "cross.v", "vision.proj")


def _kernel_launches() -> dict:
    from repro_torch.kernels import abft_matmul, flash_attention

    return {"K1": abft_matmul.KERNEL.launches,
            "K2": flash_attention.FULL_KERNEL.launches,
            "K3": flash_attention.KERNEL.launches}


def _walked(step: str, fn) -> tuple:
    """``fn()`` under the op walker, every launch count set to 0 just
    before and read just after: (ops, launches, seconds, result)."""
    from repro_torch.analysis.op_walk import OpWalker
    from repro_torch.kernels import abft_matmul, flash_attention

    torch.cuda.synchronize()
    abft_matmul.KERNEL.launches = abft_matmul.BATCHED.launches = 0
    flash_attention.FULL_KERNEL.launches = flash_attention.KERNEL.launches = 0
    t = time.perf_counter()
    with OpWalker(step) as walker, torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return walker.ops, _kernel_launches(), time.perf_counter() - t, out


def _audit_step(arch: str, step: str, ops, launches, seconds) -> dict:
    """One walked step's audit line: protected, allowlisted, known-gap and
    kernel FLOPs and their shares of the step's FLOPs, the records by
    kernel; gated on a protected fraction of 1.0 with no unprotected op
    and on the records equal to the launch counters' increments."""
    from repro_torch.analysis.audit import (
        PhaseCoverage,
        classify,
        kernel_records,
        product_flops,
    )

    cov = PhaseCoverage(phase=step, ops=classify(ops))
    records = kernel_records(ops)
    total = sum(c.op.flops for c in cov.ops)
    gaps = cov.known_unprotected
    rec = dict(
        arch=arch, step=step, n_ops=len(ops), total_flops=total,
        protected_flops=cov.protected_flops,
        allowlisted_flops=cov.allowlisted_flops,
        known_gap_flops=gaps, kernel_flops=cov.kernel_flops,
        protected_share=cov.protected_flops / total,
        allowlisted_share=cov.allowlisted_flops / total,
        known_gap_share=sum(gaps.values()) / total,
        kernel_share=cov.kernel_flops / total,
        product_flops=product_flops(ops),
        k1_flops=sum(op.flops for op in ops if op.primitive == "K1"),
        protected_fraction=cov.protected_fraction,
        records=records, launches=launches, seconds=seconds)
    need(cov.protected_fraction == 1.0 and not cov.unprotected_ops,
         f"audit {arch} {step}: unprotected ops "
         f"{[(c.op.path, c.op.flops) for c in cov.unprotected_ops][:5]}")
    need(records == launches, f"audit {arch} {step}: kernel records "
         f"{records} != launches {launches}")
    emit("audit", **rec)
    return rec


def _decode_counting(cfg, ops, n_tokens: int) -> dict:
    """A decode step's protected product FLOPs against
    ``models/counting.py``'s GEMMs at ``n_tokens`` rows, over the sites the
    step runs (the encoder's, ``vision.proj`` and the cross K/V run only
    in prefill).  The one difference allowed, and stated, is the MoE
    capacity padding: an expert GEMM runs at the capacity C rows
    (``moe.capacity``), where the count takes ``m * top_k / E``."""
    from repro_torch.analysis.audit import product_flops
    from repro_torch.analysis.crosscheck import traced_sites
    from repro_torch.models.counting import layer_gemms
    from repro_torch.models.moe import capacity

    sites = layer_gemms(cfg, n_tokens, "decode")
    ran = traced_sites(ops)
    skipped = sorted(set(sites) - set(ran))
    need(set(ran) <= set(sites), f"audit {cfg.name}: decode sites "
         f"{sorted(set(ran) - set(sites))} not in counting.py")
    need(all(s.startswith("enc.") or s in PREFILL_SITES for s in skipped),
         f"audit {cfg.name}: the decode step skipped {skipped}")
    want = sum(d.flops * c for name, (d, c) in sites.items() if name in ran)
    pad = 0.0
    if cfg.n_experts:
        m_e = max(1, n_tokens * cfg.experts_per_token // cfg.n_experts)
        rows = capacity(cfg, n_tokens) - m_e
        for name in ("moe.expert_up", "moe.expert_down"):
            d, c = sites[name]
            pad += 2.0 * rows * d.k * d.n * c
    got = product_flops(ops)
    need(got == want + pad, f"audit {cfg.name}: decode product FLOPs {got} "
         f"!= counting.py {want} + capacity padding {pad}")
    return {"counting_flops": want, "product_flops": got,
            "capacity_padding_flops": pad, "prefill_only_sites": skipped}


def _audit_config(arch, model, steps: dict, decode_rows: int,
                  t0: float) -> None:
    """The config's walked steps (name -> (ops, launches, seconds)): a
    line each, the plan crosscheck over their union against the H100 plan
    compiled for the model (bijective), and the decode step held against
    ``counting.py``; the summary, with the wall time since ``t0``, joins
    ``AUDITS``."""
    from repro_torch.analysis.crosscheck import crosscheck_plan
    from repro_torch.core.hardware import NVIDIA_H100_SXM

    recs = {step: _audit_step(arch, step, *walk)
            for step, walk in steps.items()}
    union = [op for ops, _, _ in steps.values() for op in ops]
    xc = crosscheck_plan(model.protection_plan(NVIDIA_H100_SXM), union,
                         model=arch)
    need(xc.bijective, f"audit {arch}: {xc.report()}")
    counting = _decode_counting(model.cfg, steps["decode"][0], decode_rows)
    wall = time.perf_counter() - t0
    emit("audit_config", arch=arch, sites=len(xc.matched),
         bijective=True, decode=counting, seconds=wall)
    AUDITS.append({"arch": arch, "steps": recs, "sites": len(xc.matched),
                   "decode_counting": counting, "seconds": wall})


def _audit_engine(model, params, dev, flash=True, **kw):
    from repro_torch.serve.engine import ServeEngine

    return ServeEngine(model, params, slots=4, max_len=512,
                       abft=_cross_ctx(flash).abft, dtype=torch.bfloat16,
                       device=dev, **kw)


def _audit_requests(prompts) -> list:
    from repro_torch.serve.engine import Request

    return [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts[:4])]


def audit_served(dev, model, params, prompts, arch) -> None:
    """The served path of ``arch`` at full width, audited (the audit phase
    only): a bf16 engine of 4 slots, max_len 512, flash on, under the H100
    plan; its admission prefill of 4 prompts and one decode step each
    walked (``_audit_config``)."""
    if AUDITS is None:
        return
    t0 = time.perf_counter()
    eng = _audit_engine(model, params, dev)
    reqs = _audit_requests(prompts)
    steps = {"prefill": _walked("prefill", lambda: eng.admit(reqs))[:3]}
    need(len(eng.active) == 4, f"audit {arch}: {len(eng.active)} of 4 "
         f"requests admitted")
    steps["decode"] = _walked("decode", eng.step)[:3]
    del eng
    free_memory()
    _audit_config(arch, model, steps, 4, t0)


class _RepeatProposer:
    """Drafts ``k`` copies of a request's last token: a window of K + 1
    rows every verify step, whatever the weights (the audit's verify)."""

    name = "repeat"

    def propose(self, req, k):
        return np.full((k,), req.generated[-1], np.int32)


def audit_engine(dev, model, params, prompts) -> None:
    """The engine path of llama3.2-1b at full width, audited: ``
    audit_served``'s admission prefill and decode step (flash on), one
    chunked step of an engine with ``chunk_tokens=256`` (flash on: the
    chunks' row-wise attention and K1 at the chunk's rows), and one
    verify step of a 4-token window (flash off, which speculation needs:
    a proposer drafting 3 tokens every step)."""
    if AUDITS is None:
        return
    t0 = time.perf_counter()
    eng = _audit_engine(model, params, dev)
    reqs = _audit_requests(prompts)
    steps = {"prefill": _walked("prefill", lambda: eng.admit(reqs))[:3],
             "decode": _walked("decode", eng.step)[:3]}
    eng = _audit_engine(model, params, dev, chunk_tokens=256)
    eng.admit(_audit_requests(prompts))
    steps["chunk"] = _walked("chunk", eng.step)[:3]
    need(eng.stats.prefill_chunks > 0, "audit: the chunked step ran no "
         "chunk")
    eng = _audit_engine(model, params, dev, flash=False,
                        spec_decode=_RepeatProposer(), draft_len=3)
    eng.admit(_audit_requests(prompts))
    steps["verify"] = _walked("verify", eng.step)[:3]
    need(eng.stats.draft_proposed == 12, f"audit: the verify step drafted "
         f"{eng.stats.draft_proposed} tokens, expected 4 x 3")
    del eng
    free_memory()
    _audit_config(ENGINE_ARCH, model, steps, 4, t0)


def audit_memory(dev, model, params, prompts, inputs, arch) -> None:
    """A memory model at full size, audited model-level (the engine
    refuses it): the prefill of ``prompts`` with their memory ``inputs``
    (whisper's encoder through K2, flash on) and one decode step of every
    row, as ``memory_serve`` runs them, on the H100 plan."""
    if AUDITS is None:
        return
    t0 = time.perf_counter()
    B = len(prompts)
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((B, int(lengths.max())), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    tok_t = torch.from_numpy(toks).to(dev)
    len_t = torch.from_numpy(lengths).to(dev)
    slots = torch.arange(B, dtype=torch.int32, device=dev)
    cache = model.init_cache(B, CROSS_MAX_LEN, dtype=torch.bfloat16,
                             device=dev)
    ctx = _cross_ctx(True)
    ops, launches, secs, (lg, cache, _) = _walked(
        "prefill", lambda: model.prefill(params, tok_t, cache, ctx,
                                         slots=slots, lengths=len_t,
                                         inputs=inputs))
    steps = {"prefill": (ops, launches, secs)}
    tok = lg[:, 0].argmax(-1)[:, None]
    steps["decode"] = _walked("decode", lambda: model.decode(
        params, tok, cache, len_t, ctx))[:3]
    del cache
    free_memory()
    _audit_config(arch, model, steps, B, t0)


def _json_diff(a, b, path: str = "") -> list:
    """Key paths where two JSON trees differ, with both values."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b), key=str)
                for d in _json_diff(a.get(k), b.get(k), f"{path}.{k}")]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _json_diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def audit_scaled(dev) -> dict:
    """``launch/audit.py --all`` on the card (scaled-down configs, f32,
    the kernels launched) and on the CPU (their plain versions), both
    under the H100 plan, every count held equal: each phase's FLOPs by
    class, fraction, sites and bijection, ``flash_consistent``, and
    ``n_ops``, which may differ only in ``mixed`` and only where the
    speculative verify step runs a ``none``/``global`` product on the card
    one window step at a time (``core/protected._plain_dot`` under
    ``decode_rows``): T products where the CPU runs one."""
    import contextlib
    import io

    from repro_torch.analysis.audit import card_split_ops
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.launch.audit import run_audits, to_payload

    out, secs = {}, {}
    for where in ("cpu", "cuda"):
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out[where] = run_audits(ALL_ARCHS, "mixed", device=where,
                                    hardware=NVIDIA_H100_SXM)
        secs[where] = time.perf_counter() - t
    pay = {w: to_payload(r, "mixed") for w, r in out.items()}
    split = 0
    for arch, rep in out["cpu"].items():
        want = json.loads(json.dumps(pay["cpu"]["configs"][arch]))
        got = json.loads(json.dumps(pay["cuda"]["configs"][arch]))
        extra = card_split_ops(rep)
        want["phases"]["mixed"]["n_ops"] += extra
        split += extra
        need(got == want, f"audit {arch}: the card's scaled-down audit "
             f"differs from the CPU's at {_json_diff(got, want)[:10]}")
        need(got["protected_fraction"] == 1.0
             and got["crosscheck"]["bijective"],
             f"audit {arch}: scaled-down fraction "
             f"{got['protected_fraction']}, bijective "
             f"{got['crosscheck']['bijective']}")
    rec = dict(configs=len(out["cuda"]), cpu_seconds=secs["cpu"],
               cuda_seconds=secs["cuda"], verify_split_ops=split,
               equal=True, flash_consistent={
                   a: r.flash_consistent for a, r in out["cuda"].items()},
               known_gap_flops={a: r.known_unprotected
                                for a, r in out["cuda"].items()})
    emit("audit_scaled", **rec)
    return rec


def audit_walker_init() -> float:
    """Seconds of the op walker's first use in the process (PyTorch
    imports its dispatch-mode machinery then), on a CPU product, so the
    audited steps' times are the walker's steady cost."""
    from repro_torch.analysis.op_walk import flop_ops

    t = time.perf_counter()
    a = torch.ones(2, 2)
    need([op.primitive for op in flop_ops(lambda: a @ a)] == ["mm"],
         "audit: the op walker missed a product")
    return time.perf_counter() - t


def audit_summary(scaled, expected: set, walker_s: float) -> dict:
    """The audit phase's line: every full-width audit's shares, the
    records by kernel over them (each kernel of the audited steps recorded
    at least once when every config is audited) and the phase's wall
    time: the walker's first use, the scaled-down audits and the
    full-width audits."""
    rows = {a["arch"]: {step: {k: r[k] for k in (
        "known_gap_share", "allowlisted_share", "kernel_share",
        "protected_share", "k1_flops", "records", "seconds")}
        for step, r in a["steps"].items()} for a in AUDITS}
    need(set(rows) == expected, f"audit: audited at full width "
         f"{sorted(rows)}, expected {sorted(expected)}")
    records = {k: sum(r["records"][k] for a in AUDITS
                      for r in a["steps"].values()) for k in ("K1", "K2",
                                                                "K3")}
    if len(expected) == 10:
        need(all(records.values()), f"audit: a kernel never launched in "
             f"the audited steps: {records}")
    full = sum(a["seconds"] for a in AUDITS)
    scaled_s = 0.0 if scaled is None else \
        scaled["cpu_seconds"] + scaled["cuda_seconds"]
    rec = dict(configs=sorted(rows), by_config=rows, records=records,
               walker_init_seconds=walker_s, full_width_seconds=full,
               scaled_seconds=scaled_s, seconds=walker_s + full + scaled_s)
    emit("audit_phase", **rec)
    return rec


def _add_audit(kernels, audit) -> None:
    """Each kernel's line gets ``audit_launches``: its launches over the
    full-width audited steps (each held equal to the walker's records)."""
    key = {"abft_matmul": "K1", "flash_attention": "K2",
           "flash_decode": "K3"}
    for entry in kernels:
        entry["audit_launches"] = audit["records"][key[entry["name"]]]


# ------------------------------------------------------------------ timing

def _gemm_bound(m, k, n, in_bytes, out_bytes, gm_gn_rows):
    byts = m * k * in_bytes + k * n * in_bytes + m * n * out_bytes \
        + 2 * 4 * gm_gn_rows
    flops = 2.0 * m * k * n
    peak = PEAK_BF16 if in_bytes == 2 else PEAK_F32
    t_b, t_f = byts / HBM_BW, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _step_gemm_groups(params) -> dict:
    """A step's 2-D GEMM weights, grouped by shape: GQA's ``q``, ``kv``
    and ``o``, MLA's ``q_a``, ``q_b``, ``kv_a`` and ``o``, Mamba2's
    ``ssm_in_zx``, ``ssm_in_bc``, ``ssm_in_dt`` and ``ssm_out``; the dense
    FFNs' ``up_gate`` (``up`` alone in a GELU FFN) and ``down``; the MoE
    layers' ``router`` (f32 out) and shared experts' ``shared_up_gate``
    and ``shared_down``; the cross layers' ``cross_q`` and ``cross_o``
    (a decode step reads its cross K/V from the cache); the head.  The
    expert GEMMs (batched) are timed apart."""
    layers = params["layers"]
    names = {"q": ("wq",), "kv": ("wk", "wv"), "q_a": ("wq_a",),
             "q_b": ("wq_b",), "kv_a": ("wkv_a",), "o": ("wo",),
             "ssm_in_zx": ("in_z", "in_x"), "ssm_in_bc": ("in_bc",),
             "ssm_in_dt": ("in_dt",), "ssm_out": ("out_proj",)}
    groups = {g: [l["mixer"][w] for l in layers for w in ws
                  if w in l["mixer"]] for g, ws in names.items()}
    ffns = [l["ffn"] for l in layers if "ffn" in l]
    dense = [f for f in ffns if "router" not in f]
    moe = [f for f in ffns if "router" in f]
    groups["up_gate"] = [f[w] for f in dense for w in ("up", "gate")
                         if w in f]
    groups["cross_q"] = [l["cross"]["wq"] for l in layers if "cross" in l]
    groups["cross_o"] = [l["cross"]["wo"] for l in layers if "cross" in l]
    groups["down"] = [f["down"] for f in dense]
    groups["router"] = [f["router"] for f in moe]
    shared = [f["shared"] for f in moe if "shared" in f]
    groups["shared_up_gate"] = [s[w] for s in shared for w in ("up", "gate")]
    groups["shared_down"] = [s["down"] for s in shared]
    groups["head"] = [params["lm_head"] if "lm_head" in params
                      else params["embed"].t()]
    return {g: ws for g, ws in groups.items() if ws}


def k1_timing(dev, params, m: int, arch: str = ENGINE_ARCH,
              one_slice: bool = False,
              split_rows: int | None = None,
              per_shape: bool = False, groups: dict | None = None) -> dict:
    """K1 over one step's GEMMs at M=m, using a run's own weights
    (distinct per layer, so weights come from HBM as in a real step), in
    their dtype: kernel, plain version, torch.matmul, and the bound (bf16
    at the tensor-core rate, f32 at the CUDA-core rate).  ``ms`` etc. are
    device times (CUDA-graph replay); ``ms_eager`` includes the host
    launch overhead of the eager loop.  The numbers behind two route
    choices (``fork``): at decode (bf16, M <= 8) the row-major GEMMs,
    which take the tensor-core pass 1, are also timed on the GEMV pass 1
    forced in their place where it can take them (not the tied head's
    columns, nor N < 64); in f32 above 8 rows (the train step) every
    GEMM, which takes the SIMT pass 1, also on the CUDA-core tiles.
    ``one_slice``: the kernel runs one K slice at any M, as the serving
    prefill paths run it, and no fork is timed; ``split_rows``: the K
    split is that row count's, as the speculative verify step runs it
    (``abft_matmul.plan``), and no fork is timed.  ``per_shape``: the
    step's total with each shape group's record beside it.  ``groups``:
    {name: weights of one shape} timed in place of the step's
    (``_step_gemm_groups(params)``; ``params`` then unread)."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, routes
    from repro_torch.kernels.ref import abft_matmul_ref

    groups = _step_gemm_groups(params) if groups is None else groups
    gen = torch.Generator(device=dev).manual_seed(4)
    per = {}
    tot = {"ms": 0.0, "ms_eager": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "gemms": 0}
    bound_by = set()
    dtype = next(iter(groups.values()))[0].dtype
    bf16 = dtype == torch.bfloat16
    forced = "gemv" if bf16 and m <= 8 else ("tiled" if not bf16 and m > 8
                                             else None)
    if one_slice or split_rows is not None:
        forced = None
    fork = {"route": "tc" if bf16 else "simt", "forced": forced,
            "gemms": 0, "ms": 0.0, "forced_ms": 0.0}
    for name, ws in groups.items():
        k, n = ws[0].shape
        out_dtype = torch.float32 if name in ("head", "router") else dtype
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
        if forced and forced in routes(x, ws[0], bn, "1s"):
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
    return {**tot, "per_shape": per} if per_shape else tot


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
    from repro_torch.models.attention import eff_counts

    cfg = eng.model.cfg
    caches = [c for c, st in zip(eng.cache, eng.model.state_layers)
              if not st]               # the attention layers' caches
    B = 4
    H, KV = eff_counts(cfg)             # the caches' (padded) heads
    D = cfg.resolved_head_dim
    lengths = torch.tensor([len(p) + 15 for p in prompts[:B]],
                           dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    S = caches[0]["k"].shape[1]
    # the dense walk's blocks as the engine's decode takes them
    from repro_torch.models.attention import DENSE_DECODE_BLOCK

    dense_block, BS = min(DENSE_DECODE_BLOCK, -(-S // 8) * 8), 16
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
    rec = {"arch": cfg.name, "H": H, "KV": KV, "launches_timed": len(caches),
           "B": B, "S": S,
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


# ------------------------------------------------------------------ tp

TP_RANKS = 2
TP_NEW = 16
# the TP=2 shard GEMMs of llama3.2-1b at a decode step: (K, N) and whether
# the output is the f32 partial of a row-parallel site (o, down) or the
# head's f32 logits
TP_K1_SHAPES = {"q": (2048, 1024, False), "kv": (2048, 256, False),
                "o": (1024, 2048, True), "up_gate": (2048, 4096, False),
                "down": (4096, 2048, True), "head": (2048, 64128, True)}


class _Capture:
    """Wraps an engine's runner: keeps the logits of the first admission
    prefill and of the first decode step (host f32), and where
    ``prompts`` is given, the top-1 minus top-2 logit of every emitted
    token by (uid, step), read off the rows the sampler sees."""

    def __init__(self, eng, prompts=None):
        self.first = {}
        self.gaps = {} if prompts is not None else None
        self.kind, self.rows = None, []
        # each model call's rows and, where ``mark`` is set, its mark
        self.calls, self.mark = [], None
        uid_of = {p.astype(np.int32).tobytes(): i
                  for i, p in enumerate(prompts or [])}
        runner = eng.runner
        sample, decode, prefill = runner.sample, runner.decode, \
            runner.prefill

        def cap_sample(logits, gens):
            if self.kind not in self.first:
                self.first[self.kind] = logits.float().cpu()
            if self.gaps is not None:
                top = torch.topk(logits.float(), 2, dim=-1).values
                for key, g in zip(self.rows, (top[:, 0] - top[:, 1])
                                  .tolist()):
                    if key is not None:
                        self.gaps[key] = g
            return sample(logits, gens)

        def cap_decode(p, tok, cache, pos, mask, *a, **k):
            self.kind = "decode"
            self.rows = [(eng.active[s].uid, len(eng.active[s].generated))
                         if s in eng.active else None
                         for s in range(eng.slots)]
            self.calls.append((self.rows, self.mark and self.mark()))
            return decode(p, tok, cache, pos, mask, *a, **k)

        def cap_prefill(p, toks, cache, slot_ids, lengths, *a, **k):
            self.kind = "prefill"
            t = toks.cpu().numpy().astype(np.int32)
            n = lengths.cpu().numpy()
            self.rows = [(uid_of[t[i, :n[i]].tobytes()], 0)
                         if t[i, :n[i]].tobytes() in uid_of else None
                         for i in range(len(n))]
            self.calls.append((self.rows, self.mark and self.mark()))
            return prefill(p, toks, cache, slot_ids, lengths, *a, **k)

        runner.sample, runner.decode, runner.prefill = \
            cap_sample, cap_decode, cap_prefill


def _tp_faults(cfg) -> dict:
    """The phase's faults: ``mlp_down`` (row-parallel: rank 0's partial)
    and ``qkv`` at q's column 3/4 of its width (column-parallel: rank
    1's at TP=2; beyond k's and v's widths, so q alone)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    col = cfg.n_heads * cfg.resolved_head_dim * 3 // 4
    return {"down": ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5)),
            "qkv": ModelFault.at(1, "qkv", FaultSpec.value(0, col, 1e5))}


def tp_serve(model, params, prompts, dev, label, *, mesh=None,
             cache_kind="dense", flash=True, fault_at=None,
             admit_fault_at=None, max_retries=1, capture=None, routes=None,
             slots=4, max_len=512, new=None, on_engine=None, **kw):
    """One bf16 engine run of the engine phase's traffic (4 slots,
    max_len 512, the H100 plan), at ``mesh`` ranks or on one process:
    its streams, errors and every ``EngineStats`` field (the record every
    rank must share), and apart its timing: each decode step's ms, K1 and
    K3 launches and collectives, in all and by kind (counted from 0 for
    this run).  ``routes``: a list that gets every MoE routing decision
    of the run (``_route_log``), each captured call marked with the log's
    length.  ``new``: each prompt's new tokens (``TP_NEW`` each by
    default); ``on_engine(eng)`` runs before the traffic."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.distributed import collectives
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine

    K1, K3 = abft_matmul.KERNEL, flash_attention.KERNEL
    K1B = abft_matmul.BATCHED
    abft = ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                  hardware=NVIDIA_H100_SXM,
                                  flash_attention=flash)
    eng = ServeEngine(model, params, slots=slots, max_len=max_len,
                      abft=abft, dtype=torch.bfloat16, device=dev,
                      cache_kind=cache_kind, mesh=mesh,
                      policy=RecoveryPolicy(max_retries=max_retries,
                                            evict_on_hard_fault=True), **kw)
    cap = _Capture(eng, capture) if capture is not False else None
    if on_engine is not None:
        on_engine(eng)
    new = new or [TP_NEW] * len(prompts)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    steps, kinds = [], []
    step = eng.step

    def timed_step(*a, **k):
        c0, k1, k3 = collectives.COUNTS["calls"], K1.launches, K3.launches
        k1b = K1B.launches
        by = dict(collectives.COUNTS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = step(*a, **k)
        torch.cuda.synchronize()
        if r:
            steps.append((1e3 * (time.perf_counter() - t),
                          K1.launches - k1, K3.launches - k3,
                          collectives.COUNTS["calls"] - c0,
                          K1B.launches - k1b))
            kinds.append({n: collectives.COUNTS[n] - by[n]
                          for n in collectives.KINDS})
        return r

    eng.step = timed_step
    K1.launches = K3.launches = K1B.launches = 0
    collectives.reset_counts()
    with (_route_log(routes) if routes is not None
          else contextlib.nullcontext()):
        if routes is not None and cap is not None:
            cap.mark = lambda: len(routes)
        eng.run(reqs, fault_at=fault_at, admit_fault_at=admit_fault_at)
    torch.cuda.synchronize()
    del eng.step
    st = dataclasses.asdict(eng.stats)
    rec = {"label": label,
           "streams": {r.uid: [int(t) for t in r.generated] for r in reqs},
           "errors": {r.uid: r.error for r in reqs if r.error},
           "stats": {k: v for k, v in st.items()
                     if isinstance(v, (int, float, list, dict))}}
    timing = {"decode_steps": len(steps),
              "step_ms": [s[0] for s in steps],
              "k1_per_step": sorted({s[1] for s in steps}),
              "k3_per_step": sorted({s[2] for s in steps}),
              "collectives_per_step": sorted({s[3] for s in steps}),
              "k1b_per_step": sorted({s[4] for s in steps}),
              "kinds_per_step": {n: sorted({c[n] for c in kinds})
                                 for n in collectives.KINDS},
              "launches": {"abft_matmul": K1.launches,
                           "flash_decode": K3.launches}}
    return eng, rec, timing, cap


def tp_rank(prompts) -> dict:
    """One rank of the ``tp`` phase (``distributed/spawn.py``): full-width
    llama3.2-1b at ``SERVED_LAYERS`` layers from seed 0, this rank's
    shard, served at ``mesh=2`` dense and paged, under a column-parallel
    ``qkv`` fault, and unsped and with oracle speculation (flash off);
    the collectives of one decode step timed alone; rank 0 also walks one
    decode step under the op walker (the audit).  (The row-parallel
    fault, the eviction and sharing + chunks run at model = 2 inside the
    ``dp`` phase's (2, 2) mesh.)  Every record is checked equal across
    the ranks; returns the records, the timings and, on rank 0, the
    captured logits and the audit."""
    from repro_torch.distributed import collectives
    from repro_torch.models.model import Model

    if not torch.cuda.is_available():
        raise RuntimeError("tp rank: no CUDA device")
    dev = torch.device("cuda")
    cfg = served_config()
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.bfloat16, device=dev)
    faults = _tp_faults(cfg)
    recs, timings = {}, {}

    def run(label, **kw):
        eng, rec, timing, cap = tp_serve(model, params, prompts, dev, label,
                                         mesh=TP_RANKS, **kw)
        collectives.check_same(rec, eng.executor.tp, label)
        recs[label], timings[label] = rec, timing
        return eng, cap

    eng, cap = run("dense", capture=None)
    tp = eng.executor.tp
    rank = tp.rank
    out = {"rank": rank, "backend": tp.backend,
           "device": str(eng.device), "sharded": sorted(tp.sharded),
           "plan": [{k: r[k] for k in ("layer", "m", "k", "n", "scheme")}
                    for r in eng.plan.report_rows()]}
    if rank == 0:
        out["logits"] = {k: v.numpy() for k, v in cap.first.items()}
    del eng, cap
    run("paged", cache_kind="paged", capture=False)
    run("fault_qkv", fault_at=(3, faults["qkv"]), capture=False)
    run("unsped", flash=False, capture=False)
    # on this traffic (random weights, 16 new tokens) the n-gram proposer
    # drafts nothing; an oracle drafting the unsped run's next tokens puts
    # K = 4 verify windows of real drafts through the sharded verify path
    run("oracle", flash=False, spec_decode=_OracleProposer(
        {int(u): s for u, s in recs["unsped"]["streams"].items()}),
        draft_len=4, capture=False)
    out["collective_ms"] = _tp_collective_ms(cfg, tp)
    out["audit"] = _tp_audit(model, params, prompts, dev, rank)
    out["records"], out["timings"] = recs, timings
    return out


def _tp_collective_ms(cfg, tp, n_sum=None, n_sq: int = 0,
                      dev="cuda") -> list:
    """The host ms of one decode step's collectives alone, at its sizes
    (4 slots): ``n_sum`` (slots, d) f32 sums (by default the embedding's
    and each layer's two), ``n_sq`` (slots, 1) f32 sums (Mamba2's sums of
    squares), the head's (slots, vocab / k) f32 gather and the flag's OR,
    between two device syncs and a barrier; 20 times."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    slots, reps = 4, 20
    n_sum = 2 * cfg.n_layers + 1 if n_sum is None else n_sum
    x = torch.zeros(slots, cfg.d_model, device=dev)
    ss = torch.zeros(slots, 1, device=dev)
    logits = torch.zeros(slots, cfg.vocab_size // tp.size, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier(group=tp.group)
        t = time.perf_counter()
        for _ in range(n_sum):
            collectives.all_reduce_sum(x, tp)
        for _ in range(n_sq):
            collectives.all_reduce_sum(ss, tp)
        collectives.gather_last(logits, tp)
        collectives.or_flag(flag, tp)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def _tp_audit(model, params, prompts, dev, rank):
    """One TP=2 decode step, walked on rank 0 (every rank steps, since the
    step's collectives need them all): protected fraction 1.0, the
    walker's K1/K3 records equal to rank 0's launch counters, and the
    per-shard H100 plan bijective with the executed sites."""
    from repro_torch.analysis.crosscheck import crosscheck_plan
    from repro_torch.core.hardware import NVIDIA_H100_SXM

    eng = _audit_engine(model, params, dev, mesh=TP_RANKS)
    eng.admit(_audit_requests(prompts))
    need(len(eng.active) == 4, f"tp audit: {len(eng.active)} of 4 admitted")
    if rank != 0:
        eng.step()
        return None
    ops, launches, seconds, _ = _walked("decode", eng.step)
    rec = _audit_step(f"{ENGINE_ARCH}/tp{TP_RANKS}", "decode", ops,
                      launches, seconds)
    xc = crosscheck_plan(model.protection_plan(
        NVIDIA_H100_SXM, n_tokens=4, model_parallel=TP_RANKS), ops,
        model=ENGINE_ARCH)
    need(xc.bijective, f"tp audit: {xc.report()}")
    return {"protected_fraction": rec["protected_fraction"],
            "sites": len(xc.matched), "bijective": True,
            "records": rec["records"], "launches": launches,
            "seconds": seconds}


def tp_k1_checks(dev, model, params, m: int = 4,
                 phase: str = "tp_k1") -> dict:
    """K1 against its plain version at the TP=2 shard shapes of a decode
    step (M = ``m``: 4, or a data rank's 2 of 4 slots), rank 0's shard of
    the phase's weights, the row-parallel partials (o, down) and the head
    with f32 out: y and bounds within ``family_checks``' tolerances and
    no false flag; then the kernel, the plain version and
    ``torch.matmul`` timed on the shard's GEMMs of each shape (CUDA
    graphs), beside the bound."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref

    mesh = Mesh(grid=np.arange(TP_RANKS).reshape(1, TP_RANKS),
                axis_names=("data", "model"),
                devices=(dev,) * TP_RANKS, rank=0)
    shard = model.shard_params(params, mesh)
    groups = _step_gemm_groups(shard)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for name, (k, n, f32_out) in TP_K1_SHAPES.items():
        ws = groups[name]
        need(tuple(ws[0].shape) == (k, n),
             f"tp K1 {name}: shard {tuple(ws[0].shape)} != {(k, n)}")
        out_dtype = torch.float32 if f32_out else torch.bfloat16
        err, scale, ratio, rt = _k1_site_check(dev, gen, model.cfg,
                                               f"{phase} {name}", ws[0],
                                               out_dtype, m)
        x = torch.randn(m, ws[0].shape[0], generator=gen,
                        device=dev).to(torch.bfloat16)
        kk, nn = ws[0].shape
        bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                      ((256, m), (512, kk), (256, nn)))
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

        b_ms, by = _gemm_bound(m, kk, nn, 2, out_dtype.itemsize,
                               -(-m // bm) * -(-nn // bn) * bm)
        out[name] = {"k": kk, "n": nn, "out": str(out_dtype)[6:],
                     "gemms": len(ws), "route": rt, "max_abs_err": err,
                     "max_abs_y": scale, "clean_ratio": ratio,
                     "ms": timed_graph(kern, iters=5),
                     "plain_ms": timed_graph(plain, iters=2),
                     "library_ms": timed_graph(lib, iters=5),
                     "bound_ms": b_ms * len(ws), "bound_by": by}
    del shard, groups
    emit(phase, m=m, shapes=out)
    return out


def tp_reference(dev, model, params, prompts) -> dict:
    """The TP=1 twin on this process (``mesh=None``): the clean dense run
    (flash on) with its first prefill and decode logits and every emitted
    token's top-two gap, and the hard-fault eviction run."""
    faults = _tp_faults(model.cfg)
    _, rec, timing, cap = tp_serve(model, params, prompts, dev, "tp1",
                                   capture=prompts)
    _, hard, _, _ = tp_serve(model, params, prompts, dev, "tp1_hard",
                             fault_at=(1, faults["down"]), max_retries=0,
                             capture=False)
    emit("tp_reference", tokens=rec["stats"]["tokens"],
         decode_step_ms_median=float(np.median(timing["step_ms"])),
         k1_per_step=timing["k1_per_step"],
         k3_per_step=timing["k3_per_step"],
         evicted=sorted(hard["errors"]))
    return {"rec": rec, "timing": timing, "hard": hard,
            "logits": {k: v.numpy() for k, v in cap.first.items()},
            "gaps": cap.gaps}


# TP head padding (the reference's pad_heads_to / pad_kv_heads_to) on the
# tp phase's llama: 32 q and 8 kv heads padded to 40 and 10, G stays 4
PAD_HEADS = (40, 10)
# the padded model against the unpadded one on the same logical weights:
# logits within this share of their scale, the score gates' bound (bf16
# through SERVED_LAYERS layers; only the sums' order moves, where a
# kernel's split depends on the head count or on K; a padded head that
# reached the residual would move them by the scale itself)
PAD_LOGIT_TOL = MLA_SCORE_TOL


def _pad_score(model, params, dev):
    """``Model.forward`` at ``SCORE_B`` x ``SCORE_L`` with K2 on under the
    H100 plan: (f32 logits on the card, K2 launches)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import flash_attention
    from repro_torch.models.layers import LayerCtx

    toks = np.random.default_rng(1).integers(
        1, model.cfg.vocab_size, size=(SCORE_B, SCORE_L))
    ctx = LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM,
        flash_attention=True))
    K2 = flash_attention.FULL_KERNEL
    torch.cuda.synchronize()
    K2.launches = 0
    with torch.no_grad():
        out = model.forward(params, {"tokens": toks}, ctx, device=dev)
    torch.cuda.synchronize()
    need(not bool(out.flag), f"padding score {model.cfg.name}: a flag")
    return out.logits, K2.launches


def padding_gate(dev, model, params, prompts, ref) -> dict:
    """TP head padding on one process: the tp phase's llama
    (``served_config``) padded to ``PAD_HEADS``, drawn from the same seed
    (the same logical weights, zero in the padded slots: checked), held
    against the unpadded model: K2 at the padded heads against its plain
    version (``k2_timing``), a 1 x 1024 score on K2 (one launch a layer)
    with its logits within ``PAD_LOGIT_TOL`` of the unpadded score's
    scale; served dense and paged with flash on (K3 at the padded kv
    heads, one launch a layer a decode step; K3 against its plain version
    layer by layer on the dense engine's cache, ``k3_timing``): the first
    prefill and decode logits within ``PAD_LOGIT_TOL`` of the unpadded
    TP=1 run's (``tp_reference``), paged = dense, each stream equal to
    the unpadded one's or parting where its top-two gap is below the
    logit error measured."""
    from repro_torch.models.attention import eff_counts
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = dataclasses.replace(model.cfg, pad_heads_to=PAD_HEADS[0],
                              pad_kv_heads_to=PAD_HEADS[1])
    need(eff_counts(cfg) == PAD_HEADS, f"padding: {eff_counts(cfg)}")
    pm = Model(cfg)
    pp = pm.init_params(0, dtype=torch.bfloat16, device=dev)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    for i, (lp, lu) in enumerate(zip(pp["layers"], params["layers"])):
        wq = lp["mixer"]["wq"].reshape(d, PAD_HEADS[1], G, hd)
        wo = lp["mixer"]["wo"].reshape(PAD_HEADS[1], G, hd, d)
        need(torch.equal(wq[:, :KV].reshape(d, -1), lu["mixer"]["wq"])
             and torch.equal(wo[:KV].reshape(-1, d), lu["mixer"]["wo"])
             and not bool(wq[:, KV:].any()) and not bool(wo[KV:].any()),
             f"padding: layer {i}'s wq/wo are not the logical ones padded")
    t2 = k2_timing(dev, (SCORE_B, *PAD_HEADS, hd), L=SCORE_L,
                   arch=f"{ENGINE_ARCH} padded")
    lu, k2_u = _pad_score(model, params, dev)
    lp_, k2_p = _pad_score(pm, pp, dev)
    need(k2_u == k2_p == cfg.n_layers, f"padding score: K2 {k2_p} times, "
         f"unpadded {k2_u}")
    scale = lu.abs().max().item()
    score_err = (lp_ - lu).abs().max().item()
    del lu, lp_
    need(score_err <= PAD_LOGIT_TOL * scale, f"padding score: logits off "
         f"the unpadded ones by {score_err} (scale {scale})")
    eng, dense, dtime, cap = tp_serve(pm, pp, prompts, dev, "pad_dense",
                                      capture=None)
    t3 = k3_timing(dev, eng, prompts, long_context=False)
    first = {k: v.numpy() for k, v in cap.first.items()}
    del eng, cap
    _, paged, ptime, _ = tp_serve(pm, pp, prompts, dev, "pad_paged",
                                  cache_kind="paged", capture=False)
    del pp
    free_memory()
    first_err = max(float(np.abs(first[k] - ref["logits"][k]).max())
                    for k in ("prefill", "decode"))
    first_scale = max(float(np.abs(v).max()) for v in ref["logits"].values())
    need(first_err <= PAD_LOGIT_TOL * first_scale, f"padding: first logits "
         f"off the unpadded ones by {first_err} (scale {first_scale})")
    need(paged["streams"] == dense["streams"],
         "padding: paged streams differ from dense")
    for label, tm in (("dense", dtime), ("paged", ptime)):
        need(tm["k3_per_step"] == [cfg.n_layers]
             and tm["k1_per_step"] == [7 * cfg.n_layers + 1],
             f"padding {label}: K1/K3 a step {tm['k1_per_step']}/"
             f"{tm['k3_per_step']}")
    err = max(first_err, score_err)
    tp1 = ref["rec"]["streams"]
    equal = [u for u in tp1 if tp1[u] == dense["streams"][u]]
    ties = {}
    for u in tp1:
        if u in equal:
            continue
        t = next(i for i, (a, b) in enumerate(zip(tp1[u],
                                                  dense["streams"][u]))
                 if a != b)
        ties[u] = {"step": t, "tp1_top2_gap": ref["gaps"][(u, t)]}
        need(ref["gaps"][(u, t)] < err, f"padding: stream {u} parts from "
             f"the unpadded one at step {t}, top-two gap "
             f"{ref['gaps'][(u, t)]} >= the logit error {err}")
    rec = {"heads": list(PAD_HEADS), "logical_heads": [cfg.n_heads, KV],
           "score_max_abs_err": score_err, "score_scale": scale,
           "score_k2_launches": k2_p,
           "first_logits_max_abs_err": first_err,
           "first_logits_scale": first_scale,
           "streams_equal_unpadded": len(equal), "streams": len(tp1),
           "divergent": ties,
           "k1_per_step": dtime["k1_per_step"],
           "k3_per_step": dtime["k3_per_step"],
           "launches": {"dense": dtime["launches"],
                        "paged": ptime["launches"]},
           "decode_step_ms_median": float(np.median(dtime["step_ms"])),
           "k2": {k: t2[k] for k in ("H", "KV", "D", "L", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err")},
           "k3": {k: t3[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by", "max_abs_err")}
           | {"paged_ms": t3["paged"]["ms"],
              "splits": t3["dense"]["splits"]},
           "seconds": time.perf_counter() - t0}
    emit("padding", **rec)
    return rec


def tp_runs(dev) -> dict:
    """The ``tp`` phase: full-width llama3.2-1b (``SERVED_LAYERS`` layers)
    served with tensor parallelism over two ranks sharing this one card (gloo), against
    itself (dense = paged, qkv-faulted = clean, oracle-sped = unsped,
    every rank agreeing; the row-parallel fault, eviction and sharing +
    chunks at model = 2 run in ``dp``) and against the one-process run
    (the logits of the first prefill and decode step, the greedy streams
    or their divergence at a near-tie); K1 at the shard shapes against
    its plain version; K1 and K3 launches a decode step a rank; the
    rank-0 audit.  Two ranks time-slicing one card over gloo: the times
    are not a TP speed."""
    from repro_torch.distributed import spawn
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = served_config()
    model = Model(cfg)
    params, prompts = engine_inputs(dev, cfg=cfg)
    k1 = tp_k1_checks(dev, model, params)
    ref = tp_reference(dev, model, params, prompts)
    padding = padding_gate(dev, model, params, prompts, ref)
    del params
    free_memory()
    t_spawn = time.perf_counter()
    outs = spawn.run(tp_rank, TP_RANKS, prompts, device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    r0 = outs[0]
    recs = r0["records"]
    for o in outs[1:]:
        need(o["records"] == recs, f"tp: rank {o['rank']}'s records differ "
             f"from rank 0's")
    st = {k: v["stats"] for k, v in recs.items()}

    def same(a, b):
        need(recs[a]["streams"] == recs[b]["streams"],
             f"tp: {a} streams differ from {b}")

    for label, rec in recs.items():
        need(not rec["errors"], f"tp {label}: errors {rec['errors']}")
        need(all(len(s) == TP_NEW for s in rec["streams"].values()),
             f"tp {label}: incomplete streams")
    same("paged", "dense")
    same("fault_qkv", "dense")
    same("oracle", "unsped")
    need(st["fault_qkv"]["faults_detected"] >= 1
         and st["fault_qkv"]["hard_faults"] == 0,
         f"tp fault_qkv: {st['fault_qkv']}")
    need(st["oracle"]["draft_proposed"] > 0 and st["oracle"][
        "draft_accepted"] == st["oracle"]["draft_proposed"],
         f"tp oracle: {st['oracle']}")
    # the step's kernels and collectives, on every rank
    L = cfg.n_layers
    for o in outs:
        t = o["timings"]["dense"]
        need(t["collectives_per_step"] == [2 * L + 3],
             f"tp rank {o['rank']}: collectives a step "
             f"{t['collectives_per_step']} != {2 * L + 3}")
        need(t["k1_per_step"] == [7 * L + 1] and t["k3_per_step"] == [L],
             f"tp rank {o['rank']}: K1/K3 a step {t['k1_per_step']}/"
             f"{t['k3_per_step']} != {7 * L + 1}/{L}")
        for label, tl in o["timings"].items():
            need(tl["launches"]["abft_matmul"] > 0, f"tp {label}: no K1")
    # against TP=1
    diff = max(float(np.abs(r0["logits"][k] - ref["logits"][k]).max())
               for k in ("prefill", "decode"))
    tp1 = ref["rec"]["streams"]
    equal, ties = _near_tie_gate(tp1, recs["dense"]["streams"], ref["gaps"],
                                 diff, "tp")
    t = r0["timings"]["dense"]
    res = {"ranks": TP_RANKS, "backend": r0["backend"],
           "devices": [o["device"] for o in outs],
           "sharded": r0["sharded"], "plan": r0["plan"],
           "streams_equal_tp1": len(equal), "streams": len(tp1),
           "divergent": ties, "max_logit_diff_vs_tp1": diff,
           "k1_per_step": t["k1_per_step"], "k3_per_step": t["k3_per_step"],
           "collectives_per_step": t["collectives_per_step"][0],
           "decode_step_ms_median": float(np.median(t["step_ms"])),
           "collectives_alone_ms_per_step_median": float(
               np.median(r0["collective_ms"])),
           "tp1_decode_step_ms_median": float(
               np.median(ref["timing"]["step_ms"])),
           "launches": {k: v["launches"] for k, v in
                        r0["timings"].items()},
           "stats": {k: {f: v[f] for f in (
               "tokens", "faults_detected", "retries", "hard_faults",
               "evictions", "prefill_chunks", "draft_proposed",
               "draft_accepted")} for k, v in st.items()},
           "audit": r0["audit"], "k1": k1, "spawn_seconds": spawn_s,
           "padding": padding, "seconds": time.perf_counter() - t0,
           "note": "two ranks time-sharing one card over gloo: a "
                   "correctness run, not a tensor-parallel speed"}
    emit("tp", **res)
    # the TP=1 twin, for the dp phase
    res["tp1"] = ref
    return res


def _near_tie_gate(tp1, got, gaps, diff, phase) -> tuple:
    """Streams ``got`` against the TP=1 twin's ``tp1``: each stream that
    parts from the twin's must part at a logit near-tie, where the twin's
    top-two gap is below ``diff`` (the largest logit difference measured
    between the two).  Returns (the equal uids, {uid: the parting})."""
    equal = [u for u in tp1 if tp1[u] == got[u]]
    ties = {}
    for u in tp1:
        if u in equal:
            continue
        t = next(i for i, (a, b) in enumerate(zip(tp1[u], got[u]))
                 if a != b)
        gap = gaps[(u, t)]
        ties[u] = {"step": t, "tp1_top2_gap": gap}
        need(gap < diff, f"{phase}: stream {u} diverges from TP=1 at step "
             f"{t} with a top-two gap {gap} >= the logit difference {diff}")
    return equal, ties


def _add_tp(kernels, tp) -> None:
    """The ``tp`` phase's numbers on the kernels line: K1 at the TP=2
    shard shapes, and K1/K3 launches a decode step a rank."""
    k1, k3 = kernels[0], kernels[2]
    k1["tp2_m4"] = {name: {key: rec[key] for key in (
        "k", "n", "out", "ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err")} for name, rec in tp["k1"].items()}
    k1["tp_launches_per_step"] = tp["k1_per_step"]
    k3["tp_launches_per_step"] = tp["k3_per_step"]
    pad = tp["padding"]
    kernels[1]["padded_heads"] = {**pad["k2"],
                                  "launches": pad["score_k2_launches"]}
    k3["padded_heads"] = {**pad["k3"], "heads": pad["heads"],
                          "launches_per_step": pad["k3_per_step"],
                          "launches": pad["launches"]["dense"][
                              "flash_decode"]}


# ------------------------------------------------------------- tp_hybrid

# jamba-v0.1-52b at published widths and one 8-layer unit (``ssm_config``)
# served over two ranks sharing the card: GQA attention, Mamba2 mixers, dense
# and MoE FFNs (16 experts: EP, 8 a rank)
HYBRID_ARCH = "jamba-v0.1-52b"
# a decode step's collectives by the design: attention wo 1, seven mixers'
# gated norm and out_proj 14, four dense down 4, four MoE combines 4, the
# embedding 1, the head's gather 1, the flag 1
HYBRID_COLLECTIVES = 26
# the logits' gate against TP=1, as a share of TP=1's logit scale (the score
# gate's bound, SSM_SCORE_TOL), at the positions of a 1 x HYBRID_SCORE_L
# score that precede its first token routed to another expert set: one
# routing flip (a router near-tie the reordered sums tip over) changes a
# token's FFN output wholesale
HYBRID_LOGIT_TOL = SSM_SCORE_TOL
HYBRID_SCORE_L = 256
# a routing flip is a near-tie where TP=1's router gives the k-th and the
# (k+1)-th expert probabilities this close
HYBRID_ROUTER_TIE = 0.02


def _hybrid_faults(cfg) -> dict:
    """``expert_up`` at layer 2 (every local expert of each rank), ``ssm_in``
    at layer 0 on column 3/4 of ``in_x``/``in_z`` (rank 1's at TP=2),
    ``ssm_out`` at layer 5 (row-parallel: rank 0's partial), and the
    sticky ``ssm_out`` at layer 1 of the eviction run."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    col = cfg.d_inner * 3 // 4
    return {"expert_up": ModelFault.at(2, "expert_up",
                                       FaultSpec.value(0, 1, 1e5)),
            "ssm_in": ModelFault.at(0, "ssm_in", FaultSpec.value(0, col, 1e5)),
            "ssm_out": ModelFault.at(5, "ssm_out", FaultSpec.value(0, 1, 1e5)),
            "hard": ModelFault.at(1, "ssm_out", FaultSpec.value(0, 1, 1e5))}


def _state_digest(eng) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in _ssm_states(eng):
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def shard_k1(dev, cfg, shard, phase, f32_out, seed, extra=None) -> dict:
    """K1 at a TP rank's shard shapes of a decode step (M = 4), against
    its plain version (``_k1_site_check``) and timed: each group of 2-D
    GEMMs (``_step_gemm_groups`` and ``extra``, name -> weights; the
    groups in ``f32_out`` with f32 out: the row-parallel partials, the
    router and the head, as the path runs them) by CUDA-graph replay
    beside its plain version, ``torch.matmul`` and the bound; then K1
    batched over the rank's experts at C = 4 and an admission's C
    (``_batched_case``, ``moe_k1_timing``)."""
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel
    from repro_torch.kernels.ref import abft_matmul_ref
    from repro_torch.models.moe import capacity

    groups = {**_step_gemm_groups(shard), **(extra or {})}
    gen = torch.Generator(device=dev).manual_seed(seed)
    m, out = 4, {}
    for name, ws in groups.items():
        od = torch.float32 if name in f32_out else torch.bfloat16
        err, scale, ratio, rt = _k1_site_check(dev, gen, cfg, f"tp2 {name}",
                                               ws[0], od, m)
        kk, nn = ws[0].shape
        x = torch.randn(m, kk, generator=gen, device=dev).to(torch.bfloat16)
        bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                      ((256, m), (512, kk), (256, nn)))
        kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=od)

        def kern():
            for w in ws:
                abft_matmul_kernel(x, w, **kw)

        def plain():
            for w in ws:
                abft_matmul_ref(x, w, **kw)

        def lib():
            for w in ws:
                torch.matmul(x, w)

        b_ms, by = _gemm_bound(m, kk, nn, 2, od.itemsize,
                               -(-m // bm) * -(-nn // bn) * bm)
        out[name] = {"k": kk, "n": nn, "out": str(od)[6:],
                     "gemms": len(ws), "route": rt, "max_abs_err": err,
                     "max_abs_y": scale, "clean_ratio": ratio,
                     "ms": timed_graph(kern, iters=5),
                     "plain_ms": timed_graph(plain, iters=2),
                     "library_ms": timed_graph(lib, iters=5),
                     "bound_ms": b_ms * len(ws), "bound_by": by}
    ffn = next(lp["ffn"] for lp in shard["layers"]
               if "ffn" in lp and "router" in lp["ffn"])
    caps = (capacity(cfg, 4), capacity(cfg, 4 * 256))
    worst = ratio = 0.0
    for wname in ("w_up", "w_down"):
        for C in caps:
            err, r = _batched_case(dev, gen, ffn[wname], C,
                                   f"tp2 {cfg.name} {wname} C={C}")
            worst, ratio = max(worst, err), max(ratio, r)
    need(ratio < 1, f"{phase} batched K1 clean residual {ratio}")
    batched = {"E_local": int(ffn["w_up"].shape[0]), "capacities": caps,
               "max_abs_err": worst, "clean_ratio": ratio,
               "timing": moe_k1_timing(dev, shard, caps,
                                       phase=f"{phase}_k1_batched")}
    free_memory()
    emit(f"{phase}_k1", m=m, shapes=out,
         batched={k: v for k, v in batched.items() if k != "timing"})
    return {"shapes": out, "batched": batched}


def _hybrid_collective_ms(cfg, tp, dev) -> list:
    """A jamba decode step's 26 collectives timed alone
    (``_tp_collective_ms``): the (4, d) sums of the embedding, attention
    ``wo``, the mixers' ``out_proj``, the dense ``down`` and the MoE
    combines, and the mixers' (4, 1) sums of squares."""
    from repro_torch.models.model import layer_tags

    tags = layer_tags(cfg)
    n_mix = sum(t.startswith("mamba") for t in tags)
    n_sum = 1 + sum(t.startswith("attn") for t in tags) + n_mix + sum(
        t.split(":")[1] in ("dense", "moe") for t in tags)
    need(n_sum + n_mix + 2 == HYBRID_COLLECTIVES,
         f"tp_hybrid: {n_sum + n_mix + 2} collectives timed")
    return _tp_collective_ms(cfg, tp, n_sum, n_mix, dev)


def _hybrid_audit(model, params, prompts, dev, mesh, rank,
                  phase="tp_hybrid"):
    """One TP=2 decode step walked on rank 0 by ``analysis.audit.
    audit_served_step`` (every rank steps: the step's collectives need
    them all): fraction 1.0, the engine's TP=2 plan bijective with the
    executed sites, the K1/K3 records equal to rank 0's launch counters;
    the known gaps' FLOPs (MLA's core) beside."""
    from repro_torch.analysis.audit import audit_served_step

    eng = _audit_engine(model, params, dev, mesh=mesh)
    eng.admit(_audit_requests(prompts))
    need(len(eng.active) == 4, f"{phase} audit: {len(eng.active)} of 4")
    if rank != 0:
        eng.step()
        return None
    from repro_torch.kernels import abft_matmul, flash_attention

    torch.cuda.synchronize()
    abft_matmul.KERNEL.launches = abft_matmul.BATCHED.launches = 0
    flash_attention.FULL_KERNEL.launches = flash_attention.KERNEL.launches = 0
    t = time.perf_counter()
    a = audit_served_step(eng, eng.step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = _kernel_launches()
    rec = a.to_json()
    need(rec["protected_fraction"] == 1.0,
         f"{phase} audit: fraction {rec['protected_fraction']}")
    need(a.crosscheck.bijective, f"{phase} audit: {a.crosscheck.report()}")
    need(rec["records"] == launches,
         f"{phase} audit: records {rec['records']} != launches {launches}")
    return {"protected_fraction": rec["protected_fraction"],
            "sites": len(a.crosscheck.matched), "bijective": True,
            "records": rec["records"], "launches": launches,
            "known_gap_flops": {k: v["flops"] for k, v in rec["coverage"][
                "known_unprotected"].items()},
            "protected_flops": rec["coverage"]["protected_flops"],
            "seconds": seconds}


def tp_hybrid_rank(prompts, device_type: str = "cuda") -> dict:
    """One rank of the ``tp_hybrid`` phase: jamba at published widths and
    8 layers, only this rank's shard drawn (``init_params(mesh=)``, seed
    0); rank 0 holds K1 at the shard shapes against its plain version
    (``shard_k1``); then served at ``mesh=2``: dense (its first logits
    kept on rank 0), paged, an ``expert_up`` fault at decode step 2 and at
    the second admission, an ``ssm_in`` fault on rank 1's columns, an
    ``ssm_out`` fault, hard-fault eviction; each run's state digest; the
    collectives timed alone; the rank-0 audit; the peak memory.  Every
    record is checked equal across the ranks."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.models.model import Model

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tp_hybrid rank: no CUDA device")
    cfg = ssm_config(HYBRID_ARCH)
    model = Model(cfg)
    mesh = build_mesh(model=TP_RANKS, data=1,
                      devices=rank_devices(device_type))
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init_params(0, dtype=torch.bfloat16, device=dev,
                               mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    draw_peak = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    rank = mesh.model_rank
    k1 = shard_k1(dev, cfg, params, "tp_hybrid",
                  {"o", "ssm_out", "down", "router", "head"},
                  seed=41) if rank == 0 else None
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    faults = _hybrid_faults(cfg)
    recs, timings, states = {}, {}, {}

    def run(label, **kw):
        eng, rec, timing, cap = tp_serve(model, params, prompts, dev, label,
                                         mesh=mesh, **kw)
        collectives.check_same(rec, eng.executor.tp, label)
        recs[label], timings[label] = rec, timing
        states[label] = _state_digest(eng)
        return eng, cap

    routes = [] if rank == 0 else None
    eng, cap = run("dense", capture=None, routes=routes)
    ex = eng.executor
    tp = ex.tp
    out = {"rank": rank, "backend": tp.backend, "device": str(eng.device),
           "sharded": sorted(tp.sharded), "moe_mode": ex.hints.moe_mode,
           "plan": [{k: r[k] for k in ("layer", "m", "k", "n", "scheme")}
                    for r in eng.plan.report_rows()]}
    score = _hybrid_score(model, ex.params, dev, cfg, ex.hints, tp)
    if rank == 0:
        out["logits"] = {k: v.numpy() for k, v in cap.first.items()}
        out["routes"], out["calls"], out["score"] = routes, cap.calls, score
    del eng, cap, ex
    run("paged", cache_kind="paged", capture=False)
    run("fault_expert", fault_at=(2, faults["expert_up"]),
        admit_fault_at=(1, faults["expert_up"]), capture=False)
    run("fault_ssm_in", fault_at=(3, faults["ssm_in"]), capture=False)
    run("fault_ssm_out", fault_at=(3, faults["ssm_out"]), capture=False)
    run("hard_fault", fault_at=(1, faults["hard"]), max_retries=0,
        capture=False)
    out["collective_ms"] = _hybrid_collective_ms(cfg, tp, dev)
    out["audit"] = _hybrid_audit(model, params, prompts, dev, mesh, rank)
    out["records"], out["timings"], out["states"] = recs, timings, states
    out["k1"] = k1
    out["init_s"], out["weights_gb"] = init_s, weights / 1e9
    out["draw_peak_gb"] = draw_peak / 1e9
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _hybrid_score(model, params, dev, cfg, hints=None, tp=None) -> dict:
    """A 1 x ``HYBRID_SCORE_L`` ``Model.forward`` (flash off, the H100
    plan; seeded tokens) with its routing logged: f32 logits (and the MTP
    head's ``mtp_logits`` where the model has one) and the routing on the
    host.  On a mesh every rank runs it (its collectives)."""
    from repro_torch.core.hardware import NVIDIA_H100_SXM
    from repro_torch.core.policy import IntensityGuidedPolicy
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.models.layers import LayerCtx

    toks = np.random.default_rng(9).integers(
        1, cfg.vocab_size, size=(1, HYBRID_SCORE_L))
    ctx = LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=NVIDIA_H100_SXM), hints=hints,
        tp=tp)
    routes = []
    with torch.no_grad(), _route_log(routes):
        out = model.forward(params, {"tokens": toks}, ctx, device=dev.type)
    need(not bool(out.flag), f"{cfg.name} score: a clean forward flagged")
    rec = {"logits": out.logits[0].float().cpu().numpy(),
           "routes": [ids for ids, _ in routes]}
    if out.mtp_logits is not None:
        rec["mtp_logits"] = out.mtp_logits[0].float().cpu().numpy()
    return rec


def _hybrid_vs_tp1(cfg, ref, ref_logits, ref_score, routes, calls, gaps, r0,
                   dense) -> dict:
    """TP=2 (rank 0) against the TP=1 twin.  The score: the per-position
    logit error, the positions routed alike in every MoE layer and the
    error before the first position routed apart (``_routing_diff``).
    The engine runs: the first routing decision that differs (its entry,
    model call and tokens, and TP=1's margin there between the k-th and
    (k+1)-th expert's probability), and each stream that diverges: the
    step, the call, TP=1's top-two logit gap there and whether the
    divergence comes at or after the first routing flip."""
    K = cfg.experts_per_token
    s1, s2 = ref_score, r0["score"]
    pos_err = torch.from_numpy(np.abs(s2["logits"] - s1["logits"]).max(-1))
    score = _routing_diff([torch.from_numpy(r) for r in s2["routes"]],
                          [torch.from_numpy(r) for r in s1["routes"]],
                          pos_err, HYBRID_SCORE_L)
    score["logit_scale"] = float(np.abs(s1["logits"]).max())
    score["max_abs_err"] = float(pos_err.max())
    flip = None
    for i, ((ia, pa), (ib, pb)) in enumerate(zip(routes, r0["routes"])):
        differ = (ia != ib).any(-1)
        if bool(differ.any()):
            top = -np.sort(-pa, axis=-1)
            margin = (top[:, K - 1] - top[:, K])[differ]
            call = max(c for c, (_, mark) in enumerate(calls) if mark <= i)
            flip = {"entry": i, "call": call,
                    "tokens": int(differ.sum()),
                    "tp1_margin_max": float(margin.max()),
                    "prob_diff_max": float(np.abs(pa - pb).max())}
            break
    first_call = {}
    for c, (rows, _) in enumerate(calls):
        for key in rows:
            if key is not None:
                first_call.setdefault(key, c)
    diff = max(float(np.abs(r0["logits"][k] - ref_logits[k]).max())
               for k in ("prefill", "decode"))
    tp1, tp2 = ref["streams"], dense["streams"]
    equal = [u for u in tp1 if tp1[u] == tp2[u]]
    ties = {}
    for u in tp1:
        if u in equal:
            continue
        t = next(i for i, (a, b) in enumerate(zip(tp1[u], tp2[u])) if a != b)
        c = first_call[(u, t)]
        ties[u] = {"step": t, "call": c, "tp1_top2_gap": gaps[(u, t)],
                   "after_routing_flip": flip is not None
                   and c >= flip["call"]}
    return {"score": score, "routing_flip": flip,
            "routing_entries": len(routes),
            "streams_equal_tp1": len(equal), "streams": len(tp1),
            "divergent": ties,
            "first_logits_max_diff_vs_tp1": diff,
            "first_logits_scale": max(float(np.abs(v).max())
                                      for v in ref_logits.values())}


def _hybrid_gates(vs, phase="tp_hybrid") -> None:
    """The ``tp_hybrid`` gates against TP=1 (``_hybrid_vs_tp1``): the
    score's logits within ``HYBRID_LOGIT_TOL`` of its scale wherever the
    routing has not yet parted; the engine's first routing flip, if any, a
    router near-tie (``HYBRID_ROUTER_TIE``); each divergent stream at or
    after that flip, or where TP=1's top-two gap is below the score's
    error before the flip (a logit near-tie)."""
    sc = vs["score"]
    before = sc["max_abs_err_before_it"]
    need(sc["first_position_routed_apart"] > 0
         and before <= HYBRID_LOGIT_TOL * sc["logit_scale"],
         f"{phase}: score logits off TP=1 by {before} before the first "
         f"position routed apart ({sc})")
    flip = vs["routing_flip"]
    need(flip is None or flip["tp1_margin_max"] <= HYBRID_ROUTER_TIE,
         f"{phase}: the first routing flip is no router near-tie: {flip}")
    for u, d in vs["divergent"].items():
        need(d["after_routing_flip"] or d["tp1_top2_gap"] < before,
             f"{phase}: stream {u} diverges from TP=1 at step "
             f"{d['step']} before any routing flip with a top-two gap "
             f"{d['tp1_top2_gap']} >= {before}")


def tp_hybrid_runs(dev) -> dict:
    """The ``tp_hybrid`` phase: jamba-v0.1-52b at published widths and 8
    layers served over two ranks sharing this card (gloo), each rank
    drawing only its shard: against itself (records equal across the
    ranks; dense = paged = faulted streams; every recovered run's state
    bit-equal to the clean run's on each rank), against the one-process
    twin run first here (evictions equal; the first prefill and decode
    logits within ``HYBRID_LOGIT_TOL`` of its scale; a divergent stream
    only where the twin's top-two gap is below the logit difference); K1
    at the shard shapes against its plain version (rank 0); 26
    collectives, 68 K1 (12 of them batched) and 1 K3 a decode step a
    rank; the rank-0 audit.  Two ranks time-slicing one card over gloo:
    the times are not a TP speed."""
    from repro_torch.distributed import spawn
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = ssm_config(HYBRID_ARCH)
    model = Model(cfg)
    free_memory()
    params, prompts = engine_inputs(dev, cfg=cfg)
    faults = _hybrid_faults(cfg)
    routes = []
    _, ref, ref_timing, cap = tp_serve(model, params, prompts, dev, "tp1",
                                       capture=prompts, routes=routes)
    ref_logits = {k: v.numpy() for k, v in cap.first.items()}
    gaps, calls = cap.gaps, cap.calls
    del cap
    ref_score = _hybrid_score(model, params, dev, cfg)
    _, hard, _, _ = tp_serve(model, params, prompts, dev, "tp1_hard",
                             fault_at=(1, faults["hard"]), max_retries=0,
                             capture=False)
    emit("tp_hybrid_reference", tokens=ref["stats"]["tokens"],
         decode_step_ms_median=float(np.median(ref_timing["step_ms"])),
         k1_per_step=ref_timing["k1_per_step"],
         k3_per_step=ref_timing["k3_per_step"],
         evicted=sorted(hard["errors"]))
    del params
    free_memory()
    t_spawn = time.perf_counter()
    outs = spawn.run(tp_hybrid_rank, TP_RANKS, prompts, dev.type,
                     device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    r0 = outs[0]
    recs = r0["records"]
    for o in outs[1:]:
        need(o["records"] == recs, f"tp_hybrid: rank {o['rank']}'s records "
             f"differ from rank 0's")
    st = {k: v["stats"] for k, v in recs.items()}
    for label, rec in recs.items():
        if label != "hard_fault":
            need(not rec["errors"], f"tp_hybrid {label}: {rec['errors']}")
            need(all(len(s) == TP_NEW for s in rec["streams"].values()),
                 f"tp_hybrid {label}: incomplete streams")
            need(rec["streams"] == recs["dense"]["streams"],
                 f"tp_hybrid: {label} streams differ from dense")
    for label in ("fault_expert", "fault_ssm_in", "fault_ssm_out"):
        need(st[label]["faults_detected"] >= (2 if label == "fault_expert"
                                              else 1)
             and st[label]["hard_faults"] == 0,
             f"tp_hybrid {label}: {st[label]}")
    need(st["hard_fault"]["hard_faults"] >= 1, "tp_hybrid: no hard fault")
    evicted = sorted(int(u) for u in recs["hard_fault"]["errors"])
    need(evicted == sorted(int(u) for u in hard["errors"]),
         f"tp_hybrid: evicted {evicted} != TP=1's {sorted(hard['errors'])}")
    for o in outs:
        s = o["states"]
        for label in ("paged", "fault_expert", "fault_ssm_in",
                      "fault_ssm_out"):
            need(s[label] == s["dense"], f"tp_hybrid rank {o['rank']}: "
                 f"{label} state differs from the clean run's")
        t = o["timings"]["dense"]
        need(t["collectives_per_step"] == [HYBRID_COLLECTIVES],
             f"tp_hybrid rank {o['rank']}: collectives a step "
             f"{t['collectives_per_step']}")
        need(t["k1_per_step"] == ref_timing["k1_per_step"] == [68]
             and t["k1b_per_step"] == [12] and t["k3_per_step"] == [1],
             f"tp_hybrid rank {o['rank']}: K1/K1 batched/K3 a step "
             f"{t['k1_per_step']}/{t['k1b_per_step']}/{t['k3_per_step']}")
        for label, tl in o["timings"].items():
            need(tl["launches"]["abft_matmul"] > 0,
                 f"tp_hybrid {label}: no K1")
    # against TP=1
    vs = _hybrid_vs_tp1(cfg, ref, ref_logits, ref_score, routes, calls, gaps,
                        r0, recs["dense"])
    t = r0["timings"]["dense"]
    res = {"arch": HYBRID_ARCH, "layers": cfg.n_layers, "ranks": TP_RANKS,
           "backend": r0["backend"], "moe_mode": r0["moe_mode"],
           "devices": [o["device"] for o in outs],
           "weights_gb_per_rank": [o["weights_gb"] for o in outs],
           "init_s_per_rank": [o["init_s"] for o in outs],
           "draw_peak_gb_per_rank": [o["draw_peak_gb"] for o in outs],
           "serve_peak_gb_per_rank": [o["serve_peak_gb"] for o in outs],
           **vs, "evicted": evicted,
           "k1_per_step": t["k1_per_step"],
           "k1_batched_per_step": t["k1b_per_step"],
           "k3_per_step": t["k3_per_step"],
           "collectives_per_step": t["collectives_per_step"][0],
           "decode_step_ms_median": float(np.median(t["step_ms"])),
           "collectives_alone_ms_per_step_median": float(
               np.median(r0["collective_ms"])),
           "tp1_decode_step_ms_median": float(
               np.median(ref_timing["step_ms"])),
           "launches": {k: v["launches"] for k, v in r0["timings"].items()},
           "stats": {k: {f: v[f] for f in (
               "tokens", "faults_detected", "retries", "hard_faults",
               "evictions")} for k, v in st.items()},
           "audit": r0["audit"], "k1": r0["k1"], "spawn_seconds": spawn_s,
           "seconds": time.perf_counter() - t0,
           "note": "two ranks time-sharing one card over gloo: a "
                   "correctness run, not a tensor-parallel speed"}
    emit("tp_hybrid", **res)
    _hybrid_gates(vs)
    return res


def _add_tp_hybrid(kernels, hy) -> None:
    """The ``tp_hybrid`` phase's numbers on the kernels line: K1 at
    jamba's TP=2 shard shapes (2-D and batched over 8 experts), and
    K1/K3 launches a decode step a rank."""
    k1, k3 = kernels[0], kernels[2]
    k1["tp2_jamba_m4"] = {name: {key: rec[key] for key in (
        "k", "n", "out", "gemms", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "max_abs_err")}
        for name, rec in hy["k1"]["shapes"].items()}
    k1["tp2_jamba_batched"] = hy["k1"]["batched"]["timing"]
    k1["tp_hybrid_launches_per_step"] = hy["k1_per_step"]
    k3["tp_hybrid_launches_per_step"] = hy["k3_per_step"]


# ---------------------------------------------------------------- tp_mla

# deepseek-v3-671b as the mla phase serves it (published widths, 4 layers:
# 3 dense + 1 MoE, the MTP head) over two ranks sharing the card: MLA's
# q heads, w_uk/w_uv and wo split, the latent replicated, 128 of the 256
# experts a rank (EP), the shared expert column- and row-parallel.  A
# decode step's collectives by the design: the embedding 1, each layer's
# wo 1 and dense down 1 (3 layers), the MoE layer's wo, EP combine and
# shared down 3, the head's gather 1, the flag 1
MLA_TP_COLLECTIVES = 12
# K1 a decode step a rank: q_a, q_b, kv_a, o and the FFN's up, gate, down
# in each dense layer; q_a, q_b, kv_a, o, the router, the three batched
# expert GEMMs and the shared expert's three in the MoE layer; the head
MLA_TP_K1, MLA_TP_K1_BATCHED = 3 * 7 + 11 + 1, 3


def _mla_tp_faults(cfg) -> dict:
    """``mla.q_b`` (site ``qkv``) at layer 1 on column 3/4 of its width
    (column-parallel: rank 1's at TP=2), ``expert_up`` at the MoE layer 3
    (the reference's unbatched fault: every expert the rank holds, rank
    1's 128..255 among them), and the eviction run's ``mlp_down`` at
    layer 0 (row-parallel: rank 0's partial)."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.models.layers import ModelFault

    col = cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) \
        * 3 // 4
    return {"q_b": ModelFault.at(1, "qkv", FaultSpec.value(0, col, 1e5)),
            "expert_up": ModelFault.at(3, "expert_up",
                                       FaultSpec.value(0, 1, 1e5)),
            "hard": ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))}


def _latent_digest(eng) -> str:
    """A digest of every layer's latent cache leaf on this rank."""
    import hashlib

    h = hashlib.sha256()
    for layer in eng.cache:
        h.update(layer["latent"].float().cpu().numpy().tobytes())
    return h.hexdigest()


def tp_mla_k1(dev, model) -> dict:
    """K1 at rank 0's TP=2 shard shapes of a deepseek decode step, on the
    card alone once the ranks have ended: rank 0's shard drawn here
    (``init_params(mesh=)``, seed 0) and checked and timed by ``shard_k1``
    (the row-parallel ``o``, ``down`` and ``shared_down`` partials, the
    router and the head with f32 out; the MTP head's ``proj`` beside), then
    freed."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.mesh import Mesh

    mesh = Mesh(grid=np.arange(TP_RANKS).reshape(1, TP_RANKS),
                axis_names=("data", "model"),
                devices=(dev,) * TP_RANKS, rank=0)
    shard = model.init_params(0, dtype=torch.bfloat16, device=dev, mesh=mesh)
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(shard)) / 1e9
    out = shard_k1(dev, model.cfg, shard, "tp_mla",
                   {"o", "down", "shared_down", "router", "head"}, seed=43,
                   extra={"mtp_proj": [shard["mtp"]["proj"]]})
    out["shard_gb"] = gb
    del shard
    free_memory()
    return out


def tp_mla_rank(prompts, device_type: str = "cuda") -> dict:
    """One rank of the ``tp_mla`` phase: deepseek-v3-671b at published
    widths and ``MLA_LAYERS`` layers with its MTP head, only this rank's
    shard drawn (``init_params(mesh=)``, seed 0); served at ``mesh=2``:
    dense (its first logits, gaps, calls and routing kept on rank 0),
    paged, a ``mla.q_b`` fault on rank 1's columns at decode step 2 with
    an ``expert_up`` fault at the second admission, hard-fault eviction;
    each run's latent-cache digest; the 1 x ``HYBRID_SCORE_L`` score with
    ``mtp_logits``; the collectives timed alone; the rank-0 audit; the
    peak memory.  Every record is checked equal across the ranks."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.models.model import Model

    import torch.distributed as dist

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tp_mla rank: no CUDA device")
    cfg = mla_config()
    model = Model(cfg)
    mesh = build_mesh(model=TP_RANKS, data=1,
                      devices=rank_devices(device_type))
    dev = mesh.device
    rank = mesh.model_rank
    # one rank draws at a time: each draw's transient (one f32 slice of
    # 2**30 elements, 4.3 GB) beside both shards, never two of them
    for r in range(TP_RANKS):
        if r == rank:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params = model.init_params(0, dtype=torch.bfloat16, device=dev,
                                       mesh=mesh)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t
            draw_peak = torch.cuda.max_memory_allocated()
            free_memory()
        dist.barrier(group=mesh.group)
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    card_free = torch.cuda.mem_get_info()[0]
    torch.cuda.reset_peak_memory_stats()
    faults = _mla_tp_faults(cfg)
    recs, timings, digests = {}, {}, {}

    def run(label, **kw):
        eng, rec, timing, cap = tp_serve(model, params, prompts, dev, label,
                                         mesh=mesh, **kw)
        rec = {**rec, "latent": _latent_digest(eng)}
        collectives.check_same(rec, eng.executor.tp, label)
        recs[label], timings[label] = rec, timing
        return eng, cap

    routes = [] if rank == 0 else None
    eng, cap = run("dense", capture=None, routes=routes)
    ex = eng.executor
    tp = ex.tp
    out = {"rank": rank, "backend": tp.backend, "device": str(eng.device),
           "sharded": sorted(tp.sharded), "moe_mode": ex.hints.moe_mode,
           "plan": [{k: r[k] for k in ("layer", "m", "k", "n", "scheme")}
                    for r in eng.plan.report_rows()]}
    score = _hybrid_score(model, ex.params, dev, cfg, ex.hints, tp)
    if rank == 0:
        out["logits"] = {k: v.numpy() for k, v in cap.first.items()}
        out["routes"], out["calls"], out["score"] = routes, cap.calls, score
    del eng, cap, ex
    run("paged", cache_kind="paged", capture=False)
    run("faults", fault_at=(2, faults["q_b"]),
        admit_fault_at=(1, faults["expert_up"]), capture=False)
    run("hard_fault", fault_at=(1, faults["hard"]), max_retries=0,
        capture=False)
    out["collective_ms"] = _tp_collective_ms(
        cfg, tp, MLA_TP_COLLECTIVES - 2, 0, dev)
    out["audit"] = _hybrid_audit(model, params, prompts, dev, mesh, rank,
                                 phase="tp_mla")
    out["records"], out["timings"] = recs, timings
    out["init_s"], out["weights_gb"] = init_s, weights / 1e9
    out["draw_peak_gb"] = draw_peak / 1e9
    out["card_free_gb_after_draws"] = card_free / 1e9
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _mtp_vs_tp1(ref_score, score) -> dict:
    """The score's ``mtp_logits`` at TP=2 against TP=1's: the per-position
    error, its scale, and the error before the first position routed apart
    in either MoE layer (layer 3's and the MTP head's)."""
    pos_err = torch.from_numpy(np.abs(score["mtp_logits"]
                                      - ref_score["mtp_logits"]).max(-1))
    rec = _routing_diff([torch.from_numpy(r) for r in score["routes"]],
                        [torch.from_numpy(r) for r in ref_score["routes"]],
                        pos_err, HYBRID_SCORE_L)
    rec["logit_scale"] = float(np.abs(ref_score["mtp_logits"]).max())
    rec["max_abs_err"] = float(pos_err.max())
    return rec


def tp_mla_runs(dev, tp1, prompts) -> dict:
    """The ``tp_mla`` phase: deepseek-v3-671b at published widths and 4
    layers with its MTP head served over two ranks sharing this card
    (gloo), each drawing only its 26.9 GB shard, against the TP=1 run the
    mla phase kept on the host (``mla_tp1``) and against itself: K1 at
    rank 0's shard shapes against its plain version (``tp_mla_k1``, after
    the ranks); records and latent digests equal across the ranks; dense
    = paged = faulted streams, each fault detected and retried, the
    faulted run's latent cache equal to the clean run's; evictions as at
    TP=1; 12 collectives, 33 K1 (3 batched) and no K2 or K3 a decode step
    a rank; against TP=1 the score's logits and ``mtp_logits`` within
    ``MLA_SCORE_TOL`` of their scale before the first position routed
    apart, the first routing flip a router near-tie, each divergent
    stream after a flip or at a logit near-tie (``_hybrid_gates``); the
    rank-0 audit at fraction 1.0 with MLA's core the known gap.  Two ranks
    time-slicing one card over gloo: the times are not a TP speed."""
    from repro_torch.distributed import spawn
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = mla_config()
    emit_memory("tp_mla")
    t_spawn = time.perf_counter()
    outs = spawn.run(tp_mla_rank, TP_RANKS, prompts, dev.type,
                     device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    free_memory()
    k1 = tp_mla_k1(dev, Model(cfg))
    r0 = outs[0]
    recs = r0["records"]
    for o in outs[1:]:
        need(o["records"] == recs, f"tp_mla: rank {o['rank']}'s records "
             f"differ from rank 0's")
    st = {k: v["stats"] for k, v in recs.items()}
    shard_gb = cfg_weights_gb(cfg, TP_RANKS)
    for label, rec in recs.items():
        if label != "hard_fault":
            need(not rec["errors"], f"tp_mla {label}: {rec['errors']}")
            need(all(len(s) == TP_NEW for s in rec["streams"].values()),
                 f"tp_mla {label}: incomplete streams")
            need(rec["streams"] == recs["dense"]["streams"],
                 f"tp_mla: {label} streams differ from dense")
    need(st["faults"]["faults_detected"] >= 2
         and st["faults"]["retries"] >= 2
         and st["faults"]["hard_faults"] == 0,
         f"tp_mla faults: {st['faults']}")
    need(recs["faults"]["latent"] == recs["dense"]["latent"],
         "tp_mla: the faulted run's latent cache differs from the clean "
         "run's")
    need(st["hard_fault"]["hard_faults"] >= 1, "tp_mla: no hard fault")
    evicted = sorted(int(u) for u in recs["hard_fault"]["errors"])
    need(evicted == sorted(int(u) for u in tp1["hard"]["errors"]),
         f"tp_mla: evicted {evicted} != TP=1's "
         f"{sorted(tp1['hard']['errors'])}")
    for o in outs:
        t = o["timings"]["dense"]
        need(t["collectives_per_step"] == [MLA_TP_COLLECTIVES],
             f"tp_mla rank {o['rank']}: collectives a step "
             f"{t['collectives_per_step']}")
        need(t["k1_per_step"] == tp1["timing"]["k1_per_step"] == [MLA_TP_K1]
             and t["k1b_per_step"] == [MLA_TP_K1_BATCHED]
             and t["k3_per_step"] == [0],
             f"tp_mla rank {o['rank']}: K1/K1 batched/K3 a step "
             f"{t['k1_per_step']}/{t['k1b_per_step']}/{t['k3_per_step']}")
        for label, tl in o["timings"].items():
            need(tl["launches"]["abft_matmul"] > 0, f"tp_mla {label}: no K1")
            need(tl["launches"]["flash_decode"] == 0,
                 f"tp_mla {label}: K3 launched on the MLA path")
        need(abs(o["weights_gb"] - shard_gb) < 1e-9,
             f"tp_mla rank {o['rank']}: {o['weights_gb']} GB drawn, its "
             f"shard is {shard_gb} GB")
    audit = r0["audit"]
    need(audit["known_gap_flops"].get("mla", 0) > 0,
         f"tp_mla audit: MLA's core is not the known gap: {audit}")
    # against TP=1
    vs = _hybrid_vs_tp1(cfg, tp1["rec"], tp1["logits"], tp1["score"],
                        tp1["routes"], tp1["calls"], tp1["gaps"], r0,
                        recs["dense"])
    mtp = _mtp_vs_tp1(tp1["score"], r0["score"])
    t = r0["timings"]["dense"]
    res = {"arch": MLA_ARCH, "layers": cfg.n_layers, "ranks": TP_RANKS,
           "backend": r0["backend"], "moe_mode": r0["moe_mode"],
           "devices": [o["device"] for o in outs], "sharded": r0["sharded"],
           "plan": r0["plan"],
           "weights_gb_per_rank": [o["weights_gb"] for o in outs],
           "init_s_per_rank": [o["init_s"] for o in outs],
           "draw_peak_gb_per_rank": [o["draw_peak_gb"] for o in outs],
           "card_free_gb_after_draws": r0["card_free_gb_after_draws"],
           "serve_peak_gb_per_rank": [o["serve_peak_gb"] for o in outs],
           **vs, "mtp_score": mtp, "evicted": evicted,
           "routing_flips_engine": _count_flips(tp1["routes"],
                                                r0["routes"]),
           "k1_per_step": t["k1_per_step"],
           "k1_batched_per_step": t["k1b_per_step"],
           "k3_per_step": t["k3_per_step"],
           "collectives_per_step": t["collectives_per_step"][0],
           "decode_step_ms_median": float(np.median(t["step_ms"])),
           "collectives_alone_ms_per_step_median": float(
               np.median(r0["collective_ms"])),
           "tp1_decode_step_ms_median": float(
               np.median(tp1["timing"]["step_ms"])),
           "launches": {k: v["launches"] for k, v in r0["timings"].items()},
           "stats": {k: {f: v[f] for f in (
               "tokens", "faults_detected", "retries", "hard_faults",
               "evictions")} for k, v in st.items()},
           "audit": audit, "k1": k1, "spawn_seconds": spawn_s,
           "seconds": time.perf_counter() - t0,
           "note": "two ranks time-sharing one card over gloo: a "
                   "correctness run, not a tensor-parallel speed"}
    emit("tp_mla", **res)
    _hybrid_gates(vs, phase="tp_mla")
    need(mtp["first_position_routed_apart"] > 0
         and mtp["max_abs_err_before_it"] <= MLA_SCORE_TOL
         * mtp["logit_scale"],
         f"tp_mla: mtp_logits off TP=1 by {mtp['max_abs_err_before_it']} "
         f"before the first position routed apart ({mtp})")
    return res


# ------------------------------------------------------------------ dp

# (data, model) of the phase: four gloo ranks sharing the card, two
# replicas (data) of two tensor-parallel ranks (model)
DP_SHAPE = (2, 2)
# mlp_down at logical row 3 of a 4-slot decode step: data rank 1's row 1
DP_ROW = 3
# the sequence-sharded cell: one slot, a 2048-token prompt, a dense cache
# of 2560 positions (1280 a data rank: rank 0 holds the prompt's head,
# rank 1 its tail and the new tokens)
DP_SEQ_PROMPT, DP_SEQ_LEN = 2048, 2560
# its first decode step's logits against the one-slot TP=1 twin's, as a
# share of the twin's logit scale: the ranks merge bf16 attention
# partials, each normalized over its half (probabilities rounded to bf16
# a half at a time), so the sums part from the twin's by a few bf16 ulps
DP_SEQ_LOGIT_TOL = 0.02
# the FSDP cell: qwen1.5-32b at published widths, 2 of its 64 layers
# (5.2 GB in bf16, 1.3 GB a rank), four requests of 4 new tokens: each
# step gathers every weight's model shard over gloo through the host
DP_FSDP_ARCH, DP_FSDP_LAYERS, DP_FSDP_NEW = "qwen1.5-32b", 2, 4
# the sharing traffic: a 512-token system prefix (SYS_LEN) in requests 0
# and 4; request 2 (slot 2, data rank 1's) finishes first, so request 4
# takes slot 2 and shares what request 0 (slot 0, data rank 0's)
# prefilled
DP_SHARE_NEW = (TP_NEW, TP_NEW, 2, TP_NEW, TP_NEW)


def dp_share_traffic(vocab: int) -> list:
    rng = np.random.default_rng(27)
    sys_ = rng.integers(1, vocab, size=SYS_LEN)
    tail = [rng.integers(1, vocab, size=n) for n in (20, 100, 30, 60, 15)]
    out = [np.concatenate([sys_, tail[0]]), tail[1], tail[2], tail[3],
           np.concatenate([sys_, tail[4]])]
    return [p.astype(np.int32) for p in out]


def dp_fsdp_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(DP_FSDP_ARCH),
                               n_layers=DP_FSDP_LAYERS)


def _dp_cache_digest(eng) -> str:
    """A digest of every leaf of the rank's cache shard."""
    import hashlib

    h = hashlib.sha256()
    for layer in eng.cache:
        for key in sorted(layer):
            h.update(layer[key].float().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_slot_log(slots: dict):
    """An ``on_engine`` hook: {uid: slot} of every admitted request."""
    def hook(eng):
        admit = eng.admit

        def logged(*a, **k):
            out = admit(*a, **k)
            for s, req in eng.active.items():
                slots.setdefault(int(req.uid), int(s))
            for s, cur in eng._prefill_cursors.items():
                slots.setdefault(int(cur.req.uid), int(s))
            return out

        eng.admit = logged
    return hook


def _dp_collective_ms(cfg, tp, dp, world, dev) -> list:
    """The host ms of a (2, 2) decode step's collectives alone at its
    sizes (a data rank's 2 rows): the embedding's and each layer's two
    (2, d) f32 model sums, the head's (2, vocab / 2) model gather, the
    logits' (2, vocab) data gather and the flag's OR over the world,
    between two device syncs and a barrier; 20 times."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    x = torch.zeros(2, cfg.d_model, device=dev)
    half = torch.zeros(2, 1, cfg.vocab_size // 2, device=dev)
    whole = torch.zeros(2, 1, cfg.vocab_size, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    out = []
    for _ in range(20):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(2 * cfg.n_layers + 1):
            collectives.all_reduce_sum(x, tp)
        collectives.gather_last(half, tp)
        collectives.gather_first(whole, dp)
        collectives.or_flag(flag, world)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def _dp_gather_ms(fn, reps: int) -> list:
    """Host ms of ``fn()`` (a step's collectives of one kind, alone)
    between a barrier and two device syncs, ``reps`` times."""
    import torch.distributed as dist

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t))
    return out


def _dp_k3_shard(eng, dev, n: int) -> dict:
    """K3 on this rank's sequence shard (layer 0's k/v, the rank's part of
    the ``n`` cells the run wrote, a seeded bf16 q at its heads) with its
    lse,
    against the plain version: the partial output within 2^-7 of its
    scale (one bf16 rounding of either side) and the lse within 1e-3
    absolute (f32 sums of bf16 scores)."""
    from repro_torch.kernels.flash_attention import (
        flash_decode_kernel,
        flash_decode_ref,
    )

    sp = eng.executor.cache_split
    kc, vc = eng.cache[0]["k"], eng.cache[0]["v"]
    local = max(0, min(sp.n, n - sp.lo))
    heads = eng.executor.params["layers"][0]["mixer"]["wq"].shape[1] // \
        kc.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(31)
    q = torch.randn(1, 1, heads, kc.shape[-1], generator=gen,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor([local], dtype=torch.int32, device=dev)
    got = flash_decode_kernel(q, kc, vc, None, lengths, block=16, lse=True)
    ref = flash_decode_ref(q, kc, vc, None, lengths, block=16, lse=True)
    err = float((got[0].float() - ref[0].float()).abs().max())
    scale = float(ref[0].float().abs().max())
    lse_err = float((got[-1] - ref[-1]).abs().max()) if local else 0.0
    need(err <= 2 ** -7 * max(scale, 1e-6) and lse_err <= 1e-3
         and (local > 0 or bool(torch.isneginf(got[-1]).all())),
         f"dp K3 lse on the shard: err {err} (scale {scale}), lse {lse_err}")
    return {"keys_held": int(kc.shape[1]), "valid": local,
            "max_abs_err": err, "lse_max_abs_err": lse_err}


def dp_rank(prompts, share, seq_prompt, fsdp_prompts, fsdp_thr) -> dict:
    """One rank of the ``dp`` phase (``distributed/spawn.py``, four ranks
    on the one card): llama3.2-1b at full width and ``SERVED_LAYERS``
    layers, this rank's shard drawn from seed 0, served at
    ``(data=2, model=2)``: dense (its first logits kept on rank 0), paged
    and paged + shared + chunked on the sharing traffic, a decode fault
    on logical row 3 (data rank 1's row 1) with an admission fault, a
    hard fault; the sequence-sharded cell (one slot, a 2048-token prompt,
    K3's lse on the rank's shard); the collectives timed alone; the
    rank-0 audit; then, with ``sharding.FSDP_THRESHOLD`` lowered to
    ``fsdp_thr`` in this process, qwen1.5-32b at 2 layers drawn and
    served under FSDP.  Every record is checked equal over the world."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.distributed import collectives, sharding
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.models import layers
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    if not torch.cuda.is_available():
        raise RuntimeError("dp rank: no CUDA device")
    mesh = build_mesh(data=DP_SHAPE[0], model=DP_SHAPE[1],
                      devices=rank_devices("cuda"))
    dev = mesh.device
    cfg = served_config()
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(0, dtype=torch.bfloat16, device=dev,
                               mesh=mesh)
    world = collectives.world_group()
    recs, timings, digests, extra = {}, {}, {}, {}

    def run(label, model_=model, params_=params, prompts_=prompts, **kw):
        eng, rec, timing, cap = tp_serve(model_, params_, prompts_, dev,
                                         label, mesh=mesh, **kw)
        collectives.check_same(rec, world, label)
        recs[label], timings[label] = rec, timing
        digests[label] = _dp_cache_digest(eng)
        return eng, cap

    eng, cap = run("dense", capture=None)
    ex = eng.executor
    out = {"rank": mesh.rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "device": str(eng.device),
           "backend": ex.dp.backend, "rows": list(ex.rows),
           "cache_rows": int(eng.cache[0]["k"].shape[0]),
           "plan": [{k: r[k] for k in ("layer", "m", "k", "n", "scheme")}
                    for r in eng.plan.report_rows()]}
    if mesh.rank == 0:
        out["logits"] = {k: v.numpy() for k, v in cap.first.items()}
    tp, dp = ex.tp, ex.dp
    del eng, cap, ex
    run("paged", prompts_=share, new=list(DP_SHARE_NEW), max_len=1024,
        cache_kind="paged", capture=False)
    slots = {}
    run("shared", prompts_=share, new=list(DP_SHARE_NEW), max_len=1024,
        cache_kind="paged", prefix_sharing=True, chunk_tokens=SHARE_CHUNK,
        capture=False, on_engine=_dp_slot_log(slots))
    extra["shared_slots"] = slots
    row = ModelFault.at(0, "mlp_down", FaultSpec.value(DP_ROW, 1, 1e5))
    down = _tp_faults(cfg)["down"]
    fired, row_fault = [], layers._row_fault

    def logged(fault, x, w, ctx, out_dtype):
        got = row_fault(fault, x, w, ctx, out_dtype)
        if fault is not None and fault.row == DP_ROW and ctx.rows:
            fired.append(None if got is None else got.row)
        return got

    layers._row_fault = logged
    try:
        run("fault", fault_at=(2, row), admit_fault_at=(0, down),
            capture=False)
    finally:
        layers._row_fault = row_fault
    out["row_fault_local_rows"] = sorted(set(fired), key=str)
    run("hard_fault", fault_at=(1, row), max_retries=0, capture=False)
    # the sequence-sharded cell
    eng, cap = run("seq", prompts_=[seq_prompt], slots=1,
                   max_len=DP_SEQ_LEN, capture=None)
    sp = eng.executor.cache_split
    out["seq_shard"] = [sp.kind, sp.lo, sp.n,
                        list(eng.cache[0]["k"].shape)]
    # the cells written: the prompt and every new token but the last
    out["seq_k3"] = _dp_k3_shard(eng, dev, DP_SEQ_PROMPT + TP_NEW - 1)
    # a one-slot decode step's LSE combines alone: one a layer, each a
    # (1, 1, heads, head_dim) partial and its lse
    part = torch.zeros(1, 1, cfg.n_heads // DP_SHAPE[1],
                       cfg.resolved_head_dim, device=dev)
    lse = torch.zeros(1, 1, cfg.n_heads // DP_SHAPE[1], device=dev)
    def combines():
        for _ in range(cfg.n_layers):
            collectives.lse_combine(part, lse, dp)

    out["lse_combine_ms"] = _dp_gather_ms(combines, 20)
    if mesh.rank == 0:
        out["seq_logits"] = {k: v.numpy() for k, v in cap.first.items()}
    del eng, cap
    out["collective_ms"] = _dp_collective_ms(cfg, tp, dp, world, dev)
    out["audit"] = _hybrid_audit(model, params, prompts, dev, mesh,
                                 mesh.rank, phase="dp")
    out["llama_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for key, val in extra.items():
        collectives.check_same(val, world, key)
    out.update(extra)
    del params
    free_memory()
    # FSDP: the cut qwen1.5-32b over the threshold this process lowers
    sharding.FSDP_THRESHOLD = fsdp_thr
    fcfg = dp_fsdp_config()
    fmodel = Model(fcfg)
    torch.cuda.reset_peak_memory_stats()
    fparams = fmodel.init_params(0, dtype=torch.bfloat16, device=dev,
                                 mesh=mesh)
    draw_peak = torch.cuda.max_memory_allocated()
    full = {}
    sharding.map_with_path(lambda ps, t: full.__setitem__(ps, t.numel()),
                           fmodel.param_shapes())
    shares = {}
    sharding.map_with_path(
        lambda ps, t: shares.__setitem__(ps, full[ps] // t.numel()), fparams)
    out["fsdp_shares"] = shares
    out["fsdp_weights_gb"] = sum(
        full[ps] // shares[ps] for ps in full) * 2 / 1e9
    torch.cuda.reset_peak_memory_stats()
    eng, cap = run("fsdp", model_=fmodel, params_=fparams,
                   prompts_=fsdp_prompts,
                   new=[DP_FSDP_NEW] * len(fsdp_prompts), capture=None)
    out["fsdp_paths"] = sorted(eng.executor.dp.sharded)
    out["fsdp_serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # a decode step's FSDP gathers alone: every FSDP leaf once, each
    # gathered leaf freed before the next, as a step frees it
    fdp = eng.executor.dp
    flat = {}
    sharding.map_with_path(lambda ps, t: flat.__setitem__(ps, t), fparams)
    leaves = [(t, fdp.dims[ps.split("/", 2)[-1] if ps.startswith(
        "layers/") else ps]) for ps, t in flat.items()
        if (ps.split("/", 2)[-1] if ps.startswith("layers/") else ps)
        in fdp.dims]
    def gathers():
        for t, dim in leaves:
            collectives.fsdp_gather(t, fdp, dim)

    out["fsdp_gather_ms"] = _dp_gather_ms(gathers, 3)
    out["fsdp_gathers_timed"] = len(leaves)
    if mesh.rank == 0:
        out["fsdp_logits"] = {k: v.numpy() for k, v in cap.first.items()}
    out["fsdp_draw_peak_gb"] = draw_peak / 1e9
    del eng, cap, fparams
    out["records"], out["timings"], out["digests"] = recs, timings, digests
    return out


def dp_k3_timing(dev, cfg) -> dict:
    """K3 with its lse at a sequence shard's shapes: one slot, 1280 keys
    (a data rank's half of 2560), a model rank's 4 kv heads and 16 q heads
    of llama (bf16), held against the plain version, timed (CUDA graphs)
    beside the lse-less launch, the plain version, SDPA and the bound
    (K and V read once)."""
    from repro_torch.kernels.flash_attention import (
        flash_decode_kernel,
        flash_decode_ref,
    )

    S = DP_SEQ_LEN // DP_SHAPE[0]
    KV, D = cfg.n_kv_heads // DP_SHAPE[1], cfg.resolved_head_dim
    H = cfg.n_heads // DP_SHAPE[1]
    gen = torch.Generator(device=dev).manual_seed(29)
    q = torch.randn(1, 1, H, D, generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(1, S, KV, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    lengths = torch.full((1,), S, dtype=torch.int32, device=dev)
    got = flash_decode_kernel(q, kc, vc, None, lengths, block=16, lse=True)
    ref = flash_decode_ref(q, kc, vc, None, lengths, block=16, lse=True)
    _k3_close(got[:5], ref[:5], 2 ** -7, "dp K3 shard")
    lse_err = float((got[-1] - ref[-1]).abs().max())
    need(lse_err <= 1e-3, f"dp K3 shard lse err {lse_err}")
    qt = q.transpose(1, 2)
    res = {"keys": S, "kv_heads": KV, "heads": H,
           "max_abs_err": float((got[0].float() - ref[0].float())
                                .abs().max()),
           "lse_max_abs_err": lse_err,
           "ms": timed_graph(lambda: flash_decode_kernel(
               q, kc, vc, None, lengths, block=16, lse=True), iters=20),
           "ms_without_lse": timed_graph(lambda: flash_decode_kernel(
               q, kc, vc, None, lengths, block=16), iters=20),
           "plain_ms": timed_graph(lambda: flash_decode_ref(
               q, kc, vc, None, lengths, block=16, lse=True), iters=2),
           "library_ms": timed_graph(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kc.transpose(1, 2), vc.transpose(1, 2),
                   enable_gqa=True), iters=20),
           "bound_ms": 2 * S * KV * D * 2 / HBM_BW * 1e3,
           "bound_by": "bytes"}
    emit("dp_k3", **res)
    return res


def dp_runs(dev, tp_ref=None) -> dict:
    """The ``dp`` phase: data-parallel serving over a (data=2, model=2)
    mesh of four gloo ranks sharing this card.  In this process: K1 at a
    rank's split-decode shapes (M = 2 of the 4 slots) against its plain
    version; K3's lse at a sequence shard's shapes; the one-process twins
    (the ``tp`` phase's TP=1 llama run, or one made here; the one-slot
    2048-token run; qwen1.5-32b at 2 layers).  Then the ranks
    (``dp_rank``) and the gates: records equal on all four ranks; dense
    against the twin (first logits; a divergent stream only at a
    near-tie); shared + chunked = paged, with request 4 in data rank 1's
    slot 2 sharing the 512-token prefix request 0 prefilled from slot 0;
    the row-3 fault fired on data rank 1 alone at its row 1 and was
    recovered (streams and the cache shard equal the clean run's);
    evictions equal the twin's; each rank holding 2 slots (1280 positions
    in the one-slot cell), the combined decode logits within
    ``DP_SEQ_LOGIT_TOL`` of the one-slot twin's; under FSDP each rank
    holding a quarter of each weight split on both axes, FSDP gathers a
    step, streams near-tie equal to the twin; K1, K3 and collectives a
    step by kind; the rank-0 audit at 1.0; peak memory a rank.  Four
    ranks time-sharing one card over gloo: the times are not a
    data-parallel speed."""
    from repro_torch.distributed import spawn
    from repro_torch.models.counting import count_params
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = served_config()
    model = Model(cfg)
    params, prompts = engine_inputs(dev, cfg=cfg)
    k1 = tp_k1_checks(dev, model, params, m=2, phase="dp_k1")
    ref = tp_ref or tp_reference(dev, model, params, prompts)
    share = dp_share_traffic(cfg.vocab_size)
    rng = np.random.default_rng(28)
    seq_prompt = rng.integers(1, cfg.vocab_size,
                              size=DP_SEQ_PROMPT).astype(np.int32)
    _, seq_ref, seq_timing, seq_cap = tp_serve(
        model, params, [seq_prompt], dev, "seq_tp1", slots=1,
        max_len=DP_SEQ_LEN, capture=[seq_prompt])
    seq_ref_logits = {k: v.numpy() for k, v in seq_cap.first.items()}
    seq_gaps = seq_cap.gaps
    del seq_cap
    k3 = dp_k3_timing(dev, cfg)
    del params
    free_memory()
    fcfg = dp_fsdp_config()
    fmodel = Model(fcfg)
    fparams = fmodel.init_params(0, dtype=torch.bfloat16, device=dev)
    frng = np.random.default_rng(30)
    fsdp_prompts = [frng.integers(1, fcfg.vocab_size, size=int(n)).astype(
        np.int32) for n in frng.integers(16, 129, size=4)]
    _, fsdp_ref, fsdp_timing, fcap = tp_serve(
        fmodel, fparams, fsdp_prompts, dev, "fsdp_tp1",
        new=[DP_FSDP_NEW] * 4, capture=fsdp_prompts)
    fsdp_ref_logits = {k: v.numpy() for k, v in fcap.first.items()}
    fsdp_gaps = fcap.gaps
    del fparams, fcap
    free_memory()
    thr = count_params(fcfg) - 1
    t_spawn = time.perf_counter()
    outs = spawn.run(dp_rank, DP_SHAPE[0] * DP_SHAPE[1], prompts, share,
                     seq_prompt, fsdp_prompts, thr, device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    r0 = outs[0]
    recs = r0["records"]
    for o in outs[1:]:
        need(o["records"] == recs, f"dp: rank {o['rank']}'s records differ "
             f"from rank 0's")
    st = {k: v["stats"] for k, v in recs.items()}
    # each replica's two model ranks hold the same cache shard; the two
    # replicas hold other slots
    by_data = {}
    for o in outs:
        by_data.setdefault(o["data_rank"], []).append(o)
        need(o["rows"] == [2 * o["data_rank"], 2] and o["cache_rows"] == 2,
             f"dp rank {o['rank']}: rows {o['rows']}, cache rows "
             f"{o['cache_rows']}")
        need(o["seq_shard"][:3] == ["seq", 1280 * o["data_rank"], 1280]
             and o["seq_shard"][3][:2] == [1, 1280],
             f"dp rank {o['rank']}: sequence shard {o['seq_shard']}")
    for label, rec in recs.items():
        if label != "hard_fault":
            need(not rec["errors"], f"dp {label}: errors {rec['errors']}")
    need(recs["shared"]["streams"] == recs["paged"]["streams"],
         "dp: shared + chunked streams differ from the paged run's")
    need(st["shared"]["prefix_tokens_shared"] >= SYS_LEN
         and st["shared"]["prefill_chunks"] > 0,
         f"dp shared: {st['shared']}")
    slots = r0["shared_slots"]
    need(slots[0] == 0 and slots[4] == 2,
         f"dp shared: requests in slots {slots}, not 0 and 2")
    need(recs["fault"]["streams"] == recs["dense"]["streams"],
         "dp: the faulted streams differ from the clean run's")
    need(st["fault"]["faults_detected"] >= 2 and st["fault"]["retries"] >= 2
         and st["fault"]["hard_faults"] == 0, f"dp fault: {st['fault']}")
    for o in outs:
        want = [1] if o["data_rank"] == 1 else [None]
        need(o["row_fault_local_rows"] == want,
             f"dp rank {o['rank']}: the row-{DP_ROW} fault landed at "
             f"{o['row_fault_local_rows']}, not {want}")
        need(o["digests"]["fault"] == o["digests"]["dense"],
             f"dp rank {o['rank']}: the recovered cache differs")
    evicted = sorted(int(u) for u in recs["hard_fault"]["errors"])
    need(st["hard_fault"]["hard_faults"] >= 1
         and evicted == sorted(int(u) for u in ref["hard"]["errors"]),
         f"dp: evicted {evicted} != TP=1's {sorted(ref['hard']['errors'])}")
    # against the twins
    diff = max(float(np.abs(r0["logits"][k] - ref["logits"][k]).max())
               for k in ("prefill", "decode"))
    equal, ties = _near_tie_gate(ref["rec"]["streams"],
                                 recs["dense"]["streams"], ref["gaps"],
                                 diff, "dp")
    seq_scale = float(np.abs(seq_ref_logits["decode"]).max())
    seq_diff = float(np.abs(r0["seq_logits"]["decode"]
                            - seq_ref_logits["decode"]).max())
    need(seq_diff <= DP_SEQ_LOGIT_TOL * seq_scale,
         f"dp seq: decode logits off the twin's by {seq_diff} "
         f"(scale {seq_scale})")
    seq_equal, seq_ties = _near_tie_gate(
        seq_ref["streams"], recs["seq"]["streams"], seq_gaps,
        max(seq_diff, float(np.abs(r0["seq_logits"]["prefill"]
                                   - seq_ref_logits["prefill"]).max())),
        "dp seq")
    fdiff = max(float(np.abs(r0["fsdp_logits"][k] - fsdp_ref_logits[k])
                      .max()) for k in ("prefill", "decode"))
    f_equal, f_ties = _near_tie_gate(fsdp_ref["streams"],
                                     recs["fsdp"]["streams"], fsdp_gaps,
                                     fdiff, "dp fsdp")
    for o in outs:
        sh = o["fsdp_shares"]
        need(sh["layers/0/mixer/wq"] == 4 and sh["layers/0/ffn/down"] == 4
             and sh["embed"] == 4 and sh["lm_head"] == 4,
             f"dp fsdp rank {o['rank']}: shares {sh}")
    # the step's kernels and collectives, on every rank
    L = cfg.n_layers
    for o in outs:
        t = o["timings"]["dense"]
        kinds = t["kinds_per_step"]
        need(kinds["model_sum"] == [2 * L + 1]
             and kinds["model_gather"] == [1]
             and kinds["data_gather"] == [1] and kinds["flag"] == [1]
             and kinds["fsdp_gather"] == [0],
             f"dp rank {o['rank']}: collectives a step {kinds}")
        need(t["k1_per_step"] == [7 * L + 1] and t["k3_per_step"] == [L],
             f"dp rank {o['rank']}: K1/K3 a step {t['k1_per_step']}/"
             f"{t['k3_per_step']}")
        ts = o["timings"]["seq"]
        need(ts["kinds_per_step"]["lse_combine"] == [L]
             and ts["k3_per_step"] == [L],
             f"dp rank {o['rank']}: seq step {ts['kinds_per_step']}")
        tf = o["timings"]["fsdp"]
        need(min(tf["kinds_per_step"]["fsdp_gather"]) > 0,
             f"dp rank {o['rank']}: no FSDP gather a step")
        for label, tl in o["timings"].items():
            need(tl["launches"]["abft_matmul"] > 0, f"dp {label}: no K1")
    t = r0["timings"]
    res = {"mesh": list(DP_SHAPE), "backend": r0["backend"],
           "devices": [o["device"] for o in outs],
           "plan": r0["plan"], "streams_equal_tp1": len(equal),
           "streams": len(ref["rec"]["streams"]), "divergent": ties,
           "max_logit_diff_vs_tp1": diff, "evicted": evicted,
           "shared_slots": slots,
           "row_fault_local_rows": {o["rank"]: o["row_fault_local_rows"]
                                    for o in outs},
           "seq": {"shard": [o["seq_shard"] for o in outs],
                   "k3_on_shard": [o["seq_k3"] for o in outs],
                   "decode_logit_diff_vs_tp1": seq_diff,
                   "logit_scale": seq_scale,
                   "stream_equal_tp1": bool(seq_equal),
                   "divergent": seq_ties,
                   "k3_per_step": t["seq"]["k3_per_step"],
                   "decode_step_ms_median": float(np.median(
                       t["seq"]["step_ms"])),
                   "tp1_decode_step_ms_median": float(np.median(
                       seq_timing["step_ms"]))},
           "fsdp": {"arch": DP_FSDP_ARCH, "layers": DP_FSDP_LAYERS,
                    "threshold_lowered_to": thr,
                    "paths": r0["fsdp_paths"],
                    "weights_gb_a_rank": r0["fsdp_weights_gb"],
                    "draw_peak_gb": [o["fsdp_draw_peak_gb"] for o in outs],
                    "serve_peak_gb": [o["fsdp_serve_peak_gb"]
                                      for o in outs],
                    "streams_equal_tp1": len(f_equal), "divergent": f_ties,
                    "max_logit_diff_vs_tp1": fdiff,
                    "gathers_per_step": t["fsdp"]["kinds_per_step"][
                        "fsdp_gather"],
                    "decode_step_ms_median": float(np.median(
                        t["fsdp"]["step_ms"])),
                    "tp1_decode_step_ms_median": float(np.median(
                        fsdp_timing["step_ms"]))},
           "k1_per_step": t["dense"]["k1_per_step"],
           "k3_per_step": t["dense"]["k3_per_step"],
           "collectives_per_step": t["dense"]["kinds_per_step"],
           "seq_collectives_per_step": t["seq"]["kinds_per_step"],
           "decode_step_ms_median": float(np.median(
               t["dense"]["step_ms"])),
           "collectives_alone_ms_per_step_median": float(
               np.median(r0["collective_ms"])),
           "lse_combines_alone_ms_per_step_median": float(
               np.median(r0["lse_combine_ms"])),
           "fsdp_gathers_alone_ms_per_step_median": float(
               np.median(r0["fsdp_gather_ms"])),
           "fsdp_gathers_timed": r0["fsdp_gathers_timed"],
           "tp1_decode_step_ms_median": float(
               np.median(ref["timing"]["step_ms"])),
           "launches": {k: v["launches"] for k, v in t.items()},
           "stats": {k: {f: v[f] for f in (
               "tokens", "faults_detected", "retries", "hard_faults",
               "evictions", "prefill_chunks", "prefix_tokens_shared")}
               for k, v in st.items()},
           "llama_peak_gb": [o["llama_peak_gb"] for o in outs],
           "audit": r0["audit"], "k1": k1, "k3": k3,
           "spawn_seconds": spawn_s, "seconds": time.perf_counter() - t0,
           "note": "four ranks time-sharing one card over gloo: a "
                   "correctness run, not a data-parallel speed"}
    emit("dp", **res)
    return res


def _add_dp(kernels, dp) -> None:
    """The ``dp`` phase's numbers on the kernels line: K1 at a rank's
    split-decode shapes (M = 2), K3 with its lse on a sequence shard, and
    K1/K3 launches a decode step a rank."""
    k1, k3 = kernels[0], kernels[2]
    k1["dp_m2"] = {name: {key: rec[key] for key in (
        "k", "n", "out", "ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err")} for name, rec in dp["k1"].items()}
    k1["dp_launches_per_step"] = dp["k1_per_step"]
    k3["dp_launches_per_step"] = dp["k3_per_step"]
    k3["dp_seq_shard"] = {**dp["k3"],
                          "launches_per_step": dp["seq"]["k3_per_step"]}


# ------------------------------------------------------------ dp_train

# sharded training: llama3.2-1b at full width and SERVED_LAYERS layers,
# f32, over a (data=2, model=2) mesh of four gloo ranks sharing the card,
# global batches of TRAIN_B x TRAIN_L (2 rows a data rank), three AdamW
# steps at lr 3e-4 under --abft auto
DP_TRAIN_STEPS = 3
# mlp_down at logical batch row 3 (position 5): the flattened row of a
# block scheme's (row, position) GEMM rows, data rank 1's local row
# TRAIN_L + 5
DP_TRAIN_ROW = 3 * TRAIN_L + 5


def dp_train_config():
    return served_config()


def dp_train_k1(dev, cfg) -> dict:
    """K1 at the sharded train step's GEMMs: f32, M = TRAIN_B * TRAIN_L
    / 2 rows (a data rank's), rank 0's model = 2 shard of seed 0's f32
    weights (q, kv, o, up/gate, down, the head): each against its plain
    version (``_k1_site_check``: y within 1e-4 of its scale, bounds, no
    false flag), then timed beside the plain version, ``torch.matmul``
    and the bound (``k1_timing``, CUDA graphs)."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.model import Model

    model = Model(cfg)
    m = TRAIN_B * TRAIN_L // DP_SHAPE[0]
    mesh = Mesh(grid=np.arange(DP_SHAPE[1]).reshape(1, DP_SHAPE[1]),
                axis_names=("data", "model"),
                devices=(dev,) * DP_SHAPE[1], rank=0)
    shard = model.init_params(0, dtype=torch.float32, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(12)
    checks = {}
    for name, ws in _step_gemm_groups(shard).items():
        err, scale, ratio, rt = _k1_site_check(
            dev, gen, cfg, f"dp_train {name}", ws[0], torch.float32, m)
        checks[name] = {"k": int(ws[0].shape[0]), "n": int(ws[0].shape[1]),
                        "route": rt, "max_abs_err": err, "max_abs_y": scale,
                        "clean_ratio": ratio}
    timing = k1_timing(dev, shard, m, per_shape=True)
    del shard
    free_memory()
    out = {"m": m, "checks": checks, "step_total": {
        k: v for k, v in timing.items() if k != "per_shape"},
        "per_shape": timing["per_shape"]}
    emit("dp_train_k1", **out)
    return out


def _dp_train_twin(dev, cfg, workdir: str) -> dict:
    """The one-process twin: ``Trainer`` on seed 0's f32 weights and the
    phase's batches, three steps; each step's loss, grad norm and ms; the
    first step's update of every leaf kept on the host (by path) for the
    ranks' gathered updates.  Freed before the ranks start."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import abft_config
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32, device=dev)
    tr = Trainer(model, params, TrainConfig(opt=OptConfig(lr=3e-4)),
                 DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                            vocab_size=cfg.vocab_size),
                 TrainerConfig(steps=1, ckpt_every=10 ** 9,
                               ckpt_dir=workdir),
                 abft=abft_config("auto"), device=dev)
    norms = _record_grad_norms(tr)
    p0 = _flat_host(tr.params)
    tr.run()
    upd = {k: v - p0[k] for k, v in _flat_host(tr.params).items()}
    del p0
    tr.rcfg.steps = DP_TRAIN_STEPS
    tr.run()
    out = {"losses": [h["loss"] for h in tr.history], "grad_norms": norms,
           "step_ms": [1e3 * h["time_s"] for h in tr.history],
           "update": upd}
    del tr, params
    free_memory()
    return out


def _record_grad_norms(tr) -> list:
    """Wrap ``tr.step_fn``: the grad norm of each step's last attempt."""
    norms, base = [], tr.step_fn

    def step(*a, **k):
        out = base(*a, **k)
        if len(norms) == tr.step:
            norms.append(None)
        norms[tr.step] = float(out[2]["grad_norm"])
        return out

    tr.step_fn = step
    return norms


def _flat_host(tree) -> dict:
    from repro_torch.distributed.sharding import map_with_path

    out = {}
    map_with_path(lambda ps, t: out.__setitem__(ps, t.detach().float()
                                                .cpu()), tree)
    return out


def _dp_train_collective_ms(pl, grads, dev, act_shape, head_shape,
                            n_act: int, reps: int = 3,
                            data_axis: bool = True) -> dict:
    """Host ms of a sharded train step's collectives alone, by kind, at
    this rank's sizes (``pl``: the step's ``Placement``; ``grads``: a tree
    shaped as its gradients), between a barrier and two device syncs: the
    gradient all-reduce over ``data`` (every leaf of the rank's shard,
    bucketed), the ZeRO-1 gather (the rank's slices), and the model
    axis's ``n_act`` activation sums of a step (``model_sum`` +
    ``model_grad``, each an ``act_shape`` f32 tensor) with the head's
    gather of ``head_shape`` (None: a replicated head); ``reps`` times
    each (the model axis's alone without ``data_axis``)."""
    import torch.distributed as dist

    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import collectives

    leaves = tree_leaves(grads)
    summed = [leaves[i] for i in pl.summed]
    cut = [i for i, d in enumerate(pl.shards.zero) if d is not None]
    slices = [pl.shards.cut(i, leaves[i]).contiguous() for i in cut]
    dims = [pl.shards.zero[i] for i in cut]
    act = torch.zeros(act_shape, device=dev)
    head = (torch.zeros(head_shape, device=dev) if head_shape is not None
            else None)

    def acts():
        for _ in range(n_act):
            collectives.all_reduce_sum(act, pl.tp)
        if head is not None:
            collectives.gather_last(head, pl.tp)

    out = {}
    kinds = (("grad_sum", lambda: collectives.sum_grads(summed, pl.dp)),
             ("zero_gather", lambda: collectives.gather_zero(
                 list(slices), dims, pl.dp)),
             ("model_axis", acts))
    for kind, fn in kinds if data_axis else kinds[2:]:
        ms = []
        for _ in range(reps):
            _sync(dev)
            dist.barrier(group=pl.world.group if pl.world else None)
            t = time.perf_counter()
            fn()
            _sync(dev)
            ms.append(1e3 * (time.perf_counter() - t))
        out[kind] = ms
    out["grad_sum_bytes"] = sum(4 * t.numel() for t in summed) \
        if pl.data > 1 else 0
    out["zero_gather_bytes"] = sum(t.numel() * t.element_size()
                                   for t in slices) * pl.data
    return out


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(dev) -> float | None:
    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 1e9


def _digest_tree(tree) -> str:
    import hashlib

    from repro_torch.core.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_rank(workdir: str, device_type: str = "cuda") -> dict:
    """One rank of the ``dp_train`` phase (four ranks on the card): its
    shard of seed 0's f32 llama drawn at ``(data=2, model=2)``
    (``init_params(mesh=)``), a ``Trainer(mesh=)`` over the phase's
    batches: steps 1-2 saving a checkpoint after step 2 (under the
    trainer's step index 1), step 3 with its
    first attempt faulted at logical row 3 (the world's flag; retried),
    then step 3 again, clean, from the step-2 state (its state must equal
    the retried one bit for bit); K1 launches and collectives by kind a
    step; the first step's update of each leaf written for the parent
    (data rank 0's ranks); the moments' shapes and bytes; the collectives
    timed alone.  Then the step-2 checkpoint restored onto a (data=1,
    model=2) mesh of ranks 0 and 1 (``plan_remesh(2, 2)``) and step 3
    run there.  Every record is checked equal over the world."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import collectives
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.distributed.sharding import (
        map_with_path,
        opt_state_specs,
        shard_shape,
    )
    from repro_torch.kernels import abft_matmul
    from repro_torch.launch.train import abft_config
    from repro_torch.models import layers
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.runtime.elastic import plan_remesh
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    K1 = abft_matmul.KERNEL
    mesh = build_mesh(data=DP_SHAPE[0], model=DP_SHAPE[1],
                      devices=rank_devices(device_type))
    dev = mesh.device
    cfg = dp_train_config()
    model = Model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = model.init_params(0, dtype=torch.float32, device=dev, mesh=mesh)
    world = collectives.world_group()
    ckpt = os.path.join(workdir, "ckpt")
    tr = Trainer(model, params, TrainConfig(opt=OptConfig(lr=3e-4)),
                 DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                            vocab_size=cfg.vocab_size),
                 TrainerConfig(steps=1, ckpt_every=1, ckpt_dir=ckpt),
                 abft=abft_config("auto"), mesh=mesh)
    del params
    raw = tr.step_fn
    norms = _record_grad_norms(tr)
    fault = ModelFault.at(0, "mlp_down",
                          FaultSpec.value(DP_TRAIN_ROW, 1, 1e5))
    base, per_step, flags = tr.step_fn, [], []

    def step(p, o, batch):
        # the first attempt of step 3 is faulted; every attempt counted
        first = tr.step == 2 and not [s for s in per_step if s["step"] == 2]
        K1.launches = 0
        collectives.reset_counts()
        _sync(dev)
        t = time.perf_counter()
        out = base(p, o, batch, fault=fault if first else None)
        _sync(dev)
        per_step.append({"step": tr.step, "faulted": first,
                         "ms": 1e3 * (time.perf_counter() - t),
                         "k1": K1.launches,
                         "collectives": {k: v for k, v in
                                         collectives.COUNTS.items() if v}})
        flags.append(bool(out[2]["abft_flag"]))
        return out

    tr.step_fn = step
    p0 = _flat_host(tr.params) if mesh.data_rank == 0 else None
    tr.run()                                     # step 1
    if p0 is not None:
        upd = {k: (v - p0[k]).numpy() for k, v in
               _flat_host(tr.params).items()}
        np.savez(os.path.join(workdir, f"update_m{mesh.model_rank}.npz"),
                 **{k.replace("/", "|"): v for k, v in upd.items()})
        del upd, p0
    tr.rcfg.steps = 2
    tr.run()                                     # step 2, saved after it
    s2 = (tr.params, tr.opt_state)
    tr.rcfg.steps, tr.rcfg.ckpt_every = DP_TRAIN_STEPS, 10 ** 9
    fired, row_fault = [], layers._row_fault

    def logged(f, *a, **k):
        got = row_fault(f, *a, **k)
        if f is not None:
            fired.append(None if got is None else int(got.row))
        return got

    layers._row_fault = logged
    try:
        tr.run()                                 # step 3, faulted, retried
    finally:
        layers._row_fault = row_fault
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in tr.data.batch(DP_TRAIN_STEPS - 1).items()}
    clean_p, clean_o, _ = raw(*s2, batch)
    same = (_digest_tree(clean_p) == _digest_tree(tr.params)
            and _digest_tree(clean_o.mu) == _digest_tree(tr.opt_state.mu)
            and _digest_tree(clean_o.nu) == _digest_tree(tr.opt_state.nu))
    del clean_p, clean_o, s2
    # the ZeRO-1 shards
    shapes = model.param_shapes()
    full, ospec = {}, {}
    map_with_path(lambda ps, t: full.__setitem__(ps, tuple(t.shape)), shapes)
    map_with_path(lambda ps, s: ospec.__setitem__(ps, s),
                  opt_state_specs(cfg, shapes, mesh))
    mu = _flat_host(tr.opt_state.mu)
    zero_ok = all(tuple(mu[k].shape) == shard_shape(ospec[k], full[k], mesh)
                  for k in mu)
    share = {k: int(np.prod(full[k])) // max(1, mu[k].numel())
             for k in ("embed", "layers/0/mixer/wq", "layers/0/ffn/down",
                       "final_norm/w")}
    moment_bytes = 2 * sum(t.numel() * 4 for t in tree_leaves(
        tr.opt_state.mu))
    del mu
    b = TRAIN_B // DP_SHAPE[0]
    # model_sum 4 L + 1, model_grad 5 L + 1 a step
    coll_ms = _dp_train_collective_ms(
        tr.placement, tr.params, dev, (b, TRAIN_L, cfg.d_model),
        (b, TRAIN_L, cfg.vocab_size // DP_SHAPE[1]), 9 * cfg.n_layers + 2)
    rec = {"losses": [h["loss"] for h in tr.history], "grad_norms": norms,
           "retries": [h["retries"] for h in tr.history],
           "events": [list(e) for e in tr.events], "flags": flags,
           "retry_equals_clean": same, "zero1_shapes_ok": zero_ok}
    collectives.check_same(rec, world, "dp_train records")
    out = {"rank": mesh.rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "device": str(dev),
           "backend": world.backend, "records": rec,
           "per_step": per_step, "step_ms": [1e3 * h["time_s"]
                                             for h in tr.history],
           "fault_rows": sorted(set(fired), key=str),
           "moment_shares": share, "moment_bytes": moment_bytes,
           "param_bytes": sum(t.numel() * 4 for t in tree_leaves(
               tr.params)),
           "collective_ms": coll_ms, "train_peak_gb": _peak_gb(dev)}
    # reshard-on-restore: the checkpoint after step 2 onto the plan's mesh
    plan = plan_remesh(2, model_parallel=DP_SHAPE[1])
    like = tr.params
    del tr
    free_memory()
    mesh12 = build_mesh(data=plan.data, model=plan.model,
                        devices=rank_devices(device_type)[:plan.devices_used])
    if mesh.rank < plan.devices_used:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tr = Trainer(model, like, TrainConfig(opt=OptConfig(lr=3e-4)),
                     DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                                vocab_size=cfg.vocab_size),
                     TrainerConfig(steps=DP_TRAIN_STEPS, ckpt_dir=ckpt),
                     abft=abft_config("auto"), mesh=mesh12)
        del like
        t = time.perf_counter()
        state, step = tr.ckpt.restore(
            {"params": tr.params, "opt": tr.opt_state}, step=1,
            shardings=tr.shardings)
        restore_s = time.perf_counter() - t
        tr.params, tr.opt_state, tr.step = state["params"], state["opt"], 2
        del state
        K1.launches = 0
        hist = tr.run()
        out["restore"] = {"plan": list(plan.shape), "step": step,
                          "seconds": restore_s,
                          "step3_loss": hist[0]["loss"],
                          "step3_ms": 1e3 * hist[0]["time_s"],
                          "k1": K1.launches, "peak_gb": _peak_gb(dev)}
        del tr
    else:
        del like
    free_memory()
    return out


def dp_train_runs(dev) -> dict:
    """The ``dp_train`` phase: sharded training of llama3.2-1b at full
    width and ``SERVED_LAYERS`` layers, f32, over a (data=2, model=2)
    mesh of four gloo ranks sharing this card (``dp_train_rank``).  In
    this process first: K1 at the rank's shard shapes (``dp_train_k1``)
    and the one-process twin (``_dp_train_twin``), freed.  The gates
    (the ``train`` phase's tolerances): every step's loss within 1e-5
    relative of the twin's, ``grad_norm`` within 1e-4 relative, each
    leaf's first-step update (gathered from the ranks) within 1e-3 of its
    norm; records equal on the four ranks; each rank's moments its ZeRO-1
    shard (a quarter of every two-axis leaf); the row-3 fault fired on
    data rank 1 alone, flagged on all four, retried to the clean state;
    the step-2 checkpoint restored onto (1, 2) continuing within 1e-5
    relative of the (2, 2) run's step 3; K1 launched on every rank.
    Four ranks time-share one card over gloo: no data-parallel speed."""
    import tempfile

    from repro_torch.distributed import spawn
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import (
        map_with_path,
        param_specs,
        shard_slices,
    )
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = dp_train_config()
    k1 = dp_train_k1(dev, cfg)
    with tempfile.TemporaryDirectory(prefix="dp_train_") as workdir:
        twin = _dp_train_twin(dev, cfg, workdir)
        t_spawn = time.perf_counter()
        outs = spawn.run(dp_train_rank, DP_SHAPE[0] * DP_SHAPE[1], workdir,
                         dev.type, device=dev.type)
        spawn_s = time.perf_counter() - t_spawn
        # the first step's updates, gathered from data rank 0's ranks
        geom = Mesh(grid=np.arange(4).reshape(DP_SHAPE),
                    axis_names=("data", "model"), devices=(dev,) * 4)
        specs = {}
        map_with_path(lambda ps, s: specs.__setitem__(ps, s),
                      param_specs(cfg, Model(cfg).param_shapes(), geom))
        worst = 0.0
        for m in range(DP_SHAPE[1]):
            with np.load(os.path.join(workdir, f"update_m{m}.npz")) as z:
                for key in z.files:
                    path = key.replace("|", "/")
                    want = twin["update"][path]
                    idx = shard_slices(specs[path], tuple(want.shape), geom,
                                       {"data": 0, "model": m})
                    w = want[idx].numpy()
                    rel = float(np.linalg.norm(z[key] - w)
                                / max(np.linalg.norm(w), 1e-30))
                    worst = max(worst, rel)
    twin.pop("update")
    recs = outs[0]["records"]
    need(all(o["records"] == recs for o in outs),
         "dp_train: the ranks' records differ")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(recs["losses"],
                                                    twin["losses"])]
    gn_rel = [abs(a - b) / abs(b) for a, b in zip(recs["grad_norms"],
                                                  twin["grad_norms"])]
    need(len(recs["losses"]) == DP_TRAIN_STEPS and max(loss_rel) <= 1e-5
         and max(gn_rel) <= 1e-4 and worst <= 1e-3,
         f"dp_train vs the twin: loss {loss_rel}, grad_norm {gn_rel}, "
         f"update {worst}")
    need(recs["retries"] == [0, 0, 1] and recs["flags"] == [False, False,
                                                             True, False]
         and recs["events"] == [["checkpoint", 1], ["abft_retry", 2]]
         and recs["retry_equals_clean"] and recs["zero1_shapes_ok"],
         f"dp_train records {recs}")
    for o in outs:
        want = [TRAIN_L + 5] if o["data_rank"] == 1 else [None]
        need(o["fault_rows"] == want,
             f"dp_train rank {o['rank']}: the row fault landed at "
             f"{o['fault_rows']}, not {want}")
        sh = o["moment_shares"]
        need(sh["layers/0/mixer/wq"] == 4 and sh["layers/0/ffn/down"] == 4
             and sh["embed"] == 4 and sh["final_norm/w"] == 1,
             f"dp_train rank {o['rank']}: moment shares {sh}")
        need(all(s["k1"] > 0 for s in o["per_step"]),
             f"dp_train rank {o['rank']}: a step launched no K1")
    step3 = recs["losses"][2]
    for o in outs[:2]:
        r = o["restore"]
        rel = abs(r["step3_loss"] - step3) / abs(step3)
        need(r["plan"] == [1, 2] and r["step"] == 1 and rel <= 1e-5
             and r["k1"] > 0,
             f"dp_train restore onto (1, 2) on rank {o['rank']}: {r}, "
             f"loss off by {rel}")
    r0 = outs[0]
    clean = [s for s in r0["per_step"] if not s["faulted"]]
    res = {"mesh": list(DP_SHAPE), "backend": r0["backend"],
           "devices": [o["device"] for o in outs],
           "config": {"arch": ENGINE_ARCH, "layers": cfg.n_layers,
                      "dtype": "float32", "batch": [TRAIN_B, TRAIN_L],
                      "rows_a_data_rank": TRAIN_B // DP_SHAPE[0]},
           "losses": recs["losses"], "twin_losses": twin["losses"],
           "loss_rel_vs_twin": loss_rel, "grad_norm_rel_vs_twin": gn_rel,
           "update_rel_worst_leaf": worst,
           "step_ms_per_rank": {o["rank"]: o["step_ms"] for o in outs},
           "twin_step_ms": twin["step_ms"],
           "k1_per_step": {o["rank"]: [s["k1"] for s in o["per_step"]]
                           for o in outs},
           "collectives_per_step": clean[-1]["collectives"],
           "collectives_alone_ms": r0["collective_ms"],
           "moment_bytes_per_rank": [o["moment_bytes"] for o in outs],
           "param_bytes_per_rank": [o["param_bytes"] for o in outs],
           "moment_shares": r0["moment_shares"],
           "fault_rows": {o["rank"]: o["fault_rows"] for o in outs},
           "retries": recs["retries"],
           "retry_equals_clean": recs["retry_equals_clean"],
           "restore": {o["rank"]: o["restore"] for o in outs[:2]},
           "peak_gb_per_rank": [o["train_peak_gb"] for o in outs],
           "k1": {"m": k1["m"], "step_total": k1["step_total"]},
           "spawn_seconds": spawn_s,
           "seconds": time.perf_counter() - t0,
           "note": "four ranks time-sharing one card over gloo: a "
                   "correctness run, not a data-parallel speed"}
    emit("dp_train", **res)
    return {**res, "k1_shapes": k1["per_shape"],
            "k1_checks": k1["checks"]}


def _add_dp_train(kernels, dpt) -> None:
    """The ``dp_train`` phase's numbers on the kernels line: K1 at the
    sharded train step's shapes (f32, M = 256, the model = 2 shard) and
    its launches a step on each rank."""
    k1 = kernels[0]
    k1["dp_train_f32_m256"] = {name: {key: rec[key] for key in (
        "k", "n", "gemms", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for name, rec in dpt["k1_shapes"].items()}
    k1["dp_train_max_abs_err"] = max(c["max_abs_err"]
                                     for c in dpt["k1_checks"].values())
    k1["dp_train_launches_per_step"] = dpt["k1_per_step"]


# ------------------------------------------------------ dp_train_families

# sharded training of the MLA, Mamba2 and memory families at published
# widths, f32, by four gloo ranks sharing the card (one spawn): (arch,
# layers kept, (data, model)).  deepseek's first layer (``mla:dense:0``)
# and its MTP head over (1, 2) on ranks 0-1 (at data = 2 its replicated
# state would not fit four ranks on one card), first, so its twin, the
# longest, runs while the fresh ranks warm up; mamba2 at SERVED_LAYERS of
# 48 over both axes; the vision model's first cross layer (layer 3) and
# the three before it over (2, 2)
DPF_MODELS = (("deepseek-v3-671b", 1, (1, 2)),
              ("mamba2-1.3b", SERVED_LAYERS, (2, 2)),
              ("llama-3.2-vision-11b", 4, (2, 2)))
# vision takes one step: its second (13.7-17.2 s a rank over gloo) went
# for the script's time after a 1301 s run on a slow host
DPF_STEPS = {"mamba2-1.3b": 2, "deepseek-v3-671b": 2,
             "llama-3.2-vision-11b": 1}
# the data axis's collectives are timed alone on mamba2's ranks (gloo's
# rate); vision's 3.95 GB a rank would take 12 s more
# moments in bf16 (the reference's dry run keeps deepseek's so): with
# f32 ones deepseek's twin and the vision model's four ranks would not
# fit the card beside the functional update's new params and moments
DPF_MOMENTS = {"deepseek-v3-671b": "bfloat16",
               "llama-3.2-vision-11b": "bfloat16"}
DPF_DATA_TIMED = ("mamba2-1.3b",)
# mamba2's second step: a value fault at ssm_out (row-parallel: model
# rank 0's partial) in logical batch row 3, data rank 1's local row
# TRAIN_L + 5
DPF_FAULT_ARCH = "mamba2-1.3b"
# the K1 shapes timed beside the plain version and torch.matmul: (arch,
# group, leaf paths below the layer); the rest are checked only
DPF_TIMED = (("deepseek-v3-671b", "ffn_up_gate", ("ffn/up", "ffn/gate")),
             ("deepseek-v3-671b", "q_b", ("mixer/wq_b",)),
             ("llama-3.2-vision-11b", "cross_kv", ("cross/wk", "cross/wv")))
# the ranks wait this long for the parent's twin of a model
DPF_WAIT_S = 420.0
# the worst leaf's first update against the twin's, relative to its
# norm: AdamW's first step moves each entry by lr g / (|g| + eps), so an
# entry with |g| near eps = 1e-8 turns the f32 sums' order into an
# lr-sized move either way (deepseek's embedding: 1.08e-3 on the card);
# a sign error in a leaf's gradients moves it by O(1), and a scale error
# shows in the grad norm and the second step's loss
DPF_UPDATE_TOL = 1e-2
# the leaves a train step multiplies by (2-D GEMM weights)
DPF_GEMMS = ("wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "in_z",
             "in_x", "in_bc", "in_dt", "out_proj", "up", "gate", "down",
             "lm_head", "embed", "proj", "vision_proj")


def dpf_config(arch):
    from repro_torch.configs import get_config

    layers = {a: n for a, n, _ in DPF_MODELS}[arch]
    return dataclasses.replace(get_config(arch), n_layers=layers)


def _dpf_tag(arch) -> str:
    return arch.split("-")[0]


def _dpf_params(model, dev, mesh=None):
    """Seed 0's f32 weights (the rank's shard with ``mesh``), every cross
    gate at ``CROSS_GATE``, so the images reach the loss."""
    params = model.init_params(0, dtype=torch.float32, device=dev,
                               mesh=mesh)
    for lp in params["layers"]:
        if "cross_gate" in lp:
            lp["cross_gate"].fill_(CROSS_GATE)
    return params


def _dpf_batches(cfg, dev) -> list:
    """The phase's global batches: ``SyntheticLM``'s TRAIN_B x TRAIN_L
    tokens and labels, and (vision) TRAIN_B x 1601 x 1280 f32 image
    embeddings from seed 7, made on the host and moved."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                                  vocab_size=cfg.vocab_size))
    gen = torch.Generator().manual_seed(7)
    out = []
    for s in range(DPF_STEPS[cfg.name]):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
        if cfg.vision_dim:
            b["images"] = torch.randn(
                TRAIN_B, cfg.n_image_tokens, cfg.vision_dim,
                generator=gen).to(dev)
        out.append(b)
    return out


def _dpf_step(model, mesh=None, dev=None):
    from repro_torch.launch.train import abft_config
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.train_step import make_train_step

    opt = OptConfig(lr=3e-4, moment_dtype=DPF_MOMENTS.get(model.cfg.name,
                                                          "float32"))
    tcfg = TrainConfig(opt=opt)
    return make_train_step(model, abft_config("auto"), tcfg,
                           device=None if mesh is not None else dev,
                           mesh=mesh), tcfg


def _metrics(met) -> dict:
    return {k: (bool(v) if k == "abft_flag" else float(v))
            for k, v in met.items()}


def _dpf_twin(dev, arch, outdir: str) -> dict:
    """The one-process twin of one model: seed 0's whole f32 model, the
    phase's steps through ``make_train_step``; each step's metrics and
    ms; the first step's update of every leaf written to ``outdir`` (one
    ``.npy`` a leaf, in tree order) for the ranks.  Freed after."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as opt_lib

    os.makedirs(outdir, exist_ok=True)
    cfg = dpf_config(arch)
    model = Model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = _dpf_params(model, dev)
    step, tcfg = _dpf_step(model, dev=dev)
    state = opt_lib.init_opt_state(params, tcfg.opt)
    rec = {"steps": [], "ms": []}
    for s, batch in enumerate(_dpf_batches(cfg, dev)):
        _sync(dev)
        t = time.perf_counter()
        new_p, new_s, met = step(params, state, batch)
        _sync(dev)
        rec["ms"].append(1e3 * (time.perf_counter() - t))
        rec["steps"].append(_metrics(met))
        if s == 0:
            for i, (a, b) in enumerate(zip(tree_leaves(params),
                                           tree_leaves(new_p))):
                np.save(os.path.join(outdir, f"{i}.npy"),
                        (b - a).float().cpu().numpy())
        params, state = new_p, new_s
        del new_p, new_s
    rec["peak_gb"] = _peak_gb(dev)
    del params, state, step
    free_memory()
    return rec


def _dpf_k1_predicted(shard, abft, m: int, mem_m: int) -> int:
    """K1 launches a sharded train step makes on a rank, from its layer
    list: each layer's block-protected GEMMs (the policy's scheme at the
    rank's rows ``m`` and the shard's (K, N); a cross layer's K/V at the
    memory's ``mem_m`` rows) twice, as the recompute runs every layer
    again, but for its last projection, which runs outside the recomputed
    region (a dense FFN's ``down``; the SSD ``out_proj`` of a Mamba2
    layer with no FFN): once; the memory's ``vision_proj``, the encoder's
    layers (at ``mem_m`` rows, not recomputed) and the head once; the MTP
    head's ``proj``, layer and head once more."""
    from repro_torch.core.intensity import GemmDims
    from repro_torch.core.policy import scheme_name_of
    from repro_torch.core.protected import _BLOCK_MODES

    def k1(rows, w) -> int:
        dims = GemmDims(m=rows, k=int(w.shape[0]), n=int(w.shape[1]),
                        batch=1, dtype_bytes=4, out_dtype_bytes=4)
        return int(scheme_name_of(abft.resolve(dims)) in _BLOCK_MODES)

    def layer(lp, m=m) -> int:
        n = sum(k1(m, lp["mixer"][w]) for w in (
            "wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "in_z", "in_x",
            "in_bc", "in_dt", "out_proj") if w in lp["mixer"])
        if "cross" in lp:
            c = lp["cross"]
            n += k1(m, c["wq"]) + k1(mem_m, c["wk"]) + k1(mem_m, c["wv"]) \
                + k1(m, c["wo"])
        n += sum(k1(m, lp["ffn"][w]) for w in ("up", "gate", "down")
                 if w in lp.get("ffn", {}))
        return n

    def tail(lp) -> int:
        ffn = lp.get("ffn", {})
        if "down" in ffn:
            return k1(m, ffn["down"])
        if not ffn and "cross" not in lp and "out_proj" in lp["mixer"]:
            return k1(m, lp["mixer"]["out_proj"])
        return 0

    head = shard["lm_head"] if "lm_head" in shard else shard["embed"].t()
    total = sum(2 * layer(lp) - tail(lp) for lp in shard["layers"]) \
        + k1(m, head)
    if "vision_proj" in shard:
        total += k1(mem_m, shard["vision_proj"])
    if "encoder" in shard:
        total += sum(layer(lp, mem_m) for lp in shard["encoder"]["layers"])
    if "mtp" in shard:
        total += k1(m, shard["mtp"]["proj"]) + layer(shard["mtp"]["layer"]) \
            + k1(m, head)
    return total


def _dpf_wait(path: str, stop) -> None:
    """Wait for ``path`` to exist; raise on ``DPF_WAIT_S`` or where
    ``stop()`` says the other side has failed."""
    t = time.monotonic()
    while not os.path.exists(path):
        if stop():
            raise RuntimeError(f"dp_train_families: gave up on {path}")
        if time.monotonic() - t > DPF_WAIT_S:
            raise RuntimeError(f"dp_train_families: {path} never came")
        time.sleep(0.2)


def _dpf_update_err(old, new, mesh, model, twindir) -> tuple:
    """(worst relative error, its leaf): this rank's first update of each
    leaf against the twin's (its shard of the twin's whole update, read
    from ``twindir``), ||a - b|| / ||b||."""
    from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.distributed.sharding import (
        map_with_path,
        param_specs,
        shard_slices,
    )

    specs = {}
    map_with_path(lambda ps, sp: specs.__setitem__(ps, sp),
                  param_specs(model.cfg, model.param_shapes(), mesh))
    coords = mesh.coords()
    worst, at = 0.0, None
    for i, ((path, a), b) in enumerate(zip(tree_leaves_with_path(old),
                                           tree_leaves(new))):
        key = "/".join(str(k) for k in path)
        whole = np.load(os.path.join(twindir, f"{i}.npy"), mmap_mode="r")
        idx = shard_slices(specs[key], whole.shape, mesh, coords)
        want = torch.from_numpy(np.array(whole[idx])).to(b.device)
        got = (b - a).float()
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want).clamp_min(1e-30))
        if rel >= worst:
            worst, at = rel, key
        del want, got
    return worst, at


def _dpf_rank_model(arch, mesh, workdir) -> dict:
    """One model on this rank of ``mesh``: its shard drawn
    (``init_params(mesh=)``), the phase's steps through
    ``make_train_step(mesh=)`` after the parent's twin is written; the
    replicated leaves' gradients hashed once summed (the first step);
    K1 launches and collectives by kind each attempt; the first update
    held against the twin's (data rank 0); mamba2's second step faulted
    first, then retried, then run clean again from the same state (its
    result must be the retry's bit for bit); the collectives timed
    alone; peak memory."""
    import hashlib

    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import map_with_path, param_specs
    from repro_torch.kernels import abft_matmul
    from repro_torch.launch.train import abft_config
    from repro_torch.models import layers
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    K1 = abft_matmul.KERNEL
    dev = mesh.device
    cfg = dpf_config(arch)
    model = Model(cfg)
    tag = _dpf_tag(arch)
    # the twin's card memory is free before this rank draws
    _dpf_wait(os.path.join(workdir, tag, "READY"), lambda: os.path.exists(
        os.path.join(workdir, "ABORT")))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = _dpf_params(model, dev, mesh)
    draw_s = time.perf_counter() - t
    step, tcfg = _dpf_step(model, mesh)
    pl = step.placement
    state = opt_lib.init_opt_state(params, tcfg.opt, pl.shards)
    predicted = _dpf_k1_predicted(
        params, abft_config("auto"), TRAIN_B // pl.data * TRAIN_L,
        TRAIN_B // pl.data * cfg.n_image_tokens)
    batches = _dpf_batches(cfg, dev)
    split = {}
    map_with_path(lambda ps, sp: split.__setitem__(
        ps, "model" in ts._axes(sp)),
        param_specs(cfg, model.param_shapes(), mesh))
    digests, base_sum = {}, ts._sum_over_data

    def hashed(grads, placement):
        out = base_sum(grads, placement)
        if not digests:
            for path, g in tree_leaves_with_path(out):
                key = "/".join(str(k) for k in path)
                if not split[key]:
                    digests[key] = hashlib.sha256(
                        g.detach().cpu().numpy().tobytes()).hexdigest()
        return out

    fault = ModelFault.at(0, "ssm_out", FaultSpec.value(DP_TRAIN_ROW, 1,
                                                        1e5))
    fired, row_fault = [], layers._row_fault

    def logged(f, *a, **k):
        got = row_fault(f, *a, **k)
        if f is not None:
            fired.append(None if got is None else int(got.row))
        return got

    attempts, rec = [], {"steps": []}

    def attempt(s, p, o, batch, f=None):
        K1.launches = 0
        collectives.reset_counts()
        _sync(dev)
        t = time.perf_counter()
        out = step(p, o, batch, fault=f)
        _sync(dev)
        attempts.append({"step": s, "faulted": f is not None,
                         "ms": 1e3 * (time.perf_counter() - t),
                         "k1": K1.launches,
                         "collectives": {k: v for k, v in
                                         collectives.COUNTS.items() if v},
                         "flag": bool(out[2]["abft_flag"])})
        return out

    ts._sum_over_data, layers._row_fault = hashed, logged
    try:
        for s, batch in enumerate(batches):
            if arch == DPF_FAULT_ARCH and s == 1:
                attempt(s, params, state, batch, fault)
                layers._row_fault = row_fault
                new_p, new_s, met = attempt(s, params, state, batch)
                again = attempt(s, params, state, batch)
                rec["retry_equals_clean"] = (
                    _digest_tree(again[0]) == _digest_tree(new_p)
                    and _digest_tree(again[1].mu) == _digest_tree(new_s.mu)
                    and _digest_tree(again[1].nu) == _digest_tree(new_s.nu))
                del again
            else:
                new_p, new_s, met = attempt(s, params, state, batch)
            rec["steps"].append(_metrics(met))
            if s == 0 and mesh.data_rank == 0:
                rec["update_err"] = _dpf_update_err(
                    params, new_p, mesh, model, os.path.join(workdir, tag))
            params, state = new_p, new_s
            del new_p, new_s
    finally:
        ts._sum_over_data, layers._row_fault = base_sum, row_fault
    clean = [a for a in attempts if not a["faulted"]][-1]["collectives"]
    b = TRAIN_B // pl.data
    vocab_split = pl.tp is not None and pl.tp.splits(
        "embed" if cfg.tie_embeddings else "lm_head")
    coll_ms = _dp_train_collective_ms(
        pl, params, dev, (b, TRAIN_L, cfg.d_model),
        (b, TRAIN_L, cfg.vocab_size // mesh.shape["model"])
        if vocab_split else None,
        clean.get("model_sum", 0) + clean.get("model_grad", 0), reps=1,
        data_axis=arch in DPF_DATA_TIMED)
    rec.update({
        "rank": mesh.rank, "coords": mesh.coords(), "draw_s": draw_s,
        "attempts": attempts, "k1_predicted": predicted,
        "replicated_grads": digests, "fault_rows": sorted(set(fired),
                                                          key=str),
        "param_gb": sum(t.numel() * 4 for _, t in
                        tree_leaves_with_path(params)) / 1e9,
        "moment_gb": sum(t.numel() * t.element_size() for _, t in
                         tree_leaves_with_path(state.mu)) * 2 / 1e9,
        "collective_ms": coll_ms, "peak_gb": _peak_gb(dev)})
    del params, state, step, batches
    return rec


def _warm_remat() -> None:
    """A process's first checkpointed backward imports torch's compiler
    stack (≈ 10 s of host time on the card's host, more on a slow one):
    taken here on a scalar while the parent runs the first twin."""
    from torch.utils.checkpoint import checkpoint

    x = torch.ones(2, requires_grad=True)
    checkpoint(lambda a: (a * a).sum(), x, use_reentrant=False).backward()


def dpf_rank(workdir: str, device_type: str = "cuda") -> dict:
    """One rank of the ``dp_train_families`` phase (four ranks sharing
    the card): each model of ``DPF_MODELS`` in turn on its mesh (ranks
    2-3 sit deepseek's (1, 2) out), each after the parent has written its
    twin (``READY``); rank 0 says when the ranks are done with it
    (``DONE``)."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import build_mesh, rank_devices

    rank = dist.get_rank()
    out = {"rank": rank, "models": {}}
    _warm_remat()
    for arch, _, (d, k) in DPF_MODELS:
        mesh = build_mesh(data=d, model=k,
                          devices=rank_devices(device_type)[:d * k])
        if mesh.holds(rank):
            out["models"][arch] = _dpf_rank_model(arch, mesh, workdir)
        free_memory()
        dist.barrier()
        if rank == 0:
            open(os.path.join(workdir, _dpf_tag(arch), "DONE"), "w").close()
    return out


def dpf_k1(dev) -> dict:
    """K1 at the phase's f32 shard shapes, before the ranks run: every
    2-D GEMM of each model's rank-0 shard (seeded N(0, 0.02) weights at
    the shard's (K, N)) at the rank's rows (a (2, 2) rank's 256, a (1, 2)
    rank's 512; a cross layer's K/V and ``vision_proj`` at the memory's
    2 x 1601) against its plain version (``_k1_site_check``), then the
    ``DPF_TIMED`` shapes timed beside the plain version,
    ``torch.matmul`` and the bound (``k1_timing``)."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import (
        map_with_path,
        param_specs,
        shard_shape,
    )
    from repro_torch.models.model import Model

    gen = torch.Generator(device=dev).manual_seed(13)
    checks, timing = {}, {}
    for arch, _, (d, k) in DPF_MODELS:
        cfg = dpf_config(arch)
        model = Model(cfg)
        geom = Mesh(grid=np.arange(d * k).reshape(d, k),
                    axis_names=("data", "model"), devices=(dev,) * (d * k))
        shapes = {}
        map_with_path(lambda ps, t: shapes.__setitem__(ps, tuple(t.shape)),
                      model.param_shapes())
        specs = {}
        map_with_path(lambda ps, sp: specs.__setitem__(ps, sp),
                      param_specs(cfg, model.param_shapes(), geom))
        m, mem_m = TRAIN_B // d * TRAIN_L, TRAIN_B // d * cfg.n_image_tokens
        seen = {}
        for path, full in shapes.items():
            name = path.split("/")[-1]
            if name not in DPF_GEMMS or (name == "embed"
                                         and "lm_head" in shapes):
                continue
            kn = shard_shape(specs[path], full, geom)
            if name == "embed":             # the tied head: embed.T
                kn = kn[::-1]
            rows = mem_m if name in ("vision_proj",) or path.endswith(
                ("cross/wk", "cross/wv")) else m
            seen.setdefault((rows,) + tuple(kn), path)
        for (rows, kk, nn), path in seen.items():
            w = (torch.randn(kk, nn, generator=gen, device=dev) * 0.02)
            err, scale, ratio, rt = _k1_site_check(
                dev, gen, cfg, f"dp_train_families {path}", w,
                torch.float32, rows)
            checks[f"{_dpf_tag(arch)} {path}"] = {
                "m": rows, "k": kk, "n": nn, "route": rt,
                "max_abs_err": err, "max_abs_y": scale,
                "clean_ratio": ratio}
            del w
        for t_arch, group, leaves in DPF_TIMED:
            if t_arch != arch:
                continue
            ws = []
            for leaf in leaves:
                path = next(p for p in shapes if p.startswith("layers/")
                            and p.endswith(leaf))
                kk, nn = shard_shape(specs[path], shapes[path], geom)
                ws.append(torch.randn(kk, nn, generator=gen, device=dev)
                          * 0.02)
            rows = mem_m if group == "cross_kv" else m
            rec = k1_timing(dev, None, rows, arch=arch, per_shape=True,
                            groups={group: ws})["per_shape"][group]
            timing[f"{_dpf_tag(arch)}_{group}"] = rec
            del ws
        free_memory()
    out = {"checks": checks, "timing": timing}
    emit("dp_train_families_k1", **out)
    return out


def dp_train_families_runs(dev) -> dict:
    """The ``dp_train_families`` phase: sharded training of mamba2-1.3b,
    deepseek-v3-671b with its MTP head and llama-3.2-vision-11b at their
    published widths (``DPF_MODELS``), f32, by four gloo ranks sharing
    this card, spawned once (``dpf_rank``).  First K1 at the shard shapes
    (``dpf_k1``).  Then, model by model, the one-process twin in this
    process (``_dpf_twin``) while the ranks wait, its first update
    written for them, freed before they draw (``READY``); the ranks say
    when they are done with it (``DONE``), and a failure on this side
    stops them (``ABORT``).  The gates (``dp_train``'s
    tolerances): every step's loss, MTP loss and ``grad_norm`` within
    1e-5 / 1e-5 / 1e-4 relative of the twin's, the aux loss equal, the
    worst leaf's first update within ``DPF_UPDATE_TOL`` of its norm;
    records equal on
    the ranks of a mesh; every replicated leaf's summed gradient
    bit-equal on them; K1 launches a step equal to the count predicted
    from the layer list; mamba2's fault fired on data rank 1 alone,
    flagged on all four ranks and retried to the clean state.  Ranks
    time-share one card over gloo: no data-parallel speed."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.distributed import spawn

    t0 = time.perf_counter()
    k1 = dpf_k1(dev)
    twins, outs = {}, None
    # the ranks' allocators grow segments in place: four processes
    # sharing the card return freed transients to one another
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    with tempfile.TemporaryDirectory(prefix="dp_train_families_") as wd:
        pool = ThreadPoolExecutor(1)
        t_spawn = time.perf_counter()
        fut = pool.submit(spawn.run, dpf_rank, 4, wd, dev.type,
                          device=dev.type)
        try:
            for arch, _, _ in DPF_MODELS:
                tdir = os.path.join(wd, _dpf_tag(arch))
                t = time.perf_counter()
                twins[arch] = _dpf_twin(dev, arch, tdir)
                twins[arch]["seconds"] = time.perf_counter() - t
                emit_memory(f"dp_train_families twin {_dpf_tag(arch)}")
                open(os.path.join(tdir, "READY"), "w").close()
                _dpf_wait(os.path.join(tdir, "DONE"), fut.done)
                shutil.rmtree(tdir)
            outs = fut.result()
        except BaseException:
            open(os.path.join(wd, "ABORT"), "w").close()
            if fut.done():
                fut.result()          # the ranks' failure, if theirs
            raise
        finally:
            pool.shutdown(wait=True)
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        spawn_s = time.perf_counter() - t_spawn
    res = {"models": {}, "spawn_seconds": spawn_s}
    bad = []                     # every failed gate, read after the line
    for arch, _, shape in DPF_MODELS:
        twin = twins[arch]
        recs = [o["models"][arch] for o in outs if arch in o["models"]]
        need(len(recs) == shape[0] * shape[1],
             f"dp_train_families {arch}: {len(recs)} ranks ran it")
        steps = recs[0]["steps"]
        if not all(r["steps"] == steps for r in recs):
            bad.append(f"{arch}: the ranks' records differ")
        rel = {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                   for a, b in zip(steps, twin["steps"])]
               for k in ("loss", "total_loss", "grad_norm", "aux_loss",
                         "mtp_loss") if k in steps[0]}
        if not (len(steps) == DPF_STEPS[arch]
                and max(rel["loss"]) <= 1e-5
                and max(rel["total_loss"]) <= 1e-5
                and max(rel["grad_norm"]) <= 1e-4
                and max(rel.get("mtp_loss", [0])) <= 1e-5
                and all(a["aux_loss"] == b["aux_loss"]
                        for a, b in zip(steps, twin["steps"]))
                and not any(s["abft_flag"] for s in steps)):
            bad.append(f"{arch} vs the twin: {rel}")
        worst = max(r["update_err"] for r in recs if "update_err" in r)
        if worst[0] > DPF_UPDATE_TOL:
            bad.append(f"{arch}: first update off by {worst}")
        digests = recs[0]["replicated_grads"]
        if not (digests and all(r["replicated_grads"] == digests
                                for r in recs)):
            bad.append(f"{arch}: a replicated leaf's gradient differs "
                       f"between ranks")
        for r in recs:
            k1s = [a["k1"] for a in r["attempts"]]
            if any(n != r["k1_predicted"] for n in k1s):
                bad.append(f"{arch} rank {r['rank']}: K1 {k1s}, predicted "
                           f"{r['k1_predicted']}")
        if arch == DPF_FAULT_ARCH:
            for r in recs:
                flags = [a["flag"] for a in r["attempts"]]
                want = [TRAIN_L + 5] if r["coords"]["data"] == 1 else [None]
                if not (flags == [False, True, False, False]
                        and r["retry_equals_clean"]
                        and r["fault_rows"] == want):
                    bad.append(f"{arch} rank {r['rank']}: flags {flags}, "
                               f"retry_equals_clean "
                               f"{r['retry_equals_clean']}, fault rows "
                               f"{r['fault_rows']} (want {want})")
        clean = [a for a in recs[0]["attempts"] if not a["faulted"]]
        res["models"][arch] = {
            "layers": dpf_config(arch).n_layers, "mesh": list(shape),
            "moments": DPF_MOMENTS.get(arch, "float32"),
            "losses": [s["loss"] for s in steps],
            "mtp_losses": [s["mtp_loss"] for s in steps
                           if "mtp_loss" in s],
            "twin_losses": [s["loss"] for s in twin["steps"]],
            "rel_vs_twin": rel, "update_rel_worst_leaf": worst,
            "update_rel_by_rank": {r["rank"]: r["update_err"] for r in recs
                                   if "update_err" in r},
            "replicated_leaves": len(digests),
            "step_ms_per_rank": {r["rank"]: [a["ms"] for a in r["attempts"]]
                                 for r in recs},
            "twin_step_ms": twin["ms"], "twin_peak_gb": twin["peak_gb"],
            "twin_seconds": twin["seconds"],
            "k1_per_step": clean[-1]["k1"],
            "k1_predicted": recs[0]["k1_predicted"],
            "collectives_per_step": clean[-1]["collectives"],
            "collectives_alone_ms": recs[0]["collective_ms"],
            "draw_s": [r["draw_s"] for r in recs],
            "param_gb_per_rank": [r["param_gb"] for r in recs],
            "moment_gb_per_rank": [r["moment_gb"] for r in recs],
            "peak_gb_per_rank": [r["peak_gb"] for r in recs]}
        if arch == DPF_FAULT_ARCH:
            res["models"][arch]["fault_rows"] = {
                r["rank"]: r["fault_rows"] for r in recs}
    res["seconds"] = time.perf_counter() - t0
    res["note"] = ("four ranks time-sharing one card over gloo: a "
                   "correctness run, not a data-parallel speed")
    emit("dp_train_families", **res)
    need(not bad, f"dp_train_families: {bad}")
    return {**res, "k1": k1}


def _add_dp_train_families(kernels, dpf) -> None:
    """The ``dp_train_families`` phase's numbers on the kernels line: K1
    at its timed f32 shard shapes, the worst error of its checks, and its
    launches a step on each model's ranks."""
    k1 = kernels[0]
    k1["dp_train_families_f32"] = {name: {key: rec[key] for key in (
        "m", "k", "n", "gemms", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for name, rec in dpf["k1"]["timing"].items()}
    k1["dp_train_families_max_abs_err"] = max(
        c["max_abs_err"] for c in dpf["k1"]["checks"].values())
    k1["dp_train_families_launches_per_step"] = {
        arch: rec["k1_per_step"] for arch, rec in dpf["models"].items()}


# ------------------------------------------------------------------ pod

# the pod phase's meshes of four gloo ranks sharing the card: serving at
# (pod, data, model) against DP_SHAPE's (data, model) run of the same
# seed; training at (pod, data, model), ZeRO-1 over data; whisper-tiny's
# 6 q and 6 kv heads trained at (1, POD_PAD_K), padded to POD_PAD_HEADS
# by default, against an explicit padding and the one-process twin
POD_SERVE = (2, 1, 2)
POD_TRAIN = (2, 2, 1)
POD_TRAIN_STEPS = 2
POD_PAD_ARCH, POD_PAD_K, POD_PAD_HEADS = "whisper-tiny", 4, 8
POD_PAD_B, POD_PAD_L = 2, 64


def pod_whisper_batches(cfg) -> list:
    """The padding gate's batches: ``POD_PAD_B`` x ``POD_PAD_L`` tokens
    and labels and 2 x ``enc_seq_len`` mel frames a row (numpy, seed 9)."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(POD_TRAIN_STEPS):
        t = rng.integers(0, cfg.vocab_size, (POD_PAD_B, POD_PAD_L + 1))
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "labels": t[:, 1:].astype(np.int32),
                    "audio": rng.standard_normal(
                        (POD_PAD_B, 2 * cfg.enc_seq_len, cfg.n_mels))
                    .astype(np.float32)})
    return out


def pod_train(cfg, params, batches, dev, mesh=None) -> dict:
    """``len(batches)`` f32 AdamW steps at lr 3e-4 under ``--abft auto``
    at ``mesh`` (None: this process alone): each step's loss, grad norm,
    flag and K1 launches; on a mesh the K1 launches the layer list
    predicts (``_dpf_k1_predicted``), the groups' ranks, the moments'
    shares and the first layer's ``wq`` shard."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.kernels import abft_matmul
    from repro_torch.launch.train import abft_config
    from repro_torch.models.model import Model
    from repro_torch.train import (
        OptConfig,
        TrainConfig,
        init_opt_state,
        make_train_step,
    )

    model = Model(cfg)
    ocfg = OptConfig(lr=3e-4)
    abft = abft_config("auto")
    step = make_train_step(model, abft, TrainConfig(opt=ocfg), mesh=mesh,
                           device=None if mesh is not None else dev)
    pl = step.placement
    if pl is not None:
        params = pl.model.shard_params(params, mesh)
    state = init_opt_state(params, ocfg, pl.shards if pl else None)
    rec = {"loss": [], "grad_norm": [], "flag": [], "k1": []}
    for b in batches:
        b = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
        k1 = abft_matmul.KERNEL.launches
        params, state, met = step(params, state, b)
        rec["k1"].append(abft_matmul.KERNEL.launches - k1)
        rec["loss"].append(float(met["loss"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        rec["flag"].append(bool(met["abft_flag"]))
    if pl is not None:
        rows = batches[0]["tokens"].shape[0] // pl.data
        rec["k1_predicted"] = _dpf_k1_predicted(
            params, abft, rows * batches[0]["tokens"].shape[1],
            rows * cfg.enc_seq_len if cfg.is_encoder_decoder else 0)

        def ranks(g):
            if g is None:
                return []
            return (list(range(dist.get_world_size())) if g.group is None
                    else sorted(dist.get_process_group_ranks(g.group)))

        rec["groups"] = {n: ranks(getattr(pl, n)) for n in ("dp", "bp",
                                                            "pp")}
        full = {}
        map_with_path(lambda ps, t: full.__setitem__(ps, t.numel()),
                      pl.model.param_shapes())
        shares = {}
        map_with_path(lambda ps, t: shares.__setitem__(
            ps, full[ps] // t.numel()), state.mu)
        rec["moment_shares"] = {k: shares[k] for k in (
            "layers/0/mixer/wq", "embed")}
        rec["wq"] = list(params["layers"][0]["mixer"]["wq"].shape)
        rec["heads"] = [pl.model.cfg.eff_heads, pl.model.cfg.eff_kv_heads]
    del params, state
    free_memory()
    return rec


def _k1_call_log(calls: dict, where: list):
    """Wraps the K1 wrapper's launch (``ops.abft_matmul_kernel``) to note
    each distinct call it makes: operand shapes, strides and dtypes, the
    output dtype, mode, blocks and K plan, first seen under ``where[0]``.
    Returns the original, to put back."""
    from repro_torch.kernels import ops

    kern = ops.abft_matmul_kernel

    def logged(x, w, *a, **k):
        sig = (tuple(x.shape), tuple(x.stride()), tuple(w.shape),
               tuple(w.stride()), str(x.dtype)[6:], str(k["out_dtype"])[6:],
               k["mode"], k["bm"], k["bk"], k["bn"], k["one_slice"],
               k["split_rows"])
        calls.setdefault(sig, where[0])
        return kern(x, w, *a, **k)

    ops.abft_matmul_kernel = logged
    return kern


def pod_k1(dev, calls: dict) -> dict:
    """K1 against its plain version at every call the ``pod`` phase's
    ranks made (``_k1_call_log``): operands drawn at the call's shapes,
    strides and dtype (x N(0, 1), w N(0, 0.02), seed 14), the kernel run
    with the call's mode, blocks and K plan; y within 1e-4 (f32) or
    2^-7 (bf16) of max|y|, the bounds within 1e-4 relative, no false
    flag at the residual's threshold (c = 16)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.abft_matmul import abft_matmul_kernel, plan
    from repro_torch.kernels.ref import (
        abft_matmul_batched_ref,
        abft_matmul_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(14)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    checks = []
    for sig, where in calls.items():
        xs, xst, ws, wst, dtype, out, mode, bm, bk, bn, one, rows = sig

        def draw(shape, stride, std):
            t = torch.empty_strided(shape, stride, dtype=dt[dtype],
                                    device=dev)
            t.copy_(torch.randn(shape, generator=gen, device=dev) * std)
            return t

        x, w = draw(xs, xst, 1.0), draw(ws, wst, 0.02)
        kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=dt[out])
        y, res, bnd = abft_matmul_kernel(x, w, **kw, one_slice=one,
                                         split_rows=rows)
        ref = abft_matmul_batched_ref if len(xs) == 3 else abft_matmul_ref
        yp, _, bndp = ref(x, w, **kw)
        scale = yp.float().abs().max().item()
        err = (y.float() - yp.float()).abs().max().item()
        tol = (1e-4 if out == "float32" else 2 ** -7) * scale
        berr = ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max().item()
        tau = ops.ATOL + ops.tolerance_scale(-(-xs[-1] // bk) * bk,
                                             c=16.0) * bnd
        ratio = (res.abs() / tau).max().item()
        rec = {"where": where, "x": list(xs), "w": list(ws), "dtype": dtype,
               "out_dtype": out, "mode": mode, "blocks": [bm, bk, bn],
               "route": plan(x[0] if len(xs) == 3 else x,
                             w[0] if len(ws) == 3 else w, mode=mode, bm=bm,
                             bk=bk, bn=bn, one_slice=one, split_rows=rows,
                             experts=xs[0] if len(xs) == 3 else 1).route,
               "max_abs_err": err, "max_abs_y": scale, "bnd_rel_err": berr,
               "clean_ratio": ratio}
        checks.append(rec)
        need(err <= tol and berr <= 1e-4 and ratio <= 1.0,
             f"pod: K1 at a main-path call against its plain version: {rec}")
        del x, w, y, res, bnd, yp, bndp
    free_memory()
    out = {"calls": len(checks), "checks": checks,
           "max_abs_err": max(c["max_abs_err"] for c in checks),
           "max_rel_err": max(c["max_abs_err"] / c["max_abs_y"]
                              for c in checks)}
    emit("pod_k1", **out)
    return out


def pod_rank(prompts, device_type: str = "cuda") -> dict:
    """One rank of the ``pod`` phase (four ranks on the card): llama3.2-1b
    at full width and ``SERVED_LAYERS`` layers, this rank's shard of seed
    0's bf16 weights, served dense (first logits kept on rank 0) and with
    a decode fault at logical row ``DP_ROW`` at (data, model) =
    ``DP_SHAPE`` and at (pod, data, model) = ``POD_SERVE`` (the fault is
    pod rank 1's row 1 there), each mesh's K1 and K3 a decode step; the
    same llama in f32 trained ``POD_TRAIN_STEPS`` steps at ``POD_TRAIN``;
    whisper-tiny trained at (1, ``POD_PAD_K``) with its heads padded by
    default and with an explicit ``pad_heads_to``.  Every record is
    checked equal over the world.  ``k1_calls``: each distinct K1 call of
    these runs (``_k1_call_log``), for the parent's checks."""
    from repro_torch.core.faults import FaultSpec
    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ModelFault
    from repro_torch.models.model import Model

    devs = rank_devices(device_type)
    meshes = {"dp": build_mesh(data=DP_SHAPE[0], model=DP_SHAPE[1],
                               devices=devs),
              "pod": build_mesh(pod=POD_SERVE[0], data=POD_SERVE[1],
                                model=POD_SERVE[2], devices=devs)}
    mtr = build_mesh(pod=POD_TRAIN[0], data=POD_TRAIN[1],
                     model=POD_TRAIN[2], devices=devs)
    mpad = build_mesh(data=1, model=POD_PAD_K, devices=devs)
    dev = mtr.device
    cfg = served_config()
    model = Model(cfg)
    row = ModelFault.at(0, "mlp_down", FaultSpec.value(DP_ROW, 1, 1e5))
    out = {"rank": mtr.rank, "pod_rank": meshes["pod"].pod_rank,
           "serve": {}, "timing": {}, "logits": {}}
    calls, where = {}, ["serve"]
    kern = _k1_call_log(calls, where)
    try:
        _pod_rank_runs(out, meshes, mtr, mpad, model, cfg, row, prompts,
                       dev, where)
    finally:
        ops.abft_matmul_kernel = kern
    out["k1_calls"] = calls
    free_memory()
    return out


def _pod_rank_runs(out, meshes, mtr, mpad, model, cfg, row, prompts, dev,
                   where) -> None:
    """``pod_rank``'s runs, into ``out``; ``where[0]`` names the run."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives
    from repro_torch.models import layers
    from repro_torch.models.model import Model

    world = collectives.world_group()
    for name, mesh in meshes.items():
        where[0] = f"serve {name}"
        params = model.init_params(0, dtype=torch.bfloat16, device=dev,
                                   mesh=mesh)
        eng, dense, timing, cap = tp_serve(model, params, prompts, dev,
                                           "dense", mesh=mesh, capture=None)
        if mesh.rank == 0:
            out["logits"][name] = {k: v.numpy() for k, v in
                                   cap.first.items()}
        out["timing"][name] = timing
        if name == "pod":
            out["rows"] = list(eng.executor.rows)
            out["batch_group"] = eng.executor.bp.size
        del eng, cap
        fired, row_fault = [], layers._row_fault

        def logged(fault, x, w, ctx, out_dtype):
            got = row_fault(fault, x, w, ctx, out_dtype)
            if fault is not None and fault.row == DP_ROW and ctx.rows:
                fired.append(None if got is None else got.row)
            return got

        layers._row_fault = logged
        try:
            _, fault, _, _ = tp_serve(model, params, prompts, dev, "fault",
                                      mesh=mesh, fault_at=(2, row),
                                      capture=False)
        finally:
            layers._row_fault = row_fault
        recs = {"dense": dense, "fault": fault}
        collectives.check_same(recs, world, f"pod {name}")
        out["serve"][name] = recs
        out[f"fault_rows_{name}"] = sorted(set(fired), key=str)
        del params
        free_memory()
    data = SyntheticLM(DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                                  vocab_size=cfg.vocab_size))
    batches = [data.batch(s) for s in range(POD_TRAIN_STEPS)]
    where[0] = "train"
    out["train"] = pod_train(cfg, model.init_params(
        0, dtype=torch.float32, device=dev), batches, dev, mtr)
    wcfg = get_config(POD_PAD_ARCH)
    wparams = Model(wcfg).init_params(0, dtype=torch.float32, device=dev)
    wb = pod_whisper_batches(wcfg)
    where[0] = "pad"
    out["pad"] = {
        name: pod_train(c, wparams, wb, dev, mpad) for name, c in (
            ("default", wcfg),
            ("explicit", dc.replace(wcfg, pad_heads_to=POD_PAD_HEADS,
                                    pad_kv_heads_to=POD_PAD_HEADS)))}
    del wparams
    collectives.check_same({k: v for k, v in out["train"].items()
                            if k != "groups"}, world, "train")
    collectives.check_same(out["pad"], world, "pad")


def pod_runs(dev) -> dict:
    """The ``pod`` phase: the reference's multi-pod layout (the batch over
    ``pod`` x ``data``; FSDP, ZeRO-1 and sequence shards over ``data``
    alone) over four gloo ranks sharing this card (``pod_rank``), and the
    default head padding.  In this process: the prompts, the f32 llama
    twin and the whisper twin (one process each), freed.  The gates:
    records equal on the four ranks; at ``POD_SERVE`` the dense and the
    faulted streams, errors and counters and the first logits bit-equal
    to the ``DP_SHAPE`` run of the same seed (a rank computes the same
    thing: its two slots, its model shard); the fault fired on pod rank
    1 alone, at its row 1, and was recovered (its streams the dense
    run's); K1 and K3 a decode step the layer list's 7 L + 1 and L; the
    training losses within 1e-5 and grad norms within 1e-4 relative of
    the twin's, K1 a step the predicted count on every rank, the data
    group the rank's pod's data line, the batch group the grid, the pod
    group its pod line, each moment of ``wq`` half its leaf (ZeRO-1 over
    ``data``); whisper padded to 8 / 8 by default, its losses and grad
    norms bit-equal to the explicit padding's and within 1e-5 / 1e-4 of
    the twin's, K1 a step the predicted count; K1 at every distinct call the ranks made, in serving,
    training and the padded whisper, against its plain version
    (``pod_k1``).  Ranks time-share one card over gloo: no speed."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import spawn
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = served_config()
    params, prompts = engine_inputs(dev, cfg=cfg)
    del params
    free_memory()
    data = SyntheticLM(DataConfig(global_batch=TRAIN_B, seq_len=TRAIN_L,
                                  vocab_size=cfg.vocab_size))
    twin = pod_train(cfg, Model(cfg).init_params(
        0, dtype=torch.float32, device=dev),
        [data.batch(s) for s in range(POD_TRAIN_STEPS)], dev)
    wcfg = get_config(POD_PAD_ARCH)
    wtwin = pod_train(wcfg, Model(wcfg).init_params(
        0, dtype=torch.float32, device=dev), pod_whisper_batches(wcfg), dev)
    t_spawn = time.perf_counter()
    outs = spawn.run(pod_rank, 4, prompts, dev.type, device=dev.type)
    spawn_s = time.perf_counter() - t_spawn
    calls = {}
    for o in outs:
        for sig, where in o.pop("k1_calls").items():
            calls.setdefault(sig, where)
    k1 = pod_k1(dev, calls)
    L = cfg.n_layers
    r0 = outs[0]
    dp, pod = r0["serve"]["dp"], r0["serve"]["pod"]
    need(dp == pod, "pod: the (2, 1, 2) records differ from (2, 2)'s")
    need(all(np.array_equal(r0["logits"]["dp"][k], r0["logits"]["pod"][k])
             for k in r0["logits"]["dp"]),
         "pod: the (2, 1, 2) first logits differ from (2, 2)'s")
    st = pod["fault"]["stats"]
    need(st["faults_detected"] >= 1 and st["hard_faults"] == 0
         and pod["fault"]["streams"] == pod["dense"]["streams"],
         f"pod: the decode fault was not recovered: {st}")
    for o in outs:
        want = [1] if o["pod_rank"] == 1 else [None]
        need(o["fault_rows_pod"] == want,
             f"pod rank {o['rank']}: the row fault landed at "
             f"{o['fault_rows_pod']}, not {want}")
        t = o["timing"]["pod"]
        need(t["k1_per_step"] == [7 * L + 1] and t["k3_per_step"] == [L],
             f"pod rank {o['rank']}: K1/K3 a decode step {t['k1_per_step']}"
             f"/{t['k3_per_step']}, the layer list predicts "
             f"{7 * L + 1}/{L}")
        need(o["rows"] == [2 * o["pod_rank"], 2] and o["batch_group"] == 2,
             f"pod rank {o['rank']}: rows {o['rows']}")
        tr = o["train"]
        p, d = divmod(o["rank"], POD_TRAIN[1])
        need(tr["groups"] == {"dp": [2 * p, 2 * p + 1], "bp": [0, 1, 2, 3],
                              "pp": [d, 2 + d]}
             and tr["moment_shares"]["layers/0/mixer/wq"] == 2
             and all(k == tr["k1_predicted"] for k in tr["k1"]),
             f"pod rank {o['rank']}: training groups {tr['groups']}, "
             f"moment shares {tr['moment_shares']}, K1 {tr['k1']} against "
             f"{tr['k1_predicted']}")
        pd, pe = o["pad"]["default"], o["pad"]["explicit"]
        need(pd["loss"] == pe["loss"] and pd["grad_norm"] == pe["grad_norm"]
             and pd["heads"] == [POD_PAD_HEADS] * 2
             and pd["wq"][1] == POD_PAD_HEADS * wcfg.resolved_head_dim
             // POD_PAD_K
             and all(k == pd["k1_predicted"] for k in pd["k1"]),
             f"pod rank {o['rank']}: default padding {pd['loss']} "
             f"{pd['heads']} {pd['wq']} K1 {pd['k1']} (predicted "
             f"{pd['k1_predicted']}) against explicit {pe['loss']}")

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    tr, pd = r0["train"], r0["pad"]["default"]
    gates = {"train_loss_rel": rel(tr["loss"], twin["loss"]),
             "train_grad_norm_rel": rel(tr["grad_norm"], twin["grad_norm"]),
             "pad_loss_rel": rel(pd["loss"], wtwin["loss"]),
             "pad_grad_norm_rel": rel(pd["grad_norm"], wtwin["grad_norm"])}
    need(max(gates["train_loss_rel"]) <= 1e-5
         and max(gates["train_grad_norm_rel"]) <= 1e-4
         and max(gates["pad_loss_rel"]) <= 1e-5
         and max(gates["pad_grad_norm_rel"]) <= 1e-4
         and not any(tr["flag"] + pd["flag"]),
         f"pod: training against the twins: {gates}")
    res = {"serve_mesh": list(POD_SERVE), "train_mesh": list(POD_TRAIN),
           "pad_mesh": [1, POD_PAD_K],
           "config": {"arch": ENGINE_ARCH, "layers": L,
                      "pad_arch": POD_PAD_ARCH},
           "serve_equals_dp": True, "first_logits_bit_equal": True,
           "fault": {"stats": {k: st[k] for k in ("faults_detected",
                                                  "retries", "hard_faults")},
                     "rows": {o["rank"]: o["fault_rows_pod"] for o in outs}},
           "k1_per_decode_step": r0["timing"]["pod"]["k1_per_step"],
           "k3_per_decode_step": r0["timing"]["pod"]["k3_per_step"],
           "collectives_per_decode_step":
               r0["timing"]["pod"]["collectives_per_step"],
           "decode_step_ms_median": float(np.median(
               r0["timing"]["pod"]["step_ms"])),
           "train": {"losses": tr["loss"], "twin": twin["loss"],
                     "k1_per_step": tr["k1"],
                     "k1_predicted": tr["k1_predicted"],
                     "groups": {o["rank"]: o["train"]["groups"]
                                for o in outs}},
           "pad": {"losses": pd["loss"], "twin": wtwin["loss"],
                   "heads": pd["heads"], "wq_shard": pd["wq"],
                   "k1_per_step": pd["k1"],
                   "k1_predicted": pd["k1_predicted"]},
           "k1_checks": {"calls": k1["calls"],
                         "max_abs_err": k1["max_abs_err"],
                         "max_rel_err": k1["max_rel_err"]},
           **gates, "spawn_seconds": spawn_s,
           "seconds": time.perf_counter() - t0,
           "note": "four ranks time-sharing one card over gloo: a "
                   "correctness run, not a data-parallel speed"}
    emit("pod", **res)
    return res


def _add_pod(kernels, pod) -> None:
    """The ``pod`` phase's launches on the kernels line: K1 and K3 a
    decode step at (pod, data, model), K1 a train step at ``POD_TRAIN``
    and of the padded whisper; K1's checks at the ranks' calls."""
    kernels[0]["pod_launches_per_step"] = {
        "decode": pod["k1_per_decode_step"],
        "train": pod["train"]["k1_per_step"],
        "pad_train": pod["pad"]["k1_per_step"]}
    kernels[0]["pod_checks"] = pod["k1_checks"]
    kernels[2]["pod_launches_per_step"] = {
        "decode": pod["k3_per_decode_step"]}


# the roofline phase's shapes: a decode step of 4 slots at this cursor in
# a cache this deep, and one prompt of this many tokens
ROOF_SLOTS, ROOF_DEPTH, ROOF_POS, ROOF_PROMPT = 4, 1024, 600, 512


def roofline_walk(model, abft, dev, params) -> dict:
    """The roofline phase's two steps of ``model`` on ``dev`` (the card
    or the meta device), each run once under ``analysis.analyze_step``:
    a decode step of ``ROOF_SLOTS`` slots and a prefill of one
    ``ROOF_PROMPT``-token prompt.  Returns {step: (record, ops, fn,
    args, argument bytes counted here)}."""
    from repro_torch.models.layers import LayerCtx
    from repro_torch.roofline.analysis import analyze_step

    ctx = LayerCtx(abft=abft)
    dtype = torch.bfloat16
    steps = {
        "decode": (lambda p, t, c, pos: model.decode(p, t, c, pos, ctx), (
            params,
            torch.zeros((ROOF_SLOTS, 1), dtype=torch.int32, device=dev),
            model.init_cache(ROOF_SLOTS, ROOF_DEPTH, dtype=dtype,
                             device=dev),
            torch.full((ROOF_SLOTS,), ROOF_POS, dtype=torch.int32,
                       device=dev))),
        "prefill": (lambda p, t, c: model.prefill(p, t, c, ctx), (
            params,
            torch.zeros((1, ROOF_PROMPT), dtype=torch.int32, device=dev),
            model.init_cache(1, ROOF_PROMPT, dtype=dtype, device=dev))),
    }
    out = {}
    for name, (fn, args) in steps.items():
        from repro_torch.roofline.op_cost import _tensors

        counted = sum(t.numel() * t.element_size() for t in _tensors(args))
        with torch.no_grad():
            rec, ops = analyze_step(fn, args, entry=name)
        out[name] = (rec, ops, fn, args, counted)
    return out


def roofline_runs(dev) -> dict:
    """The ``roofline`` phase: llama3.2-1b at full width and
    ``SERVED_LAYERS`` layers, bf16, flash attention on (K3 in decode),
    the default policy on the H100 (K1 where it picks a block scheme).
    Walks each step on the card and on the meta device and gates: the
    two walks' records equal op for op (kind, geometry, FLOPs, bytes);
    the card walk's K1 and K3 records equal those kernels' launches in
    it; the argument bytes equal the card tensors' bytes.  Then times
    each step with CUDA events against its bound (the largest of the
    three predicted terms), sets ``max_memory_allocated`` beside the
    walk's predicted peak, ranks the decode step's byte contributors
    (``roofline.profile``) and runs the dry run's llama3.2-1b
    decode_32k cell at (16, 16) on the meta device."""
    from repro_torch.core.protected import ABFTConfig
    from repro_torch.kernels import abft_matmul, flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.roofline import profile

    t0 = time.perf_counter()
    K1, K2, K3 = (abft_matmul.KERNEL, flash_attention.FULL_KERNEL,
                  flash_attention.KERNEL)
    model = Model(served_config())
    abft = ABFTConfig(flash_attention=True)
    params = model.init_params(0, dtype=torch.bfloat16, device=dev)
    # warm the card's paths (kernels, cuBLAS) before the walked run
    roofline_walk(model, abft, dev, params)
    torch.cuda.synchronize()
    l0 = (K1.launches, K2.launches, K3.launches)
    card = roofline_walk(model, abft, dev, params)
    torch.cuda.synchronize()
    launches = dict(zip(("K1", "K2", "K3"), (
        K1.launches - l0[0], K2.launches - l0[1], K3.launches - l0[2])))
    meta = roofline_walk(model, abft, torch.device("meta"),
                         model.param_shapes(torch.bfloat16))
    steps = {}
    for name in ("decode", "prefill"):
        rec, ops, fn, args, counted = card[name]
        mrec, mops, _, _, _ = meta[name]
        sig = [(o.kind, tuple(o.geometry), o.flops, o.bytes) for o in ops]
        msig = [(o.kind, tuple(o.geometry), o.flops, o.bytes) for o in mops]
        first = next((i for i, (a, b) in enumerate(zip(sig, msig))
                      if a != b), None)
        need(sig == msig, f"roofline {name}: the card's walk ({len(sig)} "
             f"ops) and the meta walk ({len(msig)}) differ first at "
             f"{first}: {sig[first] if first is not None else None} vs "
             f"{msig[first] if first is not None else None}")
        mem = rec["memory"]
        need(mem["argument_size_in_bytes"] == counted
             == mrec["memory"]["argument_size_in_bytes"],
             f"roofline {name}: argument bytes {mem} against the card "
             f"tensors' {counted} and the meta walk's "
             f"{mrec['memory']['argument_size_in_bytes']}")
        with torch.no_grad():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - resident
            ms = timed(lambda: fn(*args), iters=10, warmup=2)
        bound_ms = rec["t_bound_s"] * 1e3
        steps[name] = {
            "ops": len(ops),
            "records": {k: sum(o.kind == k for o in ops)
                        for k in ("K1", "K2", "K3")},
            "flops": rec["flops_per_device"],
            "bytes": rec["bytes_per_device"],
            "compute_ms": rec["compute_s"] * 1e3,
            "memory_ms": rec["memory_s"] * 1e3,
            "collective_ms": rec["collective_s"] * 1e3,
            "bottleneck": rec["bottleneck"], "bound_ms": bound_ms,
            "ms": ms, "measured_over_bound": ms / bound_ms,
            "argument_bytes": mem["argument_size_in_bytes"],
            "predicted_peak_bytes": mem["temp_size_in_bytes"]
            + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"],
            "max_memory_allocated_over_resident": peak,
        }
    records = {k: steps["decode"]["records"][k]
               + steps["prefill"]["records"][k] for k in ("K1", "K2", "K3")}
    need(records == launches, f"roofline: kernel records {records} against "
         f"launches {launches}")
    need(launches["K1"] > 0 and launches["K3"] > 0,
         f"roofline: K1 and K3 must launch: {launches}")
    top = profile.format_rows(profile.top_contributors(
        card["decode"][1], 10), 10)
    for line in top:
        print(line)
    with tempfile.TemporaryDirectory() as out:
        cell = dryrun.run_cell("llama3.2-1b", "decode_32k", "single",
                               pathlib.Path(out), force=True)
    need(cell["status"] == "ok", f"dry-run cell: {cell}")
    cell = {k: v for k, v in cell.items() if k != "traceback"}
    emit("roofline_cell", **cell)
    del card, meta, params
    free_memory()
    out = {"steps": steps, "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit("roofline", **out)
    return out


def _add_roofline(kernels, rl) -> None:
    """The ``roofline`` phase's launches on the kernels line: K1's and
    K3's in its walked decode step and prefill."""
    kernels[0]["roofline_launches"] = rl["launches"]["K1"]
    kernels[1]["roofline_launches"] = rl["launches"]["K2"]
    kernels[2]["roofline_launches"] = rl["launches"]["K3"]


def cfg_weights_gb(cfg, k: int = 1) -> float:
    """The bf16 weights of one rank's shard of ``cfg`` at TP=k (the whole
    model at k = 1): ``Model.param_shapes`` cut by ``param_specs``."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.sharding import (
        map_with_path,
        param_specs,
        shard_shape,
    )
    from repro_torch.models.model import Model

    shapes = Model(cfg).param_shapes()
    mesh = Mesh(grid=np.arange(k).reshape(1, k), axis_names=("data", "model"),
                devices=(torch.device("cpu"),) * k)
    specs, leaves = [], []
    map_with_path(lambda _, sp: specs.append(sp),
                  param_specs(cfg, shapes, mesh))
    map_with_path(lambda _, t: leaves.append(t), shapes)
    return sum(int(np.prod(shard_shape(sp, t.shape, mesh)))
               * t.element_size() for sp, t in zip(specs, leaves)) / 1e9


def _count_flips(a, b) -> dict:
    """Two engine runs' routing logs entry by entry while their calls
    agree in shape: the entries and tokens routed to another expert set."""
    entries = tokens = compared = 0
    for (ia, _), (ib, _) in zip(a, b):
        if ia.shape != ib.shape:
            break
        compared += 1
        differ = (ia != ib).any(-1)
        entries += int(differ.any())
        tokens += int(differ.sum())
    return {"entries_compared": compared, "entries_apart": entries,
            "tokens_apart": tokens}


def _add_tp_mla(kernels, res) -> None:
    """The ``tp_mla`` phase's numbers on the kernels line: K1 at
    deepseek's TP=2 shard shapes (2-D and batched over 128 experts), and
    K1/K3 launches a decode step a rank (K2 and K3: 0 on MLA)."""
    k1, k2, k3 = kernels
    k1["tp2_deepseek_m4"] = {name: {key: rec[key] for key in (
        "k", "n", "out", "gemms", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "max_abs_err")}
        for name, rec in res["k1"]["shapes"].items()}
    k1["tp2_deepseek_batched"] = res["k1"]["batched"]["timing"]
    k1["tp_mla_launches_per_step"] = res["k1_per_step"]
    k1["tp_mla_batched_launches_per_step"] = res["k1_batched_per_step"]
    k2["tp_mla_launches"] = 0
    k3["tp_mla_launches_per_step"] = res["k3_per_step"]


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
            **{f"{SIDE_ARCH} ({SPEC_SIDE_LAYERS} layers) {k}": v[key]
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
    if "tp_mla" in phases and "mla" not in phases:
        fail("the tp_mla phase needs the mla phase (its TP=1 side)")
    global AUDITS
    AUDITS = [] if "audit" in phases else None
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
    # the libraries' workspaces (cuBLAS, cuBLASLt) allocated first, in small
    # segments: carved later out of a freed multi-GB transient (the plain
    # versions' f32 weights) they would pin it for the rest of the run
    for dt in (torch.bfloat16, torch.float32):
        a = torch.ones(8, 8, dtype=dt, device=dev)
        torch.matmul(a, a)
        torch.bmm(a[None], a[None])
    torch.cuda.synchronize()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    emit("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    walker_s = audit_walker_init() if AUDITS is not None else 0.0
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
    if "mla" in phases:
        eng_out = fwd = train_params = camp = tr = fam = None
        free_memory()
        mla = mla_runs(dev)
        mla_side, mla_prompts = mla.pop("tp1"), mla.pop("prompts")
        if kernels is not None:
            _add_mla(kernels, mla)
    if "ssm" in phases:
        eng_out = fwd = train_params = camp = tr = fam = moe = mla = None
        free_memory()
        ssm = ssm_runs(dev)
        if kernels is not None:
            _add_ssm(kernels, ssm)
    if "cross" in phases:
        eng_out = fwd = train_params = camp = tr = fam = moe = mla = None
        ssm = None
        free_memory()
        cross = cross_runs(dev)
        if kernels is not None:
            _add_cross(kernels, cross)
    if "audit" in phases:
        # the full-width audits ran inside the phases that build each model
        cross = None
        free_memory()
        expected = {arch for phase, archs in (
            ("engine", (ENGINE_ARCH,)), ("family", FAMILY_ARCHS),
            ("moe", (MOE_ARCH,)), ("mla", (MLA_ARCH,)), ("ssm", SSM_ARCHS),
            ("cross", CROSS_ARCHS)) if phase in phases for arch in archs}
        audit = audit_summary(audit_scaled(dev), expected, walker_s)
        if kernels is not None:
            _add_audit(kernels, audit)
    tp1 = None
    if "tp" in phases:
        audit = None
        free_memory()
        tp = tp_runs(dev)
        tp1 = tp.pop("tp1")
        if kernels is not None:
            _add_tp(kernels, tp)
    if "tp_hybrid" in phases:
        tp = None
        free_memory()
        hy = tp_hybrid_runs(dev)
        if kernels is not None:
            _add_tp_hybrid(kernels, hy)
    if "tp_mla" in phases:
        tp = hy = None
        free_memory()
        tm = tp_mla_runs(dev, mla_side, mla_prompts)
        mla_side = None
        if kernels is not None:
            _add_tp_mla(kernels, tm)
    if "dp" in phases:
        tp = hy = tm = None
        free_memory()
        dp = dp_runs(dev, tp1)
        tp1 = None
        if kernels is not None:
            _add_dp(kernels, dp)
    if "dp_train" in phases:
        dp = None
        free_memory()
        dpt = dp_train_runs(dev)
        if kernels is not None:
            _add_dp_train(kernels, dpt)
    if "dp_train_families" in phases:
        dp = dpt = None
        free_memory()
        dpf = dp_train_families_runs(dev)
        if kernels is not None:
            _add_dp_train_families(kernels, dpf)
    if "pod" in phases:
        dpf = None
        free_memory()
        pod = pod_runs(dev)
        if kernels is not None:
            _add_pod(kernels, pod)
    if "roofline" in phases:
        dpf = pod = None
        free_memory()
        rl = roofline_runs(dev)
        if kernels is not None:
            _add_roofline(kernels, rl)
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
