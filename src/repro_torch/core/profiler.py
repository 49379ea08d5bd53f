"""Empirical pre-deployment profiling (paper §5.3 / §6.1; port of
``repro.core.profiler``).

The paper integrates ABFT-scheme selection into the CUTLASS profiler: all
schemes are *executed* per layer shape and the fastest wins.  This module
is that mode for the port: run each candidate scheme's executor on one GEMM
shape, take the median time, and emit a ``profile_table`` that
``ProfileGuidedPolicy`` serves from.

On the card, ``block_1s`` runs the fused ABFT kernel (K1) and ``global``
runs ``_exec_global`` (a cuBLAS product plus the checksum reductions), each
timed with CUDA events around one call: device time, with the L2 cache
flushed first (the serving engine streams each layer's weights cold) and
the device held busy while the host enqueues the call, so the events
bracket the kernels and not the host's launch overhead.  On the CPU the
same code times the plain versions with ``time.perf_counter``: that tests
the plumbing and ranks nothing about the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.intensity import GemmDims
from repro_torch.core.policy import FixedPolicy
from repro_torch.core.protected import ABFTConfig, protected_matmul
from repro_torch.core.schemes import Scheme

DEFAULT_CANDIDATES = (Scheme.GLOBAL, Scheme.BLOCK_1S)
L2_FLUSH_BYTES = 64 << 20      # more than the H100's 50 MB L2
HOST_LEAD_CYCLES = 4_000_000   # ~2 ms of device spin at H100 clocks


def _time(fn, device: torch.device, warmup: int, iters: int) -> float:
    """Median seconds of ``fn()`` over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    ts = []
    if device.type == "cuda":
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(iters):
            # the device spins while the host enqueues the flush and the
            # call, so the call's kernels run back to back between events
            torch.cuda._sleep(HOST_LEAD_CYCLES)
            flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def profile_layer(dims: GemmDims, candidates=DEFAULT_CANDIDATES,
                  dtype=torch.float32, device=None, seed: int = 0,
                  warmup: int = 2, iters: int = 5) -> dict:
    """Measured seconds per scheme for one GEMM shape.  The operands are
    ``dtype``; the output is f32 where ``dims.out_dtype_bytes`` is 4 (the
    tied head's), else ``dtype``.  Runs on CUDA unless ``device`` says
    otherwise."""
    from repro_torch.serve.executor import resolve_device

    if iters < 5:
        raise ValueError("iters must be >= 5 (a median of at least five)")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((dims.m, dims.k))).to(
        device=dev, dtype=dtype)
    w = torch.from_numpy(rng.standard_normal((dims.k, dims.n))).to(
        device=dev, dtype=dtype)
    out_dtype = torch.float32 if dims.out_dtype_bytes == 4 else dtype
    out = {}
    for sc in candidates:
        cfg = ABFTConfig.from_policy(FixedPolicy(sc))
        out[sc] = _time(lambda c=cfg: protected_matmul(
            x, w, c, out_dtype=out_dtype), dev, warmup, iters)
    return out


def build_profile_table(layer_dims, candidates=DEFAULT_CANDIDATES,
                        times: dict | None = None, **kw) -> dict:
    """profile_table for ``ProfileGuidedPolicy``: {GemmDims: fastest
    Scheme}.  ``times``, when given, receives each shape's measured
    seconds per scheme."""
    table = {}
    for dims in layer_dims:
        t = profile_layer(dims, candidates, **kw)
        if times is not None:
            times[dims] = t
        table[dims] = min(t, key=t.get)
    return table


def build_profile_policy(layer_dims, candidates=DEFAULT_CANDIDATES,
                         fallback=None, **kw):
    """Measure the given shapes and return the ``ProfileGuidedPolicy``
    that serves them from the table, falling back to the analytic
    roofline for unprofiled shapes."""
    from repro_torch.core.policy import (
        IntensityGuidedPolicy,
        ProfileGuidedPolicy,
    )

    table = build_profile_table(layer_dims, candidates, **kw)
    return ProfileGuidedPolicy(
        table=table, fallback=fallback or IntensityGuidedPolicy())
