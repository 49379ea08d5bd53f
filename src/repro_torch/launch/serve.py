"""Serving CLI: continuous batching + ABFT recovery stats (port of
``repro.launch.serve`` for the options this slice ports).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --scale full --dtype bfloat16 --flash-attention \
      [--cache paged] [--inject-faults] [--abft auto|global|block_1s|off]

Runs on the CUDA device unless ``--device cpu`` is given.  Block schemes
always run the fused ABFT kernel on the card (its plain version on the
CPU).  Weights are random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import Scheme
from repro_torch.models.layers import ModelFault
from repro_torch.models.model import Model
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.serve.executor import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> int:
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
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--raise-on-hard-fault", action="store_true")
    ap.add_argument("--cache", choices=["dense", "paged"], default="dense")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--admit-lookahead", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = _DTYPES[args.dtype]
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = scaled_down(cfg)
    model = Model(cfg)
    params = model.init_params(args.seed, dtype=dtype, device=device)
    if args.abft == "off":
        abft = ABFTConfig(enabled=False,
                          flash_attention=args.flash_attention)
    else:
        pol = (IntensityGuidedPolicy() if args.abft == "auto"
               else FixedPolicy(Scheme(args.abft)))
        abft = ABFTConfig.from_policy(pol,
                                      flash_attention=args.flash_attention)
    engine = ServeEngine(
        model, params, slots=args.slots, max_len=args.max_len, abft=abft,
        dtype=dtype, device=device, cache_kind=args.cache,
        block_size=args.block_size, num_blocks=args.num_blocks,
        admit_lookahead=args.admit_lookahead,
        policy=RecoveryPolicy(max_retries=args.max_retries,
                              evict_on_hard_fault=not args.raise_on_hard_fault))
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
    schemes = sorted({e["scheme"] for e in engine.stats.selection_trace})
    print(json.dumps({
        "device": str(device),
        "requests": len(results),
        "tokens": engine.stats.tokens,
        "tokens_per_s": engine.stats.tokens / dt,
        "faults_detected": engine.stats.faults_detected,
        "retries": engine.stats.retries,
        "hard_faults": engine.stats.hard_faults,
        "evictions": engine.stats.evictions,
        "rejections": engine.stats.rejections,
        "step_schemes": schemes,
        "errors": {r.uid: r.error for r in reqs if r.error},
        "cache": engine.cache_stats(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
