"""Multi-pod dry run (port of ``repro.launch.dryrun``): build rank 0's
program for every (architecture x input shape) on the production meshes,
walk it on the meta device, and record its cost, collective and memory
analysis per cell.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads the per-device module.  The port builds one rank's
program instead: rank 0 of a virtual ``(data, model)`` mesh
(``launch/mesh.py::make_production_mesh(virtual=True)``: no process
group, every tensor on ``device="meta"``, shapes and no storage), placed
by the port's own code (``Model.shard_params``, the serving
``MeshExecutor``'s layout, ``train_step.Placement``), run once under
``roofline/op_cost.py::CostWalker`` (``roofline.analysis.analyze_step``).
It needs no card and no host memory beyond the walk.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \
      [--jobs 8]

(``--jobs``: cells walked in that many processes at once; a 32k-token
prefill walks its chunked attention op by op, tens of seconds a layer.)

The cells:

- train: ``make_train_step(mesh=)`` on the rank's param and ZeRO-1
  optimizer shards and the global batch (each data rank takes its rows);
- prefill: ``Model.prefill`` without ``lengths`` (no host read), a fresh
  batch of B prompts into a dense cache.  Where the batch divides the
  data axis it runs as a split call (``LayerCtx.rows``: data rank r its
  own B/d rows and cache slots, the logits gathered over ``data``), the
  reference's batch sharding and the split decode's mechanism; else every
  data rank runs the batch (the engine's whole-batch admission);
- decode: the serving ``ModelRunner.decode`` step, one token a slot at
  ``pos = seq - 1`` against a seq-deep dense cache, split over ``data``
  as the executor lays the slots out.

Decode attention runs through K3 (``ABFTConfig(flash_attention=True)``);
prefill attention is the chunked attention the serving prefill runs (the
reference's too), and a train step's the plain attention, as K2 has no
backward.

Each cell writes ``<arch>__<shape>__<mesh>.json`` with the reference's
record keys (``hlo_flops_global`` is the per-device FLOPs times the
ranks; ``lower_s`` is the cell's build, ``compile_s`` its walk) and, in
place of the reference's ``.hlo.txt.gz``, the walk's records as
``.ops.jsonl.gz`` (``roofline/reanalyze.py``, ``roofline/profile.py``).
A layout the port refuses (``serve/executor.py::check_layout``: a pod
axis, an unpadded head split) is ``status: "skipped"`` with reason
``"not ported: <the refusal>"``; any other exception is an ``error``.
The terms are predictions from the H100 SXM data sheet
(``core/hardware.py``), not measurements.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.hardware import NVIDIA_H100_SXM
from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import Scheme
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.counting import count_params, model_flops
from repro_torch.roofline.analysis import analyze_step

# Perf-iteration variants (the reference's): --set key=value tweaks one
# aspect of the cell build; baseline is the empty dict.  The reference's
# ``fsdp`` and ``kv_fallback`` have no counterpart in the port's placement
# (FSDP follows ``sharding.FSDP_THRESHOLD``; a cache whose kv heads the
# axis does not divide is replicated), so they raise.
VARIANT: dict = {}
KNOBS = ("abft", "microbatches", "pad_heads", "pad_kv_heads")

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid archs
# (decode state is O(1) / KV-linear); skip for pure full-attention archs
LONG_OK = {"mamba2-1.3b", "jamba-v0.1-52b"}
META = torch.device("meta")
DTYPE = torch.bfloat16


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_OK:
        return "long_500k skipped: pure full-attention arch (DESIGN.md §4)"
    return None


def check_variant() -> None:
    """Raise ``ValueError`` on a ``--set`` knob the port lacks."""
    bad = sorted(set(VARIANT) - set(KNOBS))
    if bad:
        raise ValueError(f"--set {', '.join(bad)}: not a knob of the port's "
                         f"dry run (it has {', '.join(KNOBS)})")


def dryrun_abft(arch: str, kind: str = "decode") -> ABFTConfig:
    """ABFT policy used inside the dry run's step: intensity-guided
    selection on the H100 (the ProtectionPolicy API), the kernels on
    their meta route (``markers.kernel_scope``), the fused attention
    kernels on (decode through K3; a train step's attention runs plain,
    as K2 has no backward; ``abft=off`` runs no check at all)."""
    mode = VARIANT.get("abft", "auto")
    if mode == "off":
        return ABFTConfig(enabled=False)
    flash = kind != "train"
    if mode == "auto":
        return ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                      flash_attention=flash)
    return ABFTConfig.from_policy(FixedPolicy(Scheme(mode)),
                                  flash_attention=flash)


def _moment_dtype(cfg) -> str:
    return "bfloat16" if count_params(cfg) >= 100e9 else "float32"


def cell_config(arch: str):
    cfg = get_config(arch)
    if "pad_heads" in VARIANT:
        hp = int(VARIANT["pad_heads"])
        kvp = int(VARIANT.get("pad_kv_heads", hp))
        cfg = dataclasses.replace(cfg, pad_heads_to=hp, pad_kv_heads_to=kvp)
    return cfg


def _batch(cfg, b: int, s: int, train: bool) -> dict:
    """A batch of ``b`` rows of ``s`` tokens on the meta device, with the
    model's memory inputs."""
    d = {"tokens": torch.empty((b, s), dtype=torch.long, device=META)}
    if train:
        d["labels"] = torch.empty((b, s), dtype=torch.long, device=META)
    if cfg.is_encoder_decoder:
        d["enc_input"] = torch.empty((b, cfg.enc_seq_len, cfg.d_model),
                                     dtype=DTYPE, device=META)
    if cfg.vision_dim:
        d["images"] = torch.empty((b, cfg.n_image_tokens, cfg.vision_dim),
                                  dtype=DTYPE, device=META)
    return d


def build_cell(arch: str, shape: str, mesh):
    """Returns (fn, args, meta): ``fn(*args)`` is rank 0's step on the
    meta device.  Raises ``NotImplementedError`` where the port refuses
    the layout."""
    from repro_torch.models.layers import LayerCtx
    from repro_torch.models.model import Model
    from repro_torch.serve.executor import MeshExecutor, check_layout

    check_variant()
    cfg = cell_config(arch)
    spec = SHAPES[shape]
    model = Model(cfg)
    check_layout(cfg, mesh)
    abft = dryrun_abft(arch, spec["kind"])
    B, S = spec["batch"], spec["seq"]

    if spec["kind"] == "train":
        from repro_torch.train import (
            OptConfig,
            TrainConfig,
            init_opt_state,
            make_train_step,
        )

        ocfg = OptConfig(moment_dtype=_moment_dtype(cfg))
        tcfg = TrainConfig(opt=ocfg, microbatches=int(
            VARIANT.get("microbatches", 1)))
        step = make_train_step(model, abft, tcfg, mesh=mesh)
        params = model.shard_params(model.param_shapes(DTYPE), mesh)
        shards = step.placement.shards if step.placement else None
        opt = init_opt_state(params, ocfg, shards=shards)
        args = (params, opt, _batch(cfg, B, S, True))
        return step, args, dict(tokens=B * S, training=True)

    ex = MeshExecutor(model, model.param_shapes(DTYPE), mesh=mesh,
                      dtype=DTYPE, device=META)
    ex.layout(B, S, paged=False)
    ex.init_dense_cache(B, S)
    ctx = LayerCtx(abft=abft, hints=ex.hints, tp=ex.tp, dp=ex.dp,
                   cache_split=ex.cache_split)
    n = ex.rows[1] if ex.rows is not None else B

    if spec["kind"] == "prefill":
        from repro_torch.distributed.collectives import gather_first

        if ex.rows is not None:
            ctx = dataclasses.replace(ctx, rows=ex.rows, moe_groups=1)
        batch = _batch(cfg, n, S, False)
        tokens = batch.pop("tokens")

        def prefill(params, tokens, cache, inputs):
            logits, cache, flag = model.prefill(params, tokens, cache, ctx,
                                                inputs=inputs)
            if ex.rows is not None:
                logits = gather_first(logits, ctx.dp)
            return logits, cache, flag

        args = (ex.params, tokens, ex.cache, batch)
        return prefill, args, dict(tokens=B * S, training=False)

    # decode: one new token a slot against a seq-deep cache
    from repro_torch.serve.runner import ModelRunner

    runner = ModelRunner(model, ctx, rows=ex.rows, world=ex.world)
    tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=META)
    mask = torch.ones((B,), dtype=torch.bool, device=META)

    def decode(params, tok, cache, pos):
        return runner.decode(params, tok, cache, pos, mask, None, None)

    args = (ex.params, tok, ex.cache, pos)
    return decode, args, dict(tokens=B, training=False)


def _write_ops(path: pathlib.Path, ops) -> None:
    with gzip.open(path, "wt") as f:
        for op in ops:
            f.write(json.dumps(op.to_json()) + "\n")


def run_cell(arch: str, shape: str, mesh_kind: str, outdir: pathlib.Path,
             force: bool = False) -> dict:
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = ""
    if VARIANT:
        suffix = "__" + "-".join(f"{k}={v}" for k, v in sorted(
            VARIANT.items()))
    path = outdir / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if rec.get("status") != "error":
            print(f"[skip-cached] {path.name}")
            return rec

    reason = skip_reason(arch, shape)
    if reason:
        rec = dict(arch=arch, shape=shape, mesh=mesh_kind, status="skipped",
                   reason=reason)
        path.write_text(json.dumps(rec, indent=2))
        print(f"[skipped] {arch} {shape}: {reason}")
        return rec

    t0 = time.perf_counter()
    rec = dict(arch=arch, shape=shape, mesh=mesh_kind)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "pod"),
                                    virtual=True)
        fn, args, meta = build_cell(arch, shape, mesh)
        t_lower = time.perf_counter() - t0
        analysis, ops = analyze_step(fn, args, NVIDIA_H100_SXM,
                                     entry=shape)
        t_compile = time.perf_counter() - t0 - t_lower
        _write_ops(path.with_name(path.name[:-len(".json")]
                                  + ".ops.jsonl.gz"), ops)
        cfg = cell_config(arch)
        mf = model_flops(cfg, meta["tokens"], meta["training"])
        chips = int(mesh.grid.size)
        hlo_flops_global = analysis["flops_per_device"] * chips
        rec.update(
            status="ok",
            variant=dict(VARIANT),
            chips=chips,
            hardware=NVIDIA_H100_SXM.name,
            lower_s=round(t_lower, 1),
            compile_s=round(t_compile, 1),
            model_flops=mf,
            hlo_flops_global=hlo_flops_global,
            useful_flops_ratio=(
                mf / hlo_flops_global if hlo_flops_global else 0.0),
            **analysis,
        )
        print(f"[ok] {arch} {shape} {mesh_kind}: "
              f"compute={analysis['compute_s']:.4f}s "
              f"memory={analysis['memory_s']:.4f}s "
              f"collective={analysis['collective_s']:.4f}s "
              f"bound={analysis['bottleneck']} "
              f"hbm/dev={analysis['hbm_per_device_gib']:.2f}GiB "
              f"(walk {t_compile:.0f}s)")
    except NotImplementedError as e:
        rec.update(status="skipped", reason=f"not ported: {e}")
        print(f"[skipped] {arch} {shape} {mesh_kind}: {rec['reason']}")
    except Exception as e:  # noqa: BLE001 — record failures per cell
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[error] {arch} {shape} {mesh_kind}: {e}")
    path.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def _pool_cell(cell, outdir: str, force: bool, variant: dict) -> dict:
    """``run_cell`` in a pool's process, under the parent's variant."""
    VARIANT.clear()
    VARIANT.update(variant)
    torch.set_num_threads(1)
    return run_cell(*cell, pathlib.Path(outdir), force=force)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "pod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="perf-variant knob key=value (repeatable)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells walked in this many processes at once")
    args = ap.parse_args(argv)
    for kv in args.set:
        k, _, v = kv.partition("=")
        VARIANT[k] = v
    check_variant()

    outdir = pathlib.Path(args.out)
    meshes = ["single", "pod"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                for mk in meshes:
                    cells.append((arch, shape, mk))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        for mk in meshes:
            cells.append((args.arch, args.shape, mk))

    n_ok = n_err = 0
    if args.jobs > 1:
        import multiprocessing as mp

        # the long prefills first, so the pool ends together
        order = sorted(cells, key=lambda c: SHAPES[c[1]]["kind"]
                       != "prefill")
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.starmap(_pool_cell, [
                (cell, str(outdir), args.force, dict(VARIANT))
                for cell in order], chunksize=1)
    else:
        recs = (run_cell(arch, shape, mk, outdir, force=args.force)
                for arch, shape, mk in cells)
    for rec in recs:
        n_ok += rec.get("status") in ("ok", "skipped")
        n_err += rec.get("status") == "error"
    print(f"done: {n_ok} ok/skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
