"""Training CLI (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cuda \
      --arch llama3.2-1b --scale full --steps 20 --batch 4 --seq 128 \
      --abft auto|global|block_1s|off [--ckpt-dir DIR] [--resume]

``--arch`` takes every registered config; mamba2-1.3b and jamba-v0.1-52b
train through the Mamba2 mixer's full-sequence forward.  whisper-tiny and
llama-3.2-vision-11b exit with a message naming their memory inputs: the
synthetic data gives tokens and labels only, as the reference's pipeline
does (train them through ``make_train_step`` with the memory in the
batch).  Runs on the CUDA device unless ``--device cpu`` is given, with
TF32 off (``executor.strict_f32``).  Params are f32
(the reference trains in f32 too), random from ``--seed``.  Every
block-protected forward GEMM runs the fused ABFT kernel on the card; there
is no switch that routes it elsewhere.  Full-sequence attention is the
plain chunked path: the flash kernel has no backward.

``--distributed`` (in place of the reference's
``jax.distributed.initialize()``): each process joins the process group
from its launcher's environment, as ``torchrun`` sets it (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and the world trains
data-parallel over ``build_mesh(data=world)``: each rank draws its shard
of the same seeded params (``init_params(mesh=)``), takes its rows of
the same global batch and keeps its ZeRO-1 share of the optimizer state
(``Trainer(mesh=)``); rank 0 prints the record.  Every token-only
family trains so (deepseek-v3-671b with its MTP head, mamba2-1.3b,
jamba-v0.1-52b among them); whisper-tiny and llama-3.2-vision-11b exit
as above.  The reference's flags
name no model axis, so none is added.  Rank r runs on
``cuda:{r % cards}`` (or the CPU under ``--device cpu``), over NCCL where
every rank has a card of its own and gloo otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import Scheme
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.counting import count_params
from repro_torch.models.model import Model
from repro_torch.serve.executor import resolve_device, strict_f32
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def scale_config(cfg, scale: str):
    if scale == "full":
        return cfg
    if scale == "smoke":
        return scaled_down(cfg)
    if scale == "100m":
        # ~100M-param member of the same family
        return scaled_down(
            cfg, d_model=768, n_layers=12, n_heads=12,
            n_kv_heads=min(cfg.n_kv_heads, 12) if cfg.n_kv_heads else 0,
            head_dim=64, d_ff=2048, vocab_size=32768)
    raise ValueError(scale)


def abft_config(mode: str) -> ABFTConfig:
    """Mode string -> ABFT config through the ProtectionPolicy API."""
    if mode == "off":
        return ABFTConfig(enabled=False)
    if mode == "auto":
        return ABFTConfig.from_policy(IntensityGuidedPolicy())
    return ABFTConfig.from_policy(FixedPolicy(Scheme(mode)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="llama3.2-1b")
    ap.add_argument("--scale", choices=["full", "smoke", "100m"],
                    default="smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default when available) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--abft", default="auto",
                    choices=["auto", "global", "block_1s", "off"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)

    mesh = join_world(args.device) if args.distributed else None
    cfg = scale_config(get_config(args.arch), args.scale)
    try:
        model = Model(cfg)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")
    if model.memory_inputs:
        raise SystemExit(
            f"error: {cfg.name} reads a per-request memory "
            f"({' or '.join(model.memory_inputs)}) beside its tokens; the "
            f"training data gives only tokens and labels, as the "
            f"reference's does")
    device = mesh.device if mesh is not None else resolve_device(
        args.device)
    strict_f32(device)
    params = model.init_params(args.seed, dtype=torch.float32, device=device,
                               mesh=mesh)
    n_params = count_params(cfg)
    lead = mesh is None or mesh.rank == 0
    if lead:
        print(f"arch={cfg.name} scale={args.scale} "
              f"params~{n_params/1e6:.1f}M abft={args.abft} device={device}"
              + (f" mesh={mesh.shape}" if mesh is not None else ""))

    tcfg = TrainConfig(opt=OptConfig(lr=args.lr),
                       microbatches=args.microbatches)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size)
    rcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    try:
        trainer = Trainer(model, params, tcfg, dcfg, rcfg,
                          abft=abft_config(args.abft), device=device,
                          mesh=mesh)
    except NotImplementedError as e:
        raise SystemExit(f"error: {e}")
    if args.resume:
        trainer.maybe_restore()

    t0 = time.perf_counter()
    hist = trainer.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = len(hist) * args.batch * args.seq
    if lead:
        print(json.dumps({
            "device": str(device),
            "first_loss": hist[0]["loss"] if hist else None,
            "last_loss": hist[-1]["loss"] if hist else None,
            "losses": [h["loss"] for h in hist],
            "steps": len(hist),
            "tokens_per_s": toks / dt,
            "events": trainer.events,
            "world": 1 if mesh is None else int(mesh.grid.size),
        }, default=str))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def join_world(device=None):
    """Join the process group from the launcher's environment
    (``LAUNCH_ENV``) and return the ``(data=world, model=1)`` mesh.
    Raises ``SystemExit`` naming what is missing."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import build_mesh, rank_devices
    from repro_torch.distributed.spawn import pick_backend

    missing = [k for k in LAUNCH_ENV if not os.environ.get(k)]
    if missing:
        raise SystemExit(
            f"error: --distributed joins the process group from the "
            f"launcher's environment, as torchrun sets it; "
            f"{', '.join(missing)} not set")
    world = int(os.environ["WORLD_SIZE"])
    kind = resolve_device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ["RANK"])
                              % torch.cuda.device_count())
    dist.init_process_group(pick_backend(world, kind), init_method="env://")
    return build_mesh(data=world, model=1, devices=rank_devices(kind))


if __name__ == "__main__":
    raise SystemExit(main())
