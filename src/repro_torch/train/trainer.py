"""Trainer: the fault-tolerant training loop (port of
``repro.train.trainer``).

  * ABFT forward protection: a flagged step is re-executed from the same
    params and optimizer state (the update is functional) before the
    optimizer's result is kept;
  * async checkpointing on a cadence, checksummed at rest;
  * heartbeat failure detection, elastic re-mesh and restore;
  * straggler bookkeeping with hot spares;
  * deterministic, restart-safe data (the step index is the only data
    state).

The loop runs on one device, or (``mesh=``) on every rank of a
``(data, model)`` port mesh, each rank holding its shard of the params
and its ZeRO-1 shard of the optimizer state (``train_step``'s
``Placement``): every rank reads the world's flag and so takes the same
retry and hard-fault decision, and every rank saves on the cadence (a
sharded save: each leaf gathered whole, one writer) and restores its
shard at this mesh (``Checkpointer.restore(shardings=)``).  The failure
and straggler paths are driven through the ``simulate`` hooks.  The flag
is read on the host once per attempt.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.core.protected import ABFTConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import Model
from repro_torch.runtime.elastic import ElasticState
from repro_torch.runtime.heartbeat import HeartbeatMonitor, StragglerPolicy
from repro_torch.serve.executor import resolve_device, strict_f32, tree_to
from repro_torch.train.optimizer import AdamWState, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    retry_on_abft_flag: bool = True
    max_retries: int = 2


def state_shardings(model: Model, mesh) -> dict:
    """The ``make_sharding`` tree of a trainer's checkpointed state
    ``{"params", "opt"}`` on ``mesh``: the params and the error-feedback
    residuals by ``param_specs`` (a 0-d residual is whole under any
    spec), the moments by ``opt_state_specs`` (ZeRO-1), the step
    whole."""
    from repro_torch.distributed.sharding import (
        NamedSharding,
        P,
        make_sharding,
        opt_state_specs,
        param_specs,
    )

    shapes = model.param_shapes()
    params = make_sharding(mesh, param_specs(model.cfg, shapes, mesh))
    moments = make_sharding(mesh, opt_state_specs(model.cfg, shapes, mesh))
    return {"params": params,
            "opt": AdamWState(step=NamedSharding(mesh, P()), mu=moments,
                              nu=moments, err=params)}


class Trainer:
    """The loop of the module docstring.  ``mesh`` (a port ``Mesh``):
    train on this process's rank of it, ``params`` the full tree (each
    rank keeps its shard) or the rank's shard already
    (``Model.init_params(mesh=)``); ``hints`` as ``make_train_step``'s;
    ``placement``: the step's ``Placement`` (None unsharded)."""

    def __init__(self, model: Model, params, tcfg: TrainConfig,
                 dcfg: DataConfig, rcfg: TrainerConfig,
                 abft: ABFTConfig = ABFTConfig(), hints=None,
                 workers=None, spares=None, device=None, mesh=None):
        self.step_fn = make_train_step(model, abft, tcfg, hints=hints,
                                       device=device, mesh=mesh)
        pl = self.placement = self.step_fn.placement
        self.mesh = mesh
        self.device = (torch.device(mesh.device) if mesh is not None
                       else resolve_device(device))
        strict_f32(self.device)
        self.model = model
        if pl is not None:
            params = model.shard_params(params, mesh)
        self.params = tree_to(params, self.device)
        self.tcfg = tcfg
        self.rcfg = rcfg
        self.data = SyntheticLM(dcfg)
        self.opt_state = init_opt_state(self.params, tcfg.opt,
                                        pl.shards if pl else None)
        self.shardings = (state_shardings(model, mesh)
                          if pl is not None else None)
        self.ckpt = Checkpointer(rcfg.ckpt_dir)
        self.step = 0
        self.history: list = []
        # control plane (simulated single-host)
        workers = workers or ["w0"]
        self.heartbeat = HeartbeatMonitor(workers, timeout_s=60.0)
        self.stragglers = StragglerPolicy()
        self.elastic = ElasticState(
            model_parallel=1, spares=list(spares or []),
            active=list(workers))
        self.events: list = []

    # ------------------------------------------------------------ restore
    def maybe_restore(self) -> bool:
        """Restore the latest checkpoint.  As in the reference, the state
        saved under step s already holds step s's update, and the loop
        resumes AT s (that step runs again)."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        restored, step = self.ckpt.restore(state, shardings=self.shardings)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = step
        self.events.append(("restored", step))
        return True

    # ------------------------------------------------------------ loop
    def run(self, simulate: dict | None = None) -> list:
        """simulate: {step: callable(trainer)} fault-injection hooks."""
        simulate = simulate or {}
        while self.step < self.rcfg.steps:
            if self.step in simulate:
                simulate[self.step](self)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(self.step).items()}
            t0 = time.monotonic()
            retries = 0
            while True:
                new_params, new_opt, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                flagged = bool(metrics["abft_flag"])
                if (not self.rcfg.retry_on_abft_flag or not flagged
                        or retries >= self.rcfg.max_retries):
                    break
                retries += 1
                self.events.append(("abft_retry", self.step))
            if flagged and retries >= self.rcfg.max_retries:
                self.events.append(("abft_hard_fault", self.step))
            self.params, self.opt_state = new_params, new_opt
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            for w in self.heartbeat.alive:
                self.heartbeat.beat(w)
                self.stragglers.record(w, dt)
            self.history.append({"step": self.step, "loss": loss,
                                 "time_s": dt, "retries": retries})
            if self.step and self.step % self.rcfg.ckpt_every == 0:
                self.ckpt.save_async(
                    self.step, {"params": self.params, "opt": self.opt_state},
                    shardings=self.shardings)
                self.events.append(("checkpoint", self.step))
            self.step += 1
        self.ckpt.wait()
        return self.history

    # ------------------------------------------------- failure simulation
    def on_worker_failure(self, dead: list):
        """Heartbeat-detected failure: re-mesh + restore from checkpoint."""
        plan = self.elastic.on_failure(dead)
        self.events.append(("remesh", tuple(plan.shape)))
        restored = self.maybe_restore()
        if not restored:
            self.events.append(("cold_restart", self.step))
        return plan
