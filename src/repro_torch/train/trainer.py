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

The loop runs on one device; the failure and straggler paths are driven
through the ``simulate`` hooks.  The flag is read on the host once per
attempt.
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
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    retry_on_abft_flag: bool = True
    max_retries: int = 2


class Trainer:
    def __init__(self, model: Model, params, tcfg: TrainConfig,
                 dcfg: DataConfig, rcfg: TrainerConfig,
                 abft: ABFTConfig = ABFTConfig(), hints=None,
                 workers=None, spares=None, device=None):
        if hints is not None:
            raise NotImplementedError("sharding hints are not ported")
        self.device = resolve_device(device)
        strict_f32(self.device)
        self.model = model
        self.params = tree_to(params, self.device)
        self.tcfg = tcfg
        self.rcfg = rcfg
        self.data = SyntheticLM(dcfg)
        self.opt_state = init_opt_state(self.params, tcfg.opt)
        self.step_fn = make_train_step(model, abft, tcfg, device=self.device)
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
        restored, step = self.ckpt.restore(state)
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
                    self.step, {"params": self.params, "opt": self.opt_state})
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
