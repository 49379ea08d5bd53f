"""Elastic scaling: rebuild the mesh from surviving workers and restore
state from the latest checkpoint (copy of ``repro.runtime.elastic``,
which is plain Python).

Failure-recovery flow (the trainer integrates all of it):

  1. HeartbeatMonitor declares worker(s) dead (or StragglerPolicy demotes a
     persistent straggler and promotes a hot spare).
  2. ``plan_remesh`` computes the largest usable (data, model) mesh from
     the surviving device set — model-parallel width is preserved (param
     layout compatibility); the data axis shrinks/grows.
  3. The global batch is re-split over the new data axis
     (``rescale_batch``) so optimization semantics are preserved.
  4. ``Checkpointer.restore(shardings=)`` brings the state back,
     resharded onto the new mesh (each rank keeps its slice of every
     whole leaf).

The device set is simulated; the logic and tests exercise the control
plane.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    devices_used: int
    devices_idle: int

    @property
    def shape(self) -> tuple:
        return (self.data, self.model)


def plan_remesh(n_devices: int, model_parallel: int,
                min_data: int = 1) -> MeshPlan:
    """Largest (data, model) mesh from ``n_devices`` keeping the
    model-parallel width fixed (param shard layout stays valid)."""
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel} — a "
            f"degenerate mesh would invalidate every parameter shard")
    if n_devices < model_parallel * min_data:
        raise RuntimeError(
            f"not enough devices ({n_devices}) for model_parallel="
            f"{model_parallel} (min_data={min_data})")
    data = n_devices // model_parallel
    used = data * model_parallel
    return MeshPlan(
        data=data, model=model_parallel,
        devices_used=used, devices_idle=n_devices - used)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> dict:
    """Keep the global batch constant across re-meshes: per-replica batch
    changes; if new_data does not divide the global batch, pad with repeats
    and mask in the loss (returned as metadata)."""
    per = -(-global_batch // new_data)
    padded = per * new_data
    return {
        "per_replica": per,
        "padded_global": padded,
        "pad": padded - global_batch,
        "grad_scale": global_batch / padded,
    }


@dataclasses.dataclass
class ElasticState:
    """Bookkeeping the trainer keeps about the fleet."""

    model_parallel: int
    spares: list
    active: list

    def on_failure(self, dead: list) -> MeshPlan:
        self.active = [d for d in self.active if d not in set(dead)]
        # promote spares to replace dead workers when available
        while self.spares and len(self.active) % self.model_parallel:
            self.active.append(self.spares.pop())
        while self.spares:
            # absorb remaining spares only in full model-parallel groups
            if len(self.spares) >= self.model_parallel:
                for _ in range(self.model_parallel):
                    self.active.append(self.spares.pop())
            else:
                break
        if len(self.active) < self.model_parallel:
            # even one model-parallel group is unreachable: surface the
            # fleet state instead of planning a degenerate mesh (data=0)
            # the caller would only discover at reshard time
            raise RuntimeError(
                f"cannot re-mesh: {len(self.active)} surviving workers "
                f"(+{len(self.spares)} spares) cannot fill one "
                f"model_parallel={self.model_parallel} group after "
                f"losing {len(dead)} worker(s)")
        return plan_remesh(len(self.active), self.model_parallel)

    def on_straggler(self, worker) -> MeshPlan:
        """Replace a straggler with a spare if possible; otherwise demote
        it out of the mesh entirely."""
        if worker in self.active:
            self.active.remove(worker)
            if self.spares:
                self.active.append(self.spares.pop())
        return plan_remesh(len(self.active), self.model_parallel)
