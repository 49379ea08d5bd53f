"""Serving engine: continuous-batched greedy decode with ABFT
detect->recompute recovery (port of ``repro.serve.engine``, the dense and
paged cache paths).

``ServeEngine`` orchestrates three layers: the host ``Scheduler``
(requests, slots, block tables), the ``LocalExecutor`` (params and cache
on the device) and the ``ModelRunner`` (eager prefill/decode).

``admit(pending)`` prefills up to ``len(free_slots())`` requests in one
model call straight into their cache rows; ``step()`` decodes one token
for every active slot; ``run(requests, fault_at=, admit_fault_at=)``
drives both to completion.  Every executed step records the plan's
``for_step`` selection in ``stats.selection_trace``.

Recovery: a raised ABFT flag re-executes the step up to
``RecoveryPolicy.max_retries`` times; if the flag persists the affected
requests are evicted (or ``RuntimeError`` under
``evict_on_hard_fault=False``).  The reference retries from its
immutable pre-step cache; the port writes the KV cache in place, and a
retry is sound only because it rewrites exactly the (slot, position)
cells — or (block, offset) cells under unchanged tables — that its
attempt wrote, before any of them is read.  Block tables change only
outside the attempt/retry window.

Options of the reference that this slice does not port raise
``NotImplementedError``: sampling (``temperature > 0``), chunked
prefill, prefix sharing, speculative decoding, sharding (``mesh``),
telemetry, fault campaigns (``fault_model``) and adaptive policies.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.policy import FixedPolicy, IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model
from repro_torch.serve.executor import LocalExecutor, resolve_device
from repro_torch.serve.paged_cache import BlockPool, pytree_bytes
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (
    PRE_PREFILL_ERRORS,
    EngineStats,
    RecoveryPolicy,
    Request,
    Scheduler,
    _pad_len,
)

__all__ = ["ServeEngine", "Request", "RecoveryPolicy", "EngineStats",
           "PRE_PREFILL_ERRORS"]


def _unported(**opts) -> None:
    on = [k for k, v in opts.items() if v]
    if on:
        raise NotImplementedError(
            f"ServeEngine options not ported yet: {', '.join(on)}")


class ServeEngine:
    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 abft: ABFTConfig = ABFTConfig(), dtype=torch.bfloat16,
                 device=None, policy: RecoveryPolicy = RecoveryPolicy(),
                 cache_kind: str = "dense", block_size: int = 16,
                 num_blocks: int | None = None, admit_lookahead: int = 8,
                 temperature: float = 0.0, chunk_tokens=None,
                 prefix_sharing: bool = False, spec_decode=None,
                 mesh=None, telemetry=None, fault_model=None):
        _unported(temperature=temperature > 0.0, chunk_tokens=chunk_tokens,
                  prefix_sharing=prefix_sharing, spec_decode=spec_decode,
                  mesh=mesh, telemetry=telemetry, fault_model=fault_model)
        pol = abft.effective_policy()
        if not isinstance(pol, (FixedPolicy, IntensityGuidedPolicy)):
            raise NotImplementedError(
                f"policy {type(pol).__name__} is not ported yet")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the ABFT thresholds assume f32 accumulation
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.abft = abft
        self.policy = policy
        self.cache_kind = cache_kind
        self.executor = LocalExecutor(model, params, dtype=dtype,
                                      device=self.device)
        self.ctx = LayerCtx(abft=abft)
        self.plan = self.executor.protection_plan(abft, slots=slots)
        self._last_scheme: str | None = None
        if cache_kind == "paged":
            width = -(-max_len // block_size)
            if num_blocks is None:
                num_blocks = slots * width
            pool: BlockPool | None = BlockPool(num_blocks, block_size,
                                               slots, width)
            self.executor.init_paged_cache(num_blocks, block_size)
        elif cache_kind == "dense":
            pool = None
            self.executor.init_dense_cache(slots, max_len)
        else:
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        self.scheduler = Scheduler(slots=slots, max_len=max_len,
                                   admit_lookahead=admit_lookahead,
                                   stats=EngineStats(), pool=pool)
        self.runner = ModelRunner(model, self.ctx)

    # ------------------------------------------------ state facade
    @property
    def params(self):
        return self.executor.params

    @property
    def cache(self):
        return self.executor.cache

    @property
    def stats(self) -> EngineStats:
        return self.scheduler.stats

    @property
    def pos(self):
        return self.scheduler.pos

    @property
    def active(self) -> dict:
        return self.scheduler.active

    @property
    def pool(self):
        return self.scheduler.pool

    def free_slots(self) -> list:
        return self.scheduler.free_slots()

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tables(self, rows=None):
        if self.pool is None:
            return None
        return self.pool.device_tables(rows, device=self.device)

    def _finish_evicted(self, slot_req, error: str) -> None:
        for slot, req in slot_req:
            self.scheduler.finish(req, error, evict=True)
            self.scheduler.release(int(slot))

    # ------------------------------------------------ admission
    def admit(self, pending: list, fault: ModelFault | None = None,
              fault_uid: int | None = None) -> list:
        """Batched admission: consumes requests from ``pending`` in place
        and returns them; each ends up active, done, or rejected/evicted
        with ``error`` set.  ``fault`` is injected only if the request
        ``fault_uid`` reaches prefill."""
        batch = self.scheduler.select_admission(pending)
        admitted, slot_list = batch.admitted, batch.slot_list
        if not admitted:
            return batch.consumed
        if fault is not None and fault_uid is not None and not any(
                r.uid == fault_uid for r in admitted):
            fault = None
        slot_ids = np.asarray(slot_list, np.int32)
        lengths = np.asarray([len(r.prompt) for r in admitted], np.int32)
        Lpad = min(_pad_len(int(lengths.max())), self.max_len)
        toks = np.zeros((len(admitted), Lpad), np.int64)
        for i, r in enumerate(admitted):
            toks[i, :lengths[i]] = r.prompt
        args = (self.params, self._dev(toks), self.cache,
                self._dev(slot_ids), self._dev(lengths),
                self._tables(slot_ids))

        first, flag = self.runner.prefill(*args, fault)
        if bool(flag):
            self.stats.faults_detected += 1
            for _ in range(self.policy.max_retries):
                self.stats.retries += 1
                # the clean retry rewrites every cache cell the faulted
                # attempt wrote (same rows, positions [0, Lpad))
                first, flag = self.runner.prefill(*args, None)
                if not bool(flag):
                    break
            if bool(flag):
                self.stats.hard_faults += 1
                self._finish_evicted(zip(slot_ids, admitted),
                                     "hard_fault:prefill")
                return batch.consumed

        self._observe_step_mix(0, int(lengths.sum()))
        first = first.cpu().numpy()
        now = time.perf_counter()
        for i, (slot, req) in enumerate(zip(slot_ids, admitted)):
            req.generated.append(int(first[i]))
            req.times.append(now)
            self.stats.tokens += 1
            self.stats.prompt_tokens_total += int(lengths[i])
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
                self.scheduler.release(int(slot))
                continue
            self.active[int(slot)] = req
            self.pos[int(slot)] = int(lengths[i])
        return batch.consumed

    # ------------------------------------------------ decoding
    def step(self, fault: ModelFault | None = None) -> dict:
        """One decode step for all active slots.  Returns {uid: token}."""
        before = self.stats.steps
        out = self._decode_core(fault)
        if self.stats.steps > before:
            self._observe_step_mix(self._last_decode_tokens, 0)
        return out

    def _observe_step_mix(self, decode_tokens: int,
                          prefill_tokens: int) -> None:
        """Record this step's (composition, intensity, scheme) decision
        from the plan's cached per-step fast path."""
        if decode_tokens + prefill_tokens == 0:
            return
        sel = self.plan.for_step(decode_tokens, prefill_tokens)
        self.stats.observe_selection(decode_tokens, prefill_tokens,
                                     sel.arithmetic_intensity,
                                     sel.scheme_name)
        if self._last_scheme is not None and \
                sel.scheme_name != self._last_scheme:
            self.stats.scheme_flips += 1
        self._last_scheme = sel.scheme_name

    def _decode_core(self, fault: ModelFault | None = None) -> dict:
        self._last_decode_tokens = 0
        self.scheduler.grow_for_decode()
        if not self.active:
            return {}
        toks = np.zeros((self.slots, 1), np.int64)
        mask = np.zeros((self.slots,), bool)
        for s, req in self.active.items():
            toks[s, 0] = req.generated[-1]
            mask[s] = True
        args = (self.params, self._dev(toks), self.cache,
                self._dev(self.pos.copy()), self._dev(mask), self._tables())
        nxt, flag = self.runner.decode(*args, fault)
        self.stats.steps += 1
        if self.pool is not None:
            self.stats.observe_blocks_used(self.pool.blocks_used)
        if bool(flag):
            # detection -> recompute: the retry rewrites the same
            # (slot, pos) cells of every layer before reading them
            self.stats.faults_detected += 1
            for _ in range(self.policy.max_retries):
                self.stats.retries += 1
                nxt, flag = self.runner.decode(*args, None)
                if not bool(flag):
                    break
            if bool(flag):
                self.stats.hard_faults += 1
                if not self.policy.evict_on_hard_fault:
                    raise RuntimeError("persistent fault after retry")
                victims = list(self.active.items())
                self.active.clear()
                self._finish_evicted(victims, "hard_fault:decode")
                return {}
        out = {}
        nxt = nxt.cpu().numpy()
        finished = []
        now = time.perf_counter()
        for s, req in list(self.active.items()):
            t = int(nxt[s])
            req.generated.append(t)
            req.times.append(now)
            self.pos[s] += 1
            out[req.uid] = t
            self.stats.tokens += 1
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
                finished.append(s)
        for s in finished:
            del self.active[s]
            self.scheduler.release(s)
        self._last_decode_tokens = len(out)
        return out

    def run(self, requests: list, fault_at: tuple | None = None,
            admit_fault_at: tuple | None = None) -> dict:
        """Drive admission + decode to completion.  ``fault_at=(step,
        fault)`` arms a decode-step fault from that step index on (it
        fires at the first step that actually decodes);
        ``admit_fault_at=(uid, fault)`` injects into the admission batch
        containing that request."""
        pending = list(requests)
        results = {r.uid: r.generated for r in requests if r.done}
        self.scheduler.drain_finished()
        step_i = 0
        armed = fault_at is not None
        while pending or self.active:
            if pending and self.free_slots():
                if admit_fault_at is not None:
                    uid, afault = admit_fault_at
                    consumed = self.admit(pending, fault=afault,
                                          fault_uid=uid)
                    if any(r.uid == uid
                           and r.error not in PRE_PREFILL_ERRORS
                           and r.max_new_tokens > 0 for r in consumed):
                        admit_fault_at = None
                else:
                    self.admit(pending)
            fault = fault_at[1] if armed and step_i >= fault_at[0] else None
            before = self.stats.steps
            self.step(fault)
            if fault is not None and self.stats.steps > before:
                armed = False
            step_i += 1
            for req in self.scheduler.drain_finished():
                results.setdefault(req.uid, req.generated)
        return results

    def cache_stats(self) -> dict:
        """Cache geometry and occupancy (``utilization`` of paged caches
        is against allocated tokens)."""
        stats = {
            "kind": self.cache_kind,
            "slots": self.slots,
            "max_len": self.max_len,
            "bytes_total": pytree_bytes(self.cache),
            "active_tokens": int(sum(int(self.pos[s]) for s in self.active)),
        }
        if self.pool is not None:
            allocated = self.pool.blocks_used * self.pool.block_size
            stats.update(block_size=self.pool.block_size,
                         blocks_total=self.pool.num_blocks,
                         blocks_used=self.pool.blocks_used,
                         blocks_free=self.pool.blocks_free,
                         tokens_capacity=self.pool.num_blocks
                         * self.pool.block_size,
                         tokens_allocated=allocated)
        else:
            stats["tokens_capacity"] = self.slots * self.max_len
            stats["tokens_allocated"] = stats["tokens_capacity"]
        alloc = stats["tokens_allocated"]
        stats["utilization"] = stats["active_tokens"] / alloc if alloc else 0.0
        stats["fragmentation"] = (max(0.0, 1.0 - stats["utilization"])
                                  if alloc else 0.0)
        return stats
