"""Scheduler layer of the serving engine (port of ``repro.serve.scheduler``
without prefix plans or chunk cursors).

Host-side request/slot/block bookkeeping: ``Request`` lifecycle,
``EngineStats``, the slot table with per-slot position cursors,
admission screening (budget/length checks, paged block allocation,
bounded head-of-line lookahead) and the paged decode growth guard.  All
of it is mutated strictly outside the attempt/retry window.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.paged_cache import BlockPool, blocks_for


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (L,) int32
    max_new_tokens: int           # generated-token budget, including the
                                  # prefill-sampled first token
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str | None = None
    times: list = dataclasses.field(default_factory=list, repr=False)


# errors set before a request ever reaches prefill (admission screening)
PRE_PREFILL_ERRORS = ("prompt_too_long", "oom:block_pool")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """ABFT detect->recompute policy."""

    max_retries: int = 1
    evict_on_hard_fault: bool = True


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    faults_detected: int = 0
    retries: int = 0
    hard_faults: int = 0
    evictions: int = 0         # resident requests that lost their slot
    rejections: int = 0        # screened out before prefill
    prompt_tokens_total: int = 0
    mixed_steps: int = 0
    decode_only_steps: int = 0
    prefill_only_steps: int = 0
    # per-step intensity-guided selection trace: {"step", "decode",
    # "prefill", "intensity", "scheme"}, bounded by stride decimation
    selection_trace: list = dataclasses.field(default_factory=list)
    selection_count: int = 0
    selection_stride: int = 1
    scheme_flips: int = 0
    blocks_used_sum: int = 0
    blocks_used_count: int = 0
    blocks_used_peak: int = 0

    MAX_TRACE = 4096

    def observe_blocks_used(self, used: int) -> None:
        self.blocks_used_sum += used
        self.blocks_used_count += 1
        self.blocks_used_peak = max(self.blocks_used_peak, used)

    def observe_selection(self, decode: int, prefill: int,
                          intensity: float, scheme: str) -> None:
        """Record one step's (composition, intensity, scheme) decision."""
        if decode and prefill:
            self.mixed_steps += 1
        elif prefill:
            self.prefill_only_steps += 1
        else:
            self.decode_only_steps += 1
        self.selection_count += 1
        if self.selection_count % self.selection_stride == 0:
            self.selection_trace.append({
                "step": self.steps, "decode": decode, "prefill": prefill,
                "intensity": intensity, "scheme": scheme,
            })
            if len(self.selection_trace) > self.MAX_TRACE:
                # keep the odd indices: entry k stays observation
                # (k + 1) * stride after any number of halvings
                self.selection_trace = self.selection_trace[1::2]
                self.selection_stride *= 2


def _pad_len(n: int) -> int:
    """Bucket prefill lengths to multiples of 8 (the reference's jit
    buckets; kept so padded shapes match it)."""
    return max(8, -(-n // 8) * 8)


@dataclasses.dataclass
class AdmissionBatch:
    admitted: list
    slot_list: list
    consumed: list


class Scheduler:
    """Host-side slot/block/request bookkeeping."""

    def __init__(self, *, slots: int, max_len: int, admit_lookahead: int,
                 stats: EngineStats, pool: BlockPool | None = None):
        self.slots = slots
        self.max_len = max_len
        self.admit_lookahead = int(admit_lookahead)
        self.stats = stats
        self.pool = pool
        self.pos = np.zeros((slots,), np.int32)      # per-slot write cursor
        self.active: dict = {}                        # slot -> Request
        self.done_events: list = []
        self.hol_uid: int | None = None
        self.hol_bypassed = 0

    def free_slots(self) -> list:
        return [s for s in range(self.slots) if s not in self.active]

    def release(self, slot: int) -> None:
        if self.pool is not None:
            self.pool.free_slot(slot)
        self.pos[slot] = 0

    def finish(self, req: Request, error: str | None = None, *,
               reject: bool = False, evict: bool = False) -> None:
        if error is not None:
            req.error = error
        req.done = True
        if reject:
            self.stats.rejections += 1
        if evict:
            self.stats.evictions += 1
        self.done_events.append(req)

    def drain_finished(self) -> list:
        done, self.done_events = self.done_events, []
        return done

    def select_admission(self, pending: list) -> AdmissionBatch:
        """One screening pass over ``pending`` (consumed requests are
        removed in place): budget checks, paged block claims (a request
        that can never fit is rejected, one under transient pressure is
        deferred), bounded head-of-line lookahead past a deferred head."""
        free = self.free_slots()
        batch = AdmissionBatch([], [], [])
        if not pending or not free:
            return batch
        admitted, slot_list = batch.admitted, batch.slot_list
        consumed, consumed_idx = batch.consumed, []
        head_deferred = False
        scanned_past_head = 0
        for i, req in enumerate(pending):
            if len(slot_list) >= len(free):
                break
            if head_deferred:
                if scanned_past_head >= self.admit_lookahead:
                    break
                scanned_past_head += 1
            if req.max_new_tokens <= 0:
                self.finish(req)
                consumed.append(req)
                consumed_idx.append(i)
                continue
            if len(req.prompt) + max(req.max_new_tokens - 1, 0) > \
                    self.max_len:
                self.finish(req, "prompt_too_long", reject=True)
                consumed.append(req)
                consumed_idx.append(i)
                continue
            slot = free[len(slot_list)]
            if self.pool is not None:
                need = blocks_for(len(req.prompt), self.pool.block_size)
                if need > self.pool.num_blocks or \
                        need > self.pool.table_width:
                    self.finish(req, "oom:block_pool", reject=True)
                    consumed.append(req)
                    consumed_idx.append(i)
                    continue
                if need > self.pool.blocks_free:
                    if not head_deferred:
                        head_deferred = True
                        if self.hol_uid != req.uid:
                            self.hol_uid = req.uid
                            self.hol_bypassed = 0
                    continue
                if head_deferred:
                    if self.hol_bypassed >= self.admit_lookahead:
                        break
                    self.hol_bypassed += 1
                ok = self.pool.try_alloc(slot, len(req.prompt))
                assert ok, "alloc failed after need <= blocks_free check"
            admitted.append(req)
            slot_list.append(slot)
            consumed.append(req)
            consumed_idx.append(i)
        for i in reversed(consumed_idx):
            pending.pop(i)
        if self.hol_uid is not None and any(
                r.uid == self.hol_uid for r in consumed):
            self.hol_uid, self.hol_bypassed = None, 0
        return batch

    def grow_for_decode(self) -> None:
        """Paged guard: claim the block each cursor is about to enter
        BEFORE the step (tables stay frozen across the attempt/retry
        window); a slot that cannot grow is evicted with an error.  (No
        copy-on-write: without prefix sharing every block has one owner.)"""
        if self.pool is None:
            return
        for s in sorted(self.active):
            if not self.pool.try_grow(s, int(self.pos[s]) + 1):
                req = self.active.pop(s)
                self.finish(req, "oom:kv_blocks", evict=True)
                self.release(s)
