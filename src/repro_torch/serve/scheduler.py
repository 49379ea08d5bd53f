"""Scheduler layer of the serving engine (port of
``repro.serve.scheduler``).

Host-side request/slot/block bookkeeping: the ``Request`` and
``ChunkCursor`` lifecycle records, ``EngineStats`` (with the
fault-campaign outcome counters and the injection log), the slot table
with per-slot position cursors, admission screening (budget/length
checks, paged block allocation, prefix matching and COW planning,
bounded head-of-line lookahead), the chunked-prefill cursor queue
(``park_prefill`` / ``plan_chunks``) and the paged decode growth guard,
which claims the next block and COWs a shared one.  All of it is mutated
strictly outside the attempt/retry window.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.paged_cache import BlockPool, PrefixIndex, blocks_for


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


@dataclasses.dataclass
class ChunkCursor:
    """Resumable prefill state of an admitted request under the chunked
    scheduler: ``prompt[:filled]`` is resident in the cache (a shared
    prefix included), the rest is prefilled in token-budgeted chunks."""

    req: Request
    total: int                    # len(prompt)
    filled: int                   # logical tokens already resident
    prefix: int                   # shared-prefix tokens (stats accounting)


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
    # prefix sharing
    prompt_tokens_total: int = 0
    prefix_tokens_shared: int = 0
    cow_copies: int = 0
    # chunked prefill
    prefill_chunks: int = 0    # prompt chunks executed (one per row a step)
    chunk_retries: int = 0     # clean re-executions of a faulted chunk only
    chunk_budget_retunes: int = 0  # auto-budget changes as occupancy drifts
    # speculative decoding is not ported: always 0, kept so the exported
    # telemetry has the reference's schema
    draft_proposed: int = 0
    draft_accepted: int = 0
    verify_retries: int = 0
    mixed_steps: int = 0
    decode_only_steps: int = 0
    prefill_only_steps: int = 0
    # per-step intensity-guided selection trace: {"step", "decode",
    # "prefill", "intensity", "scheme"}, bounded by stride decimation
    selection_trace: list = dataclasses.field(default_factory=list)
    selection_count: int = 0
    selection_stride: int = 1
    scheme_flips: int = 0
    # fault-campaign classification (shadow-stream harness): every
    # injected fault — campaign or hand-armed — is classified by outcome;
    # faults_injected = corrected + uncorrected + sdc + masked once the
    # step resolves.  sdc: undetected AND the clean shadow run disagrees.
    faults_injected: int = 0
    faults_corrected: int = 0      # detected, retry re-executed clean
    faults_uncorrected: int = 0    # detected, persisted through retries
    sdc_faults: int = 0            # undetected, outputs provably corrupt
    masked_faults: int = 0         # undetected, outputs provably clean
    # adaptive protection (ErrorAdaptivePolicy) level changes
    protection_escalations: int = 0
    protection_deescalations: int = 0
    # ground truth on injection placement: one entry per injected fault,
    # {"engine_step", "phase", "source", "kind", "layer", "site", "row",
    #  "col", "bit", "outcome", ...}, bounded like the selection trace
    injection_log: list = dataclasses.field(default_factory=list)
    injections_dropped: int = 0    # log entries lost to the bound
    # per-step pool occupancy (one observation per executed decode step
    # of a paged engine): exact mean, bounded median sample, peaks
    blocks_used_sum: int = 0
    blocks_used_count: int = 0
    blocks_used_samples: list = dataclasses.field(default_factory=list)
    blocks_used_stride: int = 1
    blocks_used_peak: int = 0
    blocks_shared_peak: int = 0

    MAX_TRACE = 4096

    def observe_blocks_used(self, used: int) -> None:
        self.blocks_used_sum += used
        self.blocks_used_count += 1
        self.blocks_used_peak = max(self.blocks_used_peak, used)
        if self.blocks_used_count % self.blocks_used_stride == 0:
            self.blocks_used_samples.append(used)
            if len(self.blocks_used_samples) > self.MAX_TRACE:
                # keep the odd indices: entry k stays observation
                # (k + 1) * stride after any number of halvings
                self.blocks_used_samples = self.blocks_used_samples[1::2]
                self.blocks_used_stride *= 2

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

    _OUTCOME_COUNTER = {
        "corrected": "faults_corrected",
        "uncorrected": "faults_uncorrected",
        "sdc": "sdc_faults",
        "masked": "masked_faults",
    }

    def record_injection(self, entry: dict) -> None:
        """Classify one injected fault (see ``injection_log``)."""
        self.faults_injected += 1
        attr = self._OUTCOME_COUNTER.get(entry.get("outcome"))
        if attr is not None:
            setattr(self, attr, getattr(self, attr) + 1)
        if len(self.injection_log) < self.MAX_TRACE:
            self.injection_log.append(entry)
        else:
            self.injections_dropped += 1

    @property
    def blocks_used_mean(self) -> float:
        return self.blocks_used_sum / max(self.blocks_used_count, 1)

    @property
    def blocks_used_median(self) -> float:
        """Steady-state resident blocks (robust to the cold-start wave,
        whose requests cannot share yet)."""
        s = sorted(self.blocks_used_samples)
        n = len(s)
        if not n:
            return 0.0
        return (s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2)

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_tokens_shared / max(self.prompt_tokens_total, 1)


def _pad_len(n: int) -> int:
    """Bucket prefill lengths to multiples of 8 (the reference's jit
    buckets; kept so padded shapes match it)."""
    return max(8, -(-n // 8) * 8)


def _pad_rows(n: int, cap: int) -> int:
    """Bucket a chunk batch's row count to the next power of two, capped
    at the slot count (the reference's jit buckets; kept so padded
    shapes match it)."""
    r = 1
    while r < n:
        r *= 2
    return min(r, cap)


@dataclasses.dataclass
class AdmissionBatch:
    """One admission screening pass: the requests that prefill this round
    with their slots, prefix plans and COW payload moves, plus everything
    consumed from the pending queue."""

    admitted: list
    slot_list: list
    prefix_plans: list
    cow_pairs: list
    consumed: list


class Scheduler:
    """Host-side slot/block/request bookkeeping.  ``tracer`` receives the
    ``reject``/``evict`` instants; the engine rebinds it when telemetry
    is attached."""

    def __init__(self, *, slots: int, max_len: int, admit_lookahead: int,
                 stats: EngineStats, tracer,
                 pool: BlockPool | None = None,
                 index: PrefixIndex | None = None):
        self.slots = slots
        self.max_len = max_len
        self.admit_lookahead = int(admit_lookahead)
        self.stats = stats
        self.tracer = tracer
        self.pool = pool
        self.index = index
        self.pos = np.zeros((slots,), np.int32)      # per-slot write cursor
        self.active: dict = {}                        # slot -> Request
        self.prefill_cursors: dict = {}      # slot -> ChunkCursor (FIFO)
        self.done_events: list = []
        self.hol_uid: int | None = None
        self.hol_bypassed = 0

    def free_slots(self) -> list:
        return [s for s in range(self.slots)
                if s not in self.active and s not in self.prefill_cursors]

    def release(self, slot: int) -> None:
        """Drop a slot's cache references; blocks whose last reference
        dropped return to the free list and leave the prefix index."""
        if self.pool is not None:
            freed = self.pool.free_slot(slot)
            if self.index is not None and freed:
                self.index.purge(freed)
        self.pos[slot] = 0

    def finish(self, req: Request, error: str | None = None, *,
               reject: bool = False, evict: bool = False) -> None:
        if error is not None:
            req.error = error
        req.done = True
        if reject:
            self.stats.rejections += 1
            self.tracer.instant("reject", {"uid": req.uid, "error": error})
        if evict:
            self.stats.evictions += 1
            self.tracer.instant("evict", {"uid": req.uid, "error": error})
        self.done_events.append(req)

    def drain_finished(self) -> list:
        done, self.done_events = self.done_events, []
        return done

    def select_admission(self, pending: list) -> AdmissionBatch:
        """One screening pass over ``pending`` (consumed requests are
        removed in place): budget checks, paged block claims (a request
        that can never fit is rejected, one under transient pressure is
        deferred), prefix matching and COW planning, bounded head-of-line
        lookahead past a deferred head."""
        free = self.free_slots()
        batch = AdmissionBatch([], [], [], [], [])
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
            plan = None
            if self.pool is not None:
                need = blocks_for(len(req.prompt), self.pool.block_size)
                if need > self.pool.num_blocks or \
                        need > self.pool.table_width:
                    self.finish(req, "oom:block_pool", reject=True)
                    consumed.append(req)
                    consumed_idx.append(i)
                    continue
                if self.index is not None:
                    plan = self.index.match(req.prompt)
                    if not plan.shared_ids:
                        plan = None
                # a shared full block costs no free-list draw; the COW
                # copy of a partial tail does (need counts its index)
                fresh = need - (plan.full_blocks if plan else 0)
                if fresh > self.pool.blocks_free:
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
                if plan is not None:
                    ok = self.pool.try_admit_prefix(
                        slot, len(req.prompt), plan.shared_ids)
                else:
                    ok = self.pool.try_alloc(slot, len(req.prompt))
                assert ok, "alloc failed after fresh <= blocks_free check"
                if plan is not None and plan.partial:
                    # the suffix writes into the shared partial tail:
                    # copy it on write now, before any attempt
                    pair = self.pool.try_cow(
                        slot, len(plan.shared_ids) - 1)
                    assert pair is not None, "partial tail was unshared"
                    batch.cow_pairs.append(pair)
            admitted.append(req)
            slot_list.append(slot)
            batch.prefix_plans.append(plan)
            consumed.append(req)
            consumed_idx.append(i)
        for i in reversed(consumed_idx):
            pending.pop(i)
        if self.hol_uid is not None and any(
                r.uid == self.hol_uid for r in consumed):
            self.hol_uid, self.hol_bypassed = None, 0
        return batch

    def park_prefill(self, batch: AdmissionBatch) -> None:
        """Chunked admission: the allocated requests become chunk cursors
        (no model call), each starting past its shared prefix."""
        for slot, req, plan in zip(batch.slot_list, batch.admitted,
                                   batch.prefix_plans):
            start = plan.match_len if plan is not None else 0
            self.prefill_cursors[slot] = ChunkCursor(
                req=req, total=len(req.prompt), filled=start, prefix=start)
            self.pos[slot] = start

    def plan_chunks(self, budget: int) -> list:
        """This step's prefill chunks: cursors in admission (FIFO) order,
        each taking ``min(budget left, tokens left)``.  Returns [(slot,
        cursor, take, final)]."""
        rows = []
        for slot, cur in self.prefill_cursors.items():
            if budget <= 0:
                break
            take = min(budget, cur.total - cur.filled)
            rows.append((slot, cur, take, cur.filled + take == cur.total))
            budget -= take
        return rows

    def grow_for_decode(self) -> list:
        """Paged decode guard: a decode step is a verify window of zero
        drafts (``grow_for_verify``)."""
        return self.grow_for_verify({})

    def grow_for_verify(self, window: dict) -> list:
        """Paged guard of a step that writes ``window[slot] + 1`` rows from
        each cursor (``window[slot]``: the slot's draft count, 0 when
        absent — a plain decode step).  Claims blocks through the window's
        last write and copies on write every shared block the window
        touches, BEFORE the step (tables stay frozen across the
        attempt/retry window); a slot that cannot grow is evicted with an
        error.  Returns the COW (src, dst) pairs whose payload the engine
        copies on the device."""
        cow_pairs: list = []
        if self.pool is None:
            return cow_pairs
        bs = self.pool.block_size
        for s in sorted(self.active):
            k_s = int(window.get(s, 0))
            first = int(self.pos[s]) // bs
            last = min((int(self.pos[s]) + k_s) // bs,
                       self.pool.slot_blocks(s) - 1)
            evicted = False
            for idx in range(first, last + 1):
                if self.pool.refcount[self.pool.tables[s, idx]] > 1:
                    if self.pool.blocks_free == 0:
                        req = self.active.pop(s)
                        self.finish(req, "oom:kv_blocks", evict=True)
                        self.release(s)
                        evicted = True
                        break
                    cow_pairs.append(self.pool.try_cow(s, idx))
            if evicted:
                continue
            if not self.pool.try_grow(s, int(self.pos[s]) + k_s + 1):
                req = self.active.pop(s)
                self.finish(req, "oom:kv_blocks", evict=True)
                self.release(s)
        return cow_pairs
