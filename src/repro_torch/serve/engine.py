"""Serving engine: continuous-batched decode with ABFT detect->recompute
recovery, fault campaigns and adaptive protection (port of
``repro.serve.engine``, the dense and paged cache paths).

``ServeEngine`` orchestrates three layers: the host ``Scheduler``
(requests, slots, block tables), the ``LocalExecutor`` (params, cache and
the per-slot sampling generators on the device) and the ``ModelRunner``
(eager prefill/decode and the sampler).

``admit(pending)`` prefills up to ``len(free_slots())`` requests in one
model call straight into their cache rows; ``step()`` decodes one token
for every active slot; ``run(requests, fault_at=, admit_fault_at=)``
drives both to completion.  Every executed step records the plan's
``for_step`` selection in ``stats.selection_trace``.

Sampling: greedy argmax by default; ``temperature > 0`` (with ``top_k``)
draws through one ``torch.Generator`` per slot, seeded from ``seed``.
Generator states are saved before an attempt and restored before every
retry and shadow run, and on a hard fault, so a retry redraws the same
token and a slot's draws depend only on its own accepted steps.

Recovery: a raised ABFT flag re-executes the step up to
``RecoveryPolicy.max_retries`` times; if the flag persists the affected
requests are evicted (or ``RuntimeError`` under
``evict_on_hard_fault=False``).  A sticky permanent campaign fault
corrupts the retry like the attempt, which is how a faulty unit becomes a
hard fault.  The reference retries from its immutable pre-step cache; the
port writes the KV cache in place, and a retry is sound only because it
rewrites exactly the (slot, position) cells — or (block, offset) cells
under unchanged tables — that its attempt wrote, before any of them is
read.  Block tables change only outside the attempt/retry window.  A
Mamba2 layer's per-slot state is read by every decode step, so it is not
written in place: the decode attempt returns the next state in tensors of
its own (``Model.decode``), and the engine commits that cache list only
after ``_resolve`` accepts the attempt; a retry, a sticky-fault retry and
a shadow rerun all start from the pre-step state, and a hard-fault
eviction commits nothing.  The commit swaps the list (no copy: the
attempt allocated the new state anyway).  Prefill overwrites its slots'
state without reading it, so it stays in place like the KV cells.

Fault campaigns: a ``fault_model`` (core/faults.FaultModel) is polled once
per ``step()`` when no explicit fault is given.  Every injected fault —
campaign, ``fault_at`` or admission — is recorded in
``stats.injection_log`` with where it landed and how it resolved
(corrected / uncorrected / sdc / masked).  An undetected fault is
classified by a shadow run: the cells the faulted attempt wrote are
gathered, the step re-runs clean (generators restored), tokens and those
cells are compared, and the faulted cells are scattered back so the
faulted result stays committed, as in the reference (which compares whole
pre-/post-step cache trees; nothing else differs).  The cells are the
attention layers' cells and the state rows of the slots the call
replaced (``Cells``).

Adaptive protection: an ``ErrorAdaptivePolicy`` is split into one
immutable (ABFT config, ``LayerCtx``, plan, runner) set per level; each
step first feeds the telemetry's fault-rate snapshot to the policy and
swaps the active set when it changes level.  An adaptive engine gets an
``EngineTelemetry`` (tracing off) implicitly.

Telemetry (``telemetry=EngineTelemetry(...)``, repro_torch/obs): every
``EngineStats`` counter is mirrored after each ``admit()``/``step()``,
per-step deltas feed the fault-rate monitor, and with tracing on the
phases are spans (``admit``, ``prefill``, ``decode_step``,
``abft_check``, ``abft_retry``) fenced with ``torch.cuda.synchronize`` on
the card, plus instants (``fault_detected``, ``hard_fault``,
``scheme_flip``, ``plan_row``, ``protection_escalation``,
``fault_injected``, ``evict``, ``reject``).  Without telemetry the spans
are no-ops.

Prefix sharing (``prefix_sharing=True``, paged only): admission matches
each prompt against a content-hash index of resident blocks
(``PrefixIndex``), aliases the slot's leading table entries onto the
longest cached prefix (full blocks refcounted, a partial tail copied on
write) and prefills only the unshared suffix at its logical positions.
The index registers a prompt only after its prefill read back a clean
flag, and loses an entry when its block is physically freed, so evicting
one sharer never frees or corrupts a block a live request reads.

Chunked prefill (``chunk_tokens=N`` or ``"auto"``): admission only
allocates (slot, blocks, prefix plan, COW) and parks the prompt behind a
``ChunkCursor``; each ``step()`` packs every resident decode token first
and fills the rest of the budget with FIFO prompt chunks, each resuming at
its logical position.  A fault detected in a chunk retries only that
chunk; the step's decode call and earlier chunks never run again.
``"auto"`` takes the budget from the plan's ``tune_chunk_budget`` and
re-tunes it as occupancy drifts.

Greedy streams under sharing and chunking equal the unshared, unchunked
engine's, bit for bit on the card too: the prefill entry points run K1 as
one K slice whatever M (``ABFTConfig.one_slice``) and attention row by
row at fixed chunk shapes (``chunked_attention(spans=...)``), so a
prompt row gets the same KV whether it was prefilled whole, as a suffix
or in chunks.

Speculative decoding (``spec_decode="ngram"|"self_draft"`` or a
proposer object, ``serve/spec_decode.py``): each step proposes up to
``draft_len`` tokens a slot (clamped to the slot's remaining budget),
scores every slot's K+1 window in ONE ``verify`` call through the same
ABFT-checked GEMMs and detect->retry window as decode, and accepts on the
host (greedy: the longest matching draft prefix plus a bonus token;
sampling: the rejection rule, drawn from the slot's generator after the
call is accepted).  ``draft_len="auto"`` (or None) takes K from the plan's
``tune_draft_len`` and re-tunes it as occupancy drifts; a fixed K shrinks
by the adaptive policy's ``shrink_draft`` while escalated.  A detected
fault retries only the window; a sticky one evicts every resident slot
with ``"hard_fault:verify"``.  Greedy streams equal the unsped engine's
token for token, on the card too: ``Model.verify`` computes every row in
the decode step's order.  Speculation needs the plain attention path
(``flash_attention`` off), as in the reference.  On a stack with an MoE
layer the window is the reference's, ``draft_len + 1`` tokens a slot with
token 0 in the padding and in inactive slots, since the call's row count
sets each expert's capacity: a sped stream equals the unsped one where no
expert overflowed.

Stacks with a Mamba2 layer refuse prefix sharing, chunked prefill and
speculative decoding with the reference's ``ValueError``s.

A model that reads a per-request memory beside its tokens (whisper-tiny's
audio, llama-3.2-vision-11b's images: ``Model.memory_inputs``) raises
``NotImplementedError``: the engine passes only tokens, and the
reference's fails on its missing memory.

Sharded serving: ``mesh=k`` (an int: a ``(data=1, model=k)`` mesh) or
a port ``Mesh`` (``build_mesh(data=d, model=k)``) serves over the mesh's
process ranks, each running this engine on its shard
(``executor.MeshExecutor``; ``distributed/spawn.py`` starts the ranks).
Every rank takes the same host decisions: the runner ORs each call's flag
over the world, tokens come from gathered logits through identically
seeded generators, and an undetected injection's ``state_match`` holds
only if it holds on every rank.  Over ``data`` the ranks split the slots
(``executor.layout``): a decode or verify step runs the rank's own slots
and gathers the logits; cache cells (``_cells``: the retry and shadow
runs' cells) are mapped from a logical slot to the rank that holds it;
prefills run whole on every data rank; a COW copy runs on every rank
(paged pools are whole on each).  ``hints`` takes the reference's
``ShardingHints`` (the mesh's by default): its ``dp_size`` sets the MoE
dispatch's group count for a whole-batch call; hints of another type
raise ``NotImplementedError``.  The plan (``plan_row`` telemetry
included) is the per-shard plan of ``model_parallel=k`` at the rows a
rank decodes.  One process is one rank: a mesh wider than 1 in a process
outside ``torch.distributed`` raises ``NotImplementedError`` (the
reference's single-process multi-device mesh has no counterpart).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.policy import ErrorAdaptivePolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.distributed.collectives import or_flag
from repro_torch.models import attention
from repro_torch.models.layers import LayerCtx, ModelFault, ShardingHints
from repro_torch.models.model import Model, cell_leaves, layer_tags
from repro_torch.obs.trace import Tracer
from repro_torch.serve import paged_cache
from repro_torch.serve.executor import (
    LocalExecutor,
    MeshExecutor,
    resolve_device,
    strict_f32,
)
from repro_torch.serve.paged_cache import BlockPool, PrefixIndex, pytree_bytes
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (
    PRE_PREFILL_ERRORS,
    ChunkCursor,
    EngineStats,
    RecoveryPolicy,
    Request,
    Scheduler,
    _pad_len,
    _pad_rows,
)
from repro_torch.serve.spec_decode import (
    greedy_accept,
    make_proposer,
    rejection_sample,
    target_probs,
)

__all__ = ["ServeEngine", "Request", "RecoveryPolicy", "EngineStats",
           "ChunkCursor", "PRE_PREFILL_ERRORS"]

# shared no-op tracer for engines without telemetry
_NULL_TRACER = Tracer(enabled=False)


class Cells(NamedTuple):
    """The cache cells one model call wrote: ``kv`` indexes every
    attention leaf (``leaf[kv]``; None in a stack without attention),
    ``rows`` the slots whose per-slot state the call replaced (None: it
    replaced none)."""

    kv: tuple | None
    rows: torch.Tensor | None = None


class ServeEngine:
    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 abft: ABFTConfig = ABFTConfig(), dtype=torch.bfloat16,
                 hints=None, device=None,
                 policy: RecoveryPolicy = RecoveryPolicy(),
                 cache_kind: str = "dense", block_size: int = 16,
                 num_blocks: int | None = None, admit_lookahead: int = 8,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 telemetry=None, fault_model=None,
                 classify_injections: bool | None = None,
                 chunk_tokens=None, prefix_sharing: bool = False,
                 spec_decode=None, mesh=None,
                 draft_len: int | str | None = None, draft_window: int = 8,
                 draft_units: int = 1):
        if model.memory_inputs:
            raise NotImplementedError(
                f"{model.cfg.name} reads a per-request memory "
                f"({' or '.join(model.memory_inputs)}) beside its tokens; "
                f"the engine passes only tokens, as the reference's does: "
                f"drive it through Model.prefill(..., inputs=...) and "
                f"Model.decode")
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.device = resolve_device(device)
        strict_f32(self.device)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.abft = abft
        self.policy = policy
        self.cache_kind = cache_kind
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # campaign injection: polled once per step(); undetected faults
        # are shadow-classified whenever a fault model is attached
        self.fault_model = fault_model
        self.classify_injections = bool(
            classify_injections if classify_injections is not None
            else fault_model is not None)
        self._injection_meta: dict | None = None
        if hints is not None and not isinstance(hints, ShardingHints):
            raise NotImplementedError(
                f"hints of type {type(hints).__name__}: the port takes the "
                f"reference's ShardingHints (models.layers.ShardingHints)")
        if mesh is not None:
            self.executor = MeshExecutor(model, params, mesh=mesh,
                                         dtype=dtype, device=self.device,
                                         hints=hints)
            self.device = self.executor.device
        else:
            self.executor = LocalExecutor(model, params, dtype=dtype,
                                          device=self.device, hints=hints)
        # how the slots lie over the data ranks (split decode, split cache)
        self.executor.layout(slots, max_len, cache_kind == "paged")
        if spec_decode is not None and self.executor.cache_split is not None \
                and self.executor.cache_split.kind == "seq":
            raise NotImplementedError(
                "spec_decode over a sequence-sharded cache (fewer slots "
                "than data ranks): the verify step's per-query merge is "
                "not ported; serve with slots divisible by the data axis")
        # adaptive protection: one immutable (config, ctx, plan, runner)
        # set per level; the mutable policy never rides in a LayerCtx
        eff = abft.effective_policy()
        self.adaptive = eff if isinstance(eff, ErrorAdaptivePolicy) \
            else None
        if self.adaptive is not None:
            level_cfgs = (
                dataclasses.replace(abft, policy=self.adaptive.base),
                dataclasses.replace(abft, policy=self.adaptive.escalated))
        else:
            level_cfgs = (abft,)
        self._level_ctx = tuple(
            LayerCtx(abft=c, hints=self.executor.hints, tp=self.executor.tp,
                     dp=self.executor.dp,
                     cache_split=self.executor.cache_split)
            for c in level_cfgs)
        self.protection_level = 0
        self.ctx = self._level_ctx[0]
        # the adaptive policy reads the fault-rate monitor, so an adaptive
        # engine gets a (trace-off) telemetry object implicitly
        if telemetry is None and self.adaptive is not None:
            from repro_torch.obs.telemetry import EngineTelemetry

            telemetry = EngineTelemetry()
        self.telemetry = telemetry
        self._tr = telemetry.tracer if telemetry is not None \
            else _NULL_TRACER
        self._last_scheme: str | None = None
        self._level_plans = tuple(
            self.executor.protection_plan(c, slots=slots)
            for c in level_cfgs)
        self.plan = self._level_plans[0]
        # chunked prefill: per-step token budget; "auto" asks the plan for
        # the smallest budget whose mixed step clears the device CMR and
        # re-tunes it as occupancy drifts (_retune_chunk_budget)
        self.chunk_auto = chunk_tokens == "auto"
        if self.chunk_auto:
            chunk_tokens = self.plan.tune_chunk_budget(lo=8, hi=max_len)
        if chunk_tokens is not None:
            if not isinstance(chunk_tokens, int):
                raise ValueError(
                    f"chunk_tokens must be an int or 'auto', got "
                    f"{chunk_tokens!r}")
            if chunk_tokens < 1:
                raise ValueError("chunk_tokens must be >= 1")
            if not model.supports_chunked_prefill:
                raise ValueError(
                    "chunk_tokens requires an attention-only decoder "
                    "(SSM / cross-attention state cannot resume a prompt "
                    "mid-sequence)")
        self.chunk_tokens = chunk_tokens
        # pre-escalation budget, restored on de-escalation (the adaptive
        # policy's shrink_chunk scales it while escalated)
        self._chunk_tokens_base = chunk_tokens \
            if isinstance(chunk_tokens, int) else None
        # admission-campaign fault awaiting its target's first chunk
        self._pending_prefill_fault: tuple | None = None
        if cache_kind == "paged":
            width = -(-max_len // block_size)
            if num_blocks is None:
                num_blocks = slots * width
            pool: BlockPool | None = BlockPool(num_blocks, block_size,
                                               slots, width)
            self.executor.init_paged_cache(num_blocks, block_size, slots)
        elif cache_kind == "dense":
            pool = None
            self.executor.init_dense_cache(slots, max_len)
        else:
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        index = None
        if prefix_sharing:
            if pool is None:
                raise ValueError("prefix_sharing requires cache_kind='paged'")
            if not model.supports_prefix_sharing:
                raise ValueError(
                    "prefix_sharing requires an attention-only decoder "
                    "(no SSM / cross-attention state outside the block "
                    "pool)")
            index = PrefixIndex(block_size)
        self.scheduler = Scheduler(slots=slots, max_len=max_len,
                                   admit_lookahead=admit_lookahead,
                                   stats=EngineStats(), tracer=self._tr,
                                   pool=pool, index=index)
        self._level_runners = tuple(
            ModelRunner(model, ctx, temperature=temperature, top_k=top_k,
                        rows=self.executor.rows, world=self.executor.world)
            for ctx in self._level_ctx)
        self.runner = self._level_runners[0]
        # speculative decoding: drafts run unprotected (a wrong draft costs
        # throughput, never output); the K+1-token verify call is the
        # integrity boundary
        self.spec = None
        self.draft_len = 0
        self.draft_auto = draft_len in (None, "auto")
        self._draft_len_base: int | None = None
        self._last_decode_tokens = 0
        # under MoE the verify window's width sets the experts' capacity:
        # such a stack verifies the reference's draft_len + 1 tokens a slot
        self._moe_window = any(t.split(":")[1] == "moe"
                               for t in layer_tags(model.cfg))
        # the cache list a decode attempt returned, until it is committed
        self._staged = None
        if spec_decode is not None:
            if not model.supports_chunked_prefill:
                raise ValueError(
                    "spec_decode requires an attention-only decoder (SSM "
                    "recurrence cannot roll back to the last accepted "
                    "position)")
            if abft.flash_attention:
                raise ValueError(
                    "spec_decode requires the plain attention path: the "
                    "fused flash_decode kernel cannot reproduce the "
                    "multi-token verify stream bit for bit (the greedy "
                    "byte-equality gate)")
            if self.draft_auto:
                self.draft_len = max(1, self.plan.tune_draft_len(
                    batch=slots))
            else:
                if not isinstance(draft_len, int) or draft_len < 1:
                    raise ValueError(
                        f"draft_len must be a positive int or 'auto', "
                        f"got {draft_len!r}")
                self.draft_len = draft_len
                self._draft_len_base = draft_len
            self.spec = make_proposer(
                spec_decode, model, self._level_ctx[0], lambda: self.params,
                units=draft_units, window=draft_window)
        self.executor.init_generators(seed, slots)
        self._emit_plan_rows()

    # ------------------------------------------------ state facade
    @property
    def params(self):
        return self.executor.params

    @property
    def cache(self):
        return self.executor.cache

    @property
    def generators(self) -> list:
        return self.executor.gens

    @property
    def model_parallel(self) -> int:
        return self.executor.model_parallel

    @property
    def mesh(self):
        """The executor's mesh (None on one device)."""
        return self.executor.mesh

    @property
    def stats(self) -> EngineStats:
        return self.scheduler.stats

    @stats.setter
    def stats(self, value: EngineStats) -> None:
        self.scheduler.stats = value

    @property
    def pos(self):
        return self.scheduler.pos

    @property
    def active(self) -> dict:
        return self.scheduler.active

    @property
    def pool(self):
        return self.scheduler.pool

    @property
    def index(self):
        return self.scheduler.index

    @index.setter
    def index(self, value) -> None:
        self.scheduler.index = value

    @property
    def _prefill_cursors(self) -> dict:
        return self.scheduler.prefill_cursors

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

    # ------------------------------------------------ sampling state
    def _gens_for(self, rows) -> list | None:
        """The generators of ``rows`` (None entries draw nothing); None
        under greedy decoding, which draws nothing at all."""
        if self.temperature <= 0.0:
            return None
        return [self.generators[int(s)] if s is not None else None
                for s in rows]

    @staticmethod
    def _save_gens(gens) -> list | None:
        return None if gens is None else [
            g.get_state() if g is not None else None for g in gens]

    @staticmethod
    def _restore_gens(gens, states) -> None:
        if gens is None:
            return
        for g, st in zip(gens, states):
            if g is not None:
                g.set_state(st)

    # ------------------------------------------------ telemetry
    def attach_telemetry(self, telemetry) -> None:
        """Attach (or replace) an ``EngineTelemetry`` mid-lifecycle; the
        telemetry object must be fresh (counter mirroring is monotonic)."""
        self.telemetry = telemetry
        self._tr = telemetry.tracer if telemetry is not None \
            else _NULL_TRACER
        self.scheduler.tracer = self._tr
        self._emit_plan_rows()

    def _emit_plan_rows(self) -> None:
        """One ``plan_row`` instant per protection-plan entry: which scheme
        each GEMM site runs at the current protection level."""
        if not self._tr.enabled:
            return
        for row in self.plan.report_rows():
            args = {"model_parallel": self.model_parallel,
                    "protection_level": self.protection_level}
            if self.spec is not None:
                args["draft_len"] = self.draft_len
            args.update(row)
            self._tr.instant("plan_row", args)

    def _sync_telemetry(self) -> None:
        """Mirror EngineStats into the registry and feed the fault-rate
        monitor (one observation per admit/step)."""
        if self.telemetry is None:
            return
        self.telemetry.sync(
            self.stats, active_slots=len(self.active),
            prefill_cursors=len(self._prefill_cursors),
            blocks_used=(self.pool.blocks_used
                         if self.pool is not None else None),
            blocks_free=(self.pool.blocks_free
                         if self.pool is not None else None),
            chunk_budget=(self.chunk_tokens
                          if isinstance(self.chunk_tokens, int) else None),
            draft_len=self.draft_len if self.spec is not None else None)

    # ------------------------------------------------ adaptive protection
    def _set_protection_level(self, level: int, evidence: dict) -> None:
        """Swap the active (ctx, plan, runner) set to ``level``, shrink a
        fixed chunk budget and a fixed draft length while escalated
        (``shrink_chunk``, ``shrink_draft``: a smaller verify window is a
        smaller retry blast radius), emit a
        ``protection_escalation`` instant with the rate evidence, re-emit
        the plan rows and re-baseline the fault-rate monitor."""
        self.protection_level = level
        self.ctx = self._level_ctx[level]
        self.plan = self._level_plans[level]
        self.runner = self._level_runners[level]
        if level:
            self.stats.protection_escalations += 1
        else:
            self.stats.protection_deescalations += 1
        if self._chunk_tokens_base is not None and not self.chunk_auto \
                and self.adaptive is not None:
            if level and self.adaptive.shrink_chunk < 1.0:
                self.chunk_tokens = max(8, (int(
                    self._chunk_tokens_base * self.adaptive.shrink_chunk)
                    // 8) * 8)
            else:
                self.chunk_tokens = self._chunk_tokens_base
        if self._draft_len_base is not None and self.adaptive is not None:
            if level and self.adaptive.shrink_draft < 1.0:
                self.draft_len = max(1, int(
                    self._draft_len_base * self.adaptive.shrink_draft))
            else:
                self.draft_len = self._draft_len_base
        args = {"level": level,
                "direction": "escalate" if level else "deescalate"}
        for k in ("window_detection_rate", "window_hard_fault_rate",
                  "ewma_detections_per_step", "ewma_hard_faults_per_step"):
            if k in evidence:
                args[k] = evidence[k]
        self._tr.instant("protection_escalation", args)
        self._emit_plan_rows()
        if self.telemetry is not None:
            self.telemetry.faults.reset()

    def _maybe_adapt(self) -> None:
        if self.adaptive is None or self.telemetry is None:
            return
        snap = self.telemetry.faults.snapshot()
        if self.adaptive.update(snap):
            self._set_protection_level(self.adaptive.level, snap)

    # ------------------------------------------------ injection bookkeeping
    def _take_injection_meta(self, default_source: str) -> dict:
        """Claim the pending injection metadata (set by step()/run()) or
        synthesize one for a directly-passed fault."""
        meta = self._injection_meta
        self._injection_meta = None
        if meta is None:
            meta = {"source": default_source, "kind": "manual"}
        return meta

    def _record_injection(self, meta: dict, phase: str, outcome: str,
                          **extra) -> None:
        entry = dict(meta)
        entry["engine_step"] = self.stats.steps
        entry["phase"] = phase
        entry["outcome"] = outcome
        entry.update(extra)
        self.stats.record_injection(entry)
        self._tr.instant("fault_injected", {
            "phase": phase, "outcome": outcome,
            "kind": entry.get("kind"), "source": entry.get("source")})

    def _cells(self, kv, rows=None) -> Cells:
        """``Cells`` of a call: ``kv(pool)`` builds the attention index
        from the first attention leaf (skipped without one); ``rows`` the
        slots whose state the call replaced; both in logical slots, then
        cut to the cells this rank holds, at its local index
        (``executor.local_cells``: a data rank's slots or positions)."""
        pool = self.model.kv_leaf(self.cache)
        return self.executor.local_cells(
            Cells(None if pool is None else kv(pool), rows),
            self.pool is not None)

    def _leaves(self, cells: Cells) -> list:
        """(leaf, index) for every leaf ``cells`` covers: each attention
        leaf (GQA's k and v, MLA's latent) at ``cells.kv``, each per-slot
        state leaf at ``cells.rows``; read in the attempt's uncommitted
        cache while one is staged."""
        cache = self._staged if self._staged is not None else self.cache
        out = []
        for layer, state in zip(cache, self.model.state_layers):
            idx = cells.rows if state else cells.kv
            if idx is not None:
                out += [(leaf, idx) for leaf in cell_leaves(layer)]
        return out

    def _gather(self, cells: Cells) -> list:
        return [leaf[idx] for leaf, idx in self._leaves(cells)]

    def _scatter(self, cells: Cells, values) -> None:
        for (leaf, idx), v in zip(self._leaves(cells), values):
            leaf[idx] = v

    def _shadow_outcome(self, emitted, cells, rerun) -> tuple:
        """Classify an UNDETECTED injection: keep the cache cells the
        faulted attempt wrote, re-run the step clean (``rerun``), compare
        tokens and those cells, then scatter the faulted cells back so the
        faulted result stays committed.  SDC: the emitted tokens differ;
        masked: they agree (``state_match`` says whether the cells did)."""
        faulted = self._gather(cells)
        s_emitted, _ = rerun()
        tokens_match = bool(torch.equal(emitted, s_emitted))
        differs = not all(bool(torch.equal(a, b))
                          for a, b in zip(faulted, self._gather(cells)))
        # each rank compares its own shard of the cells
        state_match = not bool(or_flag(
            torch.tensor(differs, device=emitted.device),
            self.executor.world))
        self._scatter(cells, faulted)
        outcome = "masked" if tokens_match else "sdc"
        return outcome, {"tokens_match": tokens_match,
                         "state_match": state_match}

    def _resolve(self, phase: str, attempt, first, flag, meta, retry_fault,
                 cells) -> tuple:
        """The detect->retry window of one model call: on a raised flag
        retry with ``retry_fault`` (None, or the sticky fault itself) up to
        ``max_retries`` times (a chunk's retries also count in
        ``chunk_retries``, a verify window's in ``verify_retries``); record
        a tracked injection's outcome, shadow-classifying it when
        undetected.  Returns (emitted, flag)."""
        with self._tr.span("abft_check", {"phase": phase}):
            faulted = bool(flag)
        if faulted:
            self.stats.faults_detected += 1
            self._tr.instant("fault_detected", {"phase": phase})
            for _ in range(self.policy.max_retries):
                self.stats.retries += 1
                if phase == "prefill_chunk":
                    self.stats.chunk_retries += 1
                elif phase == "verify":
                    self.stats.verify_retries += 1
                with self._tr.span("abft_retry", {"phase": phase}) as sp:
                    first, flag = attempt(retry_fault)
                    sp.fence(first, flag)
                if not bool(flag):
                    break
            if meta is not None:
                self._record_injection(
                    meta, phase,
                    "uncorrected" if bool(flag) else "corrected")
        elif meta is not None:
            outcome, extra = ("undetected", {})
            if self.classify_injections:
                outcome, extra = self._shadow_outcome(
                    first, cells(), lambda: attempt(None))
            self._record_injection(meta, phase, outcome, **extra)
        return first, flag

    # ------------------------------------------------ admission
    def admit(self, pending: list, fault: ModelFault | None = None,
              fault_uid: int | None = None) -> list:
        """Batched admission: consumes requests from ``pending`` in place
        and returns them; each ends up active, done, or rejected/evicted
        with ``error`` set.  ``fault`` is injected only if the request
        ``fault_uid`` reaches prefill."""
        with self._tr.span("admit") as sp:
            consumed = self._admit_impl(pending, fault, fault_uid)
            sp.set_args(consumed=len(consumed),
                        admitted=len([r for r in consumed
                                      if r.error is None]))
        self._sync_telemetry()
        return consumed

    def _copy_cow_blocks(self, cow_pairs: list) -> None:
        """Commit COW payload moves BEFORE any attempt, so the
        detect->retry window sees stable tables and block contents
        (plain data movement, not a protected GEMM)."""
        if not cow_pairs:
            return
        with self._tr.span("cow_copy", {"pairs": len(cow_pairs)}) as sp:
            self.model.copy_paged_blocks(self.cache,
                                         [src for src, _ in cow_pairs],
                                         [dst for _, dst in cow_pairs])
            sp.fence(self.model.kv_leaf(self.cache))
        self.stats.cow_copies += len(cow_pairs)

    def _admit_impl(self, pending: list, fault, fault_uid) -> list:
        batch = self.scheduler.select_admission(pending)
        admitted, slot_list = batch.admitted, batch.slot_list
        if not admitted:
            return batch.consumed
        if fault is not None and fault_uid is not None and not any(
                r.uid == fault_uid for r in admitted):
            fault = None
        if self.chunk_tokens is not None:
            # chunked admission allocates only: the prompts become chunk
            # cursors and step() co-schedules their chunks with decodes;
            # an admission fault fires at the target's first chunk
            self._copy_cow_blocks(batch.cow_pairs)
            self.scheduler.park_prefill(batch)
            if fault is not None and fault_uid is not None:
                self._pending_prefill_fault = (fault_uid, fault)
            return batch.consumed
        slot_ids = np.asarray(slot_list, np.int32)
        full_lens = np.asarray([len(r.prompt) for r in admitted], np.int32)
        prefix = np.asarray([p.match_len if p is not None else 0
                             for p in batch.prefix_plans], np.int32)
        lengths = full_lens - prefix        # valid suffix tokens per row
        Lpad = min(_pad_len(int(lengths.max())), self.max_len)
        toks = np.zeros((len(admitted), Lpad), np.int64)
        for i, r in enumerate(admitted):
            toks[i, :lengths[i]] = r.prompt[prefix[i]:]
        # COW payload moves are committed BEFORE the attempt
        self._copy_cow_blocks(batch.cow_pairs)
        starts = self._dev(prefix) if prefix.any() else None
        args = (self.params, self._dev(toks), self.cache,
                self._dev(slot_ids), self._dev(lengths),
                self._tables(slot_ids))
        gens = self._gens_for(slot_ids)
        saved = self._save_gens(gens)

        def attempt(fa):
            # every attempt draws from the pre-admission generator states
            self._restore_gens(gens, saved)
            if starts is not None:
                return self.runner.prefill_prefix(*args, starts, fa, gens)
            return self.runner.prefill(*args, fa, gens)

        def cells():
            if self.pool is None:
                return self._cells(
                    lambda _: attention.prefill_cells(args[3], Lpad),
                    args[3].long())
            return self._cells(lambda pool: paged_cache.prefill_cells(
                pool, args[5], args[4], Lpad, starts), args[3].long())

        meta = self._take_injection_meta("admit_fault") \
            if fault is not None else None
        with self._tr.span("prefill", {"rows": len(admitted),
                                       "tokens": int(lengths.sum())}) as sp:
            first, flag = attempt(fault)
            sp.fence(first, flag)
        # the clean retry rewrites every cache cell the faulted attempt
        # wrote (same rows and positions); admission retries run clean,
        # as the reference's do
        first, flag = self._resolve("prefill", attempt, first, flag, meta,
                                    None, cells)
        if bool(flag):
            # persistent fault: evict the admission batch; releasing drops
            # refcounts only, so a shared block a live request holds stays
            self.stats.hard_faults += 1
            self._tr.instant("hard_fault", {"phase": "prefill"})
            self._restore_gens(gens, saved)
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
            self.stats.prompt_tokens_total += int(full_lens[i])
            self.stats.prefix_tokens_shared += int(prefix[i])
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
                self.scheduler.release(int(slot))
                continue
            self.active[int(slot)] = req
            self.pos[int(slot)] = int(full_lens[i])
            if self.index is not None:
                # registered only after the flag read back clean: the
                # index never names blocks holding a faulty attempt's data
                self.index.add(req.prompt, self.pool.tables[int(slot)])
        return batch.consumed

    # ------------------------------------------------ decoding
    def step(self, fault: ModelFault | None = None) -> dict:
        """One engine step.  Returns {uid: token} for decoded slots.
        Unchunked: one decode step for all active slots.  Chunked: one
        budgeted step, every resident decode token first, then prompt
        chunks from the cursor queue in the rest of the budget.

        With a ``fault_model`` attached and no explicit ``fault``, the
        campaign process is polled for this step's injection.  An adaptive
        policy re-evaluates the protection level BEFORE the step."""
        before = self.stats.steps
        t0 = time.perf_counter()
        self._maybe_adapt()
        if fault is None and self.fault_model is not None:
            ev = self.fault_model.poll()
            if ev is not None:
                fault = ev.model_fault
                self._injection_meta = {"source": "campaign",
                                        **ev.describe()}
        if self.chunk_tokens is not None:
            out = self._step_chunked(fault)
        else:
            out = self._serve_core(fault)
            if self.stats.steps > before:
                self._observe_step_mix(self._last_decode_tokens, 0)
        # a fault that found no executing call (idle engine) corrupted
        # nothing: drop its unclaimed metadata
        self._injection_meta = None
        if self.telemetry is not None:
            if self.stats.steps > before:
                self.telemetry.observe_step_latency(
                    time.perf_counter() - t0)
            self._sync_telemetry()
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
            self._tr.instant("scheme_flip", {
                "intensity": sel.arithmetic_intensity,
                "scheme": sel.scheme_name,
                "decode": decode_tokens, "prefill": prefill_tokens,
                "model_parallel": self.model_parallel,
            })
        self._last_scheme = sel.scheme_name

    def _retune_chunk_budget(self) -> None:
        """Auto budget: re-tuned from the resident decode tokens (its
        floor) as occupancy drifts."""
        budget = self.plan.tune_chunk_budget(
            decode_tokens=len(self.active), lo=8, hi=self.max_len)
        if budget != self.chunk_tokens:
            self.chunk_tokens = budget
            self.stats.chunk_budget_retunes += 1

    def _step_chunked(self, fault: ModelFault | None = None) -> dict:
        """One budgeted mixed step: decode first (every resident stream
        advances every step), then prompt chunks in ``chunk_tokens -
        n_decode``.  A step fault lands on the chunk batch when one is
        scheduled, else on the decode call; each call retries on its own."""
        if self.chunk_auto:
            self._retune_chunk_budget()
        n_decode = len(self.active)
        rows = self.scheduler.plan_chunks(
            max(0, self.chunk_tokens - n_decode))
        prefill_tokens = sum(take for _, _, take, _ in rows)
        chunk_fault = fault if rows else None
        decode_fault = fault if not rows else None
        out = {}
        before = self.stats.steps
        self._last_decode_tokens = 0
        if self.active:
            out = self._serve_core(decode_fault)
        if rows:
            if not self._run_prefill_chunk(rows, chunk_fault):
                prefill_tokens = 0     # discarded: never actually served
            if self.stats.steps == before:
                # a chunk-only step still counts, so run()'s fault_at
                # disarm sees it and never re-injects a consumed fault
                self.stats.steps += 1
        if self.stats.steps > before:
            self._observe_step_mix(self._last_decode_tokens, prefill_tokens)
        return out

    def _run_prefill_chunk(self, rows: list, fault) -> bool:
        """Execute one co-scheduled chunk batch.  Cursors and tables change
        only outside the attempt/retry window; a detected fault re-runs
        the chunk alone, rewriting exactly the cells its attempt wrote.
        Returns False when a persistent fault evicted the batch."""
        A = len(rows)
        slot_list = [s for s, _, _, _ in rows]
        # a pending admission fault is consumed by the first chunk batch
        # holding its target (one fault per call: a step fault already
        # routed here retires it)
        pending_src = False
        if self._pending_prefill_fault is not None:
            uid, pf = self._pending_prefill_fault
            if any(cur.req.uid == uid for _, cur, _, _ in rows):
                if fault is None:
                    fault = pf
                    pending_src = True
                self._pending_prefill_fault = None
        meta = None
        if fault is not None:
            meta = self._take_injection_meta(
                "admit_fault" if pending_src else "manual")
        Apad = _pad_rows(A, self.slots)
        Lpad = min(_pad_len(max(take for _, _, take, _ in rows)),
                   self.max_len)
        toks = np.zeros((Apad, Lpad), np.int64)
        slot_ids = np.full((Apad,), slot_list[0], np.int32)
        lengths = np.zeros((Apad,), np.int32)
        starts = np.zeros((Apad,), np.int32)
        final = np.zeros((Apad,), bool)
        for i, (slot, cur, take, fin) in enumerate(rows):
            toks[i, :take] = cur.req.prompt[cur.filled:cur.filled + take]
            slot_ids[i] = slot
            lengths[i] = take
            starts[i] = cur.filled
            final[i] = fin
        # padding rows alias row 0's slot with lengths 0: they write no
        # cache cell and draw nothing (no generator, final False)
        args = (self.params, self._dev(toks), self.cache,
                self._dev(slot_ids), self._dev(lengths),
                self._tables(slot_ids), self._dev(starts), self._dev(final))
        gens = self._gens_for([slot_ids[i] if final[i] else None
                               for i in range(Apad)])
        saved = self._save_gens(gens)
        retry_f = fault if (meta is not None
                            and meta.get("kind") == "permanent") else None

        def attempt(fa):
            self._restore_gens(gens, saved)
            return self.runner.prefill_chunk(*args, fa, gens)

        def cells():
            if self.pool is None:
                return self._cells(lambda _: attention.prefill_cells(
                    args[3], Lpad, args[6], args[4]))
            return self._cells(lambda pool: paged_cache.prefill_cells(
                pool, args[5], args[4], Lpad, args[6]))

        with self._tr.span("prefill_chunk",
                           {"rows": A, "tokens": int(lengths.sum())}) as sp:
            first, flag = attempt(fault)
            sp.fence(first, flag)
        first, flag = self._resolve("prefill_chunk", attempt, first, flag,
                                    meta, retry_f, cells)
        if bool(flag):
            # persistent chunk fault: evict only this batch (its earlier
            # chunks die with its blocks; refcounts keep a shared prefix a
            # live sharer holds)
            self.stats.hard_faults += 1
            self._tr.instant("hard_fault", {"phase": "prefill_chunk"})
            self._restore_gens(gens, saved)
            for slot, cur, _, _ in rows:
                self.scheduler.finish(cur.req, "hard_fault:prefill",
                                      evict=True)
                del self._prefill_cursors[slot]
                self.scheduler.release(slot)
                if self._pending_prefill_fault is not None and \
                        self._pending_prefill_fault[0] == cur.req.uid:
                    self._pending_prefill_fault = None
            return False
        self.stats.prefill_chunks += A
        first = first.cpu().numpy()
        now = time.perf_counter()
        for i, (slot, cur, take, fin) in enumerate(rows):
            cur.filled += take
            self.pos[slot] = cur.filled
            if not fin:
                continue
            req = cur.req
            req.generated.append(int(first[i]))
            req.times.append(now)
            self.stats.tokens += 1
            self.stats.prompt_tokens_total += cur.total
            self.stats.prefix_tokens_shared += cur.prefix
            del self._prefill_cursors[slot]
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
                self.scheduler.release(slot)
                continue
            self.active[slot] = req
            if self.index is not None:
                self.index.add(req.prompt, self.pool.tables[slot])
        return True

    def _decode_core(self, fault: ModelFault | None = None) -> dict:
        self._last_decode_tokens = 0
        # the growth/COW guard runs BEFORE the step; its COW payload
        # moves are committed here on the device
        self._copy_cow_blocks(self.scheduler.grow_for_decode())
        if not self.active:
            return {}
        toks = np.zeros((self.slots, 1), np.int64)
        mask = np.zeros((self.slots,), bool)
        for s, req in self.active.items():
            toks[s, 0] = req.generated[-1]
            mask[s] = True
        args = (self.params, self._dev(toks), self.cache,
                self._dev(self.pos.copy()), self._dev(mask), self._tables())
        gens = self._gens_for([s if mask[s] else None
                               for s in range(self.slots)])
        saved = self._save_gens(gens)
        meta = self._take_injection_meta("manual") \
            if fault is not None else None
        # a sticky permanent fault models a faulty UNIT: it corrupts the
        # retry exactly like the attempt; other faults retry clean
        retry_f = fault if (meta is not None
                            and meta.get("kind") == "permanent") else None

        def attempt(fa):
            # the retry rewrites the same (slot, pos) cells of every layer
            # before reading them, reads the committed pre-step state, and
            # redraws from the same generator states
            self._restore_gens(gens, saved)
            nxt, flag, self._staged = self.runner.decode(*args, fa, gens)
            return nxt, flag

        def cells():
            every = torch.arange(self.slots, device=self.device)
            if self.pool is None:
                return self._cells(lambda _: attention.decode_cells(args[3]),
                                   every)
            return self._cells(lambda pool: paged_cache.decode_cells(
                pool, args[5], args[3]), every)

        with self._tr.span("decode_step",
                           {"tokens": len(self.active)}) as sp:
            nxt, flag = attempt(fault)
            sp.fence(nxt, flag)
        self.stats.steps += 1
        if self.pool is not None:
            self.stats.observe_blocks_used(self.pool.blocks_used)
            self.stats.blocks_shared_peak = max(
                self.stats.blocks_shared_peak, self.pool.blocks_shared)
        nxt, flag = self._resolve("decode", attempt, nxt, flag, meta,
                                  retry_f, cells)
        staged, self._staged = self._staged, None
        if bool(flag):
            self.stats.hard_faults += 1
            self._tr.instant("hard_fault", {"phase": "decode"})
            self._restore_gens(gens, saved)
            if not self.policy.evict_on_hard_fault:
                raise RuntimeError("persistent fault after retry")
            victims = list(self.active.items())
            self.active.clear()
            self._finish_evicted(victims, "hard_fault:decode")
            return {}
        # the flag cleared: commit the accepted attempt's state
        self.executor.cache = staged
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

    # ------------------------------------------------ speculative decoding
    def _serve_core(self, fault: ModelFault | None = None) -> dict:
        """One resident-slot step: the verify core when a proposer is
        attached, else plain decode.  Leaves ``_last_decode_tokens`` at
        the step's decode-side token count (window tokens for verify), so
        the step's scheme selection sees the multiplied intensity."""
        self._last_decode_tokens = 0
        if self.spec is not None:
            return self._verify_core(fault)
        return self._decode_core(fault)

    def _retune_draft_len(self) -> None:
        """Auto draft length, re-tuned from live occupancy (the verify
        step's token count is batch x (K+1)); ``shrink_draft`` applies
        while escalated."""
        k = max(1, self.plan.tune_draft_len(
            batch=max(1, len(self.active))))
        if self.adaptive is not None and self.protection_level \
                and self.adaptive.shrink_draft < 1.0:
            k = max(1, int(k * self.adaptive.shrink_draft))
        self.draft_len = k

    def _verify_core(self, fault: ModelFault | None = None) -> dict:
        """One speculative verify step for every active slot: propose up
        to ``draft_len`` tokens a slot (clamped to the slot's remaining
        budget), score each slot's K_s+1 window in ONE ``verify`` call
        (T = the longest window), then accept on the host.  Cursors move only after acceptance, so
        a detected fault re-runs the window alone, rewriting exactly the
        cells its attempt wrote; a sticky fault exhausts the retries and
        evicts every resident slot.  Returns {uid: last emitted token}."""
        if self.draft_auto:
            self._retune_draft_len()
        proposals: dict = {}
        for s, req in sorted(self.active.items()):
            budget = min(self.draft_len,
                         req.max_new_tokens - len(req.generated) - 1)
            d = (np.asarray(self.spec.propose(req, budget), np.int32)
                 if budget > 0 else np.zeros((0,), np.int32))
            proposals[s] = d[:max(0, budget)]
            self.stats.draft_proposed += len(proposals[s])
        # the paged growth/COW guard covers the whole window
        self._copy_cow_blocks(self.scheduler.grow_for_verify(
            {s: len(d) for s, d in proposals.items()}))
        if not self.active:
            return {}
        # the window's width is the longest proposal's (the reference pads
        # every step to draft_len + 1 for one jit shape; eager PyTorch has
        # none to keep, and every row is computed in decode's order at any
        # T, so a step whose drafts all missed costs what decode does);
        # under MoE the width sets each expert's capacity, so it is the
        # reference's
        T = (self.draft_len + 1 if self._moe_window
             else 1 + max(len(proposals[s]) for s in self.active))
        toks = np.zeros((self.slots, T), np.int64)
        valid = np.zeros((self.slots,), np.int32)
        for s, req in self.active.items():
            d = proposals[s]
            toks[s, 0] = req.generated[-1]
            toks[s, 1:1 + len(d)] = d
            valid[s] = len(d) + 1
        window_tokens = int(valid.sum())
        args = (self.params, self._dev(toks), self.cache,
                self._dev(self.pos.copy()), self._dev(valid), self._tables())
        meta = self._take_injection_meta("manual") \
            if fault is not None else None
        retry_f = fault if (meta is not None
                            and meta.get("kind") == "permanent") else None

        def attempt(fa):
            return self.runner.verify(*args, fa)

        def cells():
            if self.pool is None:
                return self._cells(lambda _: attention.verify_cells(
                    args[3], args[4], self.max_len))
            return self._cells(lambda pool: paged_cache.prefill_cells(
                pool, args[5], args[4], T, args[3]))

        with self._tr.span("verify_step",
                           {"tokens": window_tokens,
                            "draft_len": self.draft_len}) as sp:
            logits, flag = attempt(fault)
            sp.fence(logits, flag)
        self.stats.steps += 1
        if self.pool is not None:
            self.stats.observe_blocks_used(self.pool.blocks_used)
            self.stats.blocks_shared_peak = max(
                self.stats.blocks_shared_peak, self.pool.blocks_shared)
        logits, flag = self._resolve("verify", attempt, logits, flag, meta,
                                     retry_f, cells)
        if bool(flag):
            self.stats.hard_faults += 1
            self._tr.instant("hard_fault", {"phase": "verify"})
            if not self.policy.evict_on_hard_fault:
                raise RuntimeError("persistent fault after retry")
            victims = list(self.active.items())
            self.active.clear()
            self._finish_evicted(victims, "hard_fault:verify")
            return {}
        greedy = self.temperature <= 0.0
        targets = (torch.argmax(logits, dim=-1).cpu().numpy() if greedy
                   else None)
        out = {}
        finished = []
        now = time.perf_counter()
        for s, req in list(self.active.items()):
            d = proposals[s]
            if greedy:
                emitted = greedy_accept(d, targets[s, :len(d) + 1])
            else:
                rows = logits[s, :len(d) + 1].float().cpu().numpy()
                emitted = rejection_sample(
                    d, target_probs(rows, self.temperature, self.top_k),
                    self.generators[s])
            self.stats.draft_accepted += len(emitted) - 1
            for t in emitted:
                req.generated.append(int(t))
                req.times.append(now)
                self.stats.tokens += 1
            self.pos[s] += len(emitted)
            out[req.uid] = int(emitted[-1])
            if len(req.generated) >= req.max_new_tokens:
                self.scheduler.finish(req)
                finished.append(s)
        for s in finished:
            del self.active[s]
            self.scheduler.release(s)
        self._last_decode_tokens = window_tokens
        return out

    def run(self, requests: list, fault_at: tuple | None = None,
            admit_fault_at: tuple | None = None) -> dict:
        """Drive admission + decode to completion.  ``fault_at=(step,
        fault)`` arms a decode-step fault from that step index on (it
        fires at the first step that actually decodes);
        ``admit_fault_at=(uid, fault)`` injects into the admission batch
        containing that request.  Where an armed fault landed is recorded
        in ``stats.injection_log`` (``source="fault_at"``)."""
        pending = list(requests)
        results = {r.uid: r.generated for r in requests if r.done}
        self.scheduler.drain_finished()
        step_i = 0
        armed = fault_at is not None
        while pending or self.active or self._prefill_cursors:
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
            fault = None
            if armed and step_i >= fault_at[0]:
                fault = fault_at[1]
                self._injection_meta = {
                    "source": "fault_at", "kind": "manual",
                    "armed_step": fault_at[0], "run_step": step_i}
            before = self.stats.steps
            self.step(fault)
            if fault is not None and self.stats.steps > before:
                armed = False
            step_i += 1
            for req in self.scheduler.drain_finished():
                results.setdefault(req.uid, req.generated)
        return results

    def cache_stats(self) -> dict:
        """Cache geometry and occupancy.  Paged ``utilization`` is live
        logical tokens over allocated tokens; under prefix sharing it may
        exceed 1.0 (several slots count one shared block) — that excess is
        the sharing win.  Also ``blocks_shared`` and ``prefix_hit_rate``."""
        stats = {
            "kind": self.cache_kind,
            "slots": self.slots,
            "max_len": self.max_len,
            "bytes_total": pytree_bytes(self.cache),
            "active_tokens": int(
                sum(int(self.pos[s]) for s in self.active)
                + sum(int(self.pos[s]) for s in self._prefill_cursors)),
        }
        if self.pool is not None:
            allocated = self.pool.blocks_used * self.pool.block_size
            stats.update(block_size=self.pool.block_size,
                         blocks_total=self.pool.num_blocks,
                         blocks_used=self.pool.blocks_used,
                         blocks_free=self.pool.blocks_free,
                         blocks_shared=self.pool.blocks_shared,
                         tokens_capacity=self.pool.num_blocks
                         * self.pool.block_size,
                         tokens_allocated=allocated)
        else:
            stats["tokens_capacity"] = self.slots * self.max_len
            stats["tokens_allocated"] = stats["tokens_capacity"]
            stats["blocks_shared"] = 0
        alloc = stats["tokens_allocated"]
        stats["utilization"] = stats["active_tokens"] / alloc if alloc else 0.0
        stats["fragmentation"] = (max(0.0, 1.0 - stats["utilization"])
                                  if alloc else 0.0)
        stats["prefix_hit_rate"] = self.stats.prefix_hit_rate
        return stats
