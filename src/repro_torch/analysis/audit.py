"""The protection-coverage auditor (port of ``repro.analysis.audit``): run
the real entry points, record every FLOP, prove each flows through a
registered ABFT scheme.

``audit_model`` runs the model's ACTUAL serving entry points —
``Model.prefill``, ``Model.decode``, and (for chunked-prefill-capable
stacks) the engine's ``_run_prefill_chunk`` and ``_verify_core`` steps —
under the op walker (op_walk.py) and classifies every FLOP-carrying op by
its markers (markers.py):

``protected``
    Inside an ``abft[<scheme>][<site>]`` scope — opened by
    ``protected_matmul``'s executor dispatch.  Includes the check
    contractions and the K1 records: they are part of the protected
    surface.
``known_unprotected``
    Inside ``flops[mla|ssm_scan|conv_stem]``: FLOP regions with no
    registered ABFT scheme yet, tracked explicitly (with a note) instead
    of failing the audit — the whisper conv frontend (ROADMAP item 5a),
    the MLA absorbed products, the SSD scan contractions.
``kernel``
    A K2 or K3 record (or an op inside one): a fused kernel with its own
    in-kernel checks.  It comes before the allowlist, so a flash kernel
    inside a softmax region is not mistaken for a leftover.
``allowlisted``
    Inside ``flops[softmax]``: the attention score/PV products that the
    fused flash-ABFT kernels replace when ``flash_attention=True``.
    ``flash_allowlist_check`` validates the allowlist against the model's
    real flash routing: re-running decode with flash enabled must make
    these products vanish.
``unprotected``
    Everything else.  A product with no marker is exactly the drift this
    auditor exists to catch; it fails ``--fail-under 1.0``.

The protected fraction is ``protected / (protected + unprotected)`` —
allowlisted and known-unprotected FLOPs are excluded from the
denominator because they are *accounted for*, not silently missing.

A second pass (crosscheck.py) proves the compiled ``ProtectionPlan`` and
the executed site set are bijective.

The reference audits its block schemes through their XLA emulation (a
product and two rank-1 check einsums); the port has no emulation switch,
so K1 records itself with the emulation's FLOPs, 2 m k n + 4 m k
(``kernels/ops.k1_flops``), on both devices.  The engine's steps run on
an engine built for the audit, two requests admitted; the walker only
observes, so the engine ends as an un-audited run of the same calls
leaves it.

CLI: ``python -m repro_torch.launch.audit``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.crosscheck import CrossCheckResult, crosscheck_plan
from repro_torch.analysis.markers import KERNELS, parse_name_stack
from repro_torch.analysis.op_walk import TracedOp, flop_ops

F32 = torch.float32
PHASES = ("prefill", "decode", "mixed")

KNOWN_UNPROTECTED_KINDS = ("mla", "ssm_scan", "conv_stem")
ALLOWLISTED_KINDS = ("softmax",)

# one-line dispositions surfaced next to every known-unprotected bucket
KNOWN_GAP_NOTES = {
    "conv_stem": (
        "whisper conv frontend: no conv ABFT scheme registered; "
        "ROADMAP item 5a tracks a checksummed im2col GEMM"),
    "mla": (
        "MLA absorb einsums + absorbed attention core: no fused ABFT "
        "kernel (flash routing never reaches MLA)"),
    "ssm_scan": (
        "SSD scan / decode recurrence contractions: weight-free "
        "data-data einsums outside the matmul-ABFT surface"),
}


@dataclasses.dataclass(frozen=True)
class ClassifiedOp:
    """One recorded op with its audit disposition."""

    op: TracedOp
    status: str                 # protected|allowlisted|known_unprotected|
                                # unprotected|kernel
    scheme: str | None = None   # when protected
    site: str | None = None     # when protected
    kind: str | None = None     # when allowlisted / known_unprotected


def classify(ops) -> tuple:
    """Marker-based classification of an op inventory.

    Precedence: an ``abft`` marker wins outright (a protected dense call
    inside a ``flops[...]`` region is still protected, and so is a K1
    record); then a known-unprotected kind (innermost first), so an SSD
    scan nested under a softmax-annotated caller is reported as the gap
    it is; then a ``kernel`` marker (a K2/K3 record); then the softmax
    allowlist."""
    out = []
    for op in ops:
        m = parse_name_stack(op.name_stack)
        if m.protected:
            out.append(ClassifiedOp(op, "protected",
                                    scheme=m.scheme, site=m.site))
            continue
        kind = next((k for k in reversed(m.kinds)
                     if k in KNOWN_UNPROTECTED_KINDS), None)
        if kind is not None:
            out.append(ClassifiedOp(op, "known_unprotected", kind=kind))
        elif m.kernel is not None:
            out.append(ClassifiedOp(op, "kernel"))
        elif any(k in ALLOWLISTED_KINDS for k in m.kinds):
            out.append(ClassifiedOp(op, "allowlisted", kind="softmax"))
        else:
            out.append(ClassifiedOp(op, "unprotected"))
    return tuple(out)


def kernel_records(ops) -> dict:
    """Records of each fused kernel in an op inventory: {K1, K2, K3: n}."""
    counts = dict.fromkeys(KERNELS, 0)
    for op in ops:
        if op.primitive in counts:
            counts[op.primitive] += 1
    return counts


def product_flops(ops) -> float:
    """FLOPs of the PRIMARY protected products (2 m k n each): the K1
    records' products without their checks, and the plain products of
    ``none``/``global`` (n > 1; the checks contract against a rank-1
    vector)."""
    return sum(2.0 * op.m * op.k * op.n for op in ops
               if op.n > 1 and op.primitive != "convolution"
               and parse_name_stack(op.name_stack).protected)


def card_split_ops(report, window: int = 4) -> int:
    """Ops a CUDA run of an audit adds to ``report``'s (a CPU run's)
    ``mixed`` phase: the speculative verify step runs a ``none``/``global``
    product on the card one window step at a time
    (``core/protected._plain_dot`` under ``decode_rows``), ``window``
    products where the CPU runs one, the same FLOPs in all.  ``window``:
    ``verify_engine``'s draft_len + 1."""
    mixed = report.phases.get("mixed")
    if mixed is None:
        return 0
    return (window - 1) * sum(
        1 for c in mixed.ops
        if c.op.path.startswith("engine._verify_core")
        and c.op.primitive == "mm" and c.op.n > 1
        and c.status == "protected" and c.scheme in ("none", "global"))


@dataclasses.dataclass(frozen=True)
class PhaseCoverage:
    """FLOP accounting of one audited phase."""

    phase: str
    ops: tuple                         # full ClassifiedOp inventory

    def _sum(self, status: str) -> float:
        return sum(c.op.flops for c in self.ops if c.status == status)

    @property
    def protected_flops(self) -> float:
        return self._sum("protected")

    @property
    def allowlisted_flops(self) -> float:
        return self._sum("allowlisted")

    @property
    def unprotected_flops(self) -> float:
        return self._sum("unprotected")

    @property
    def kernel_flops(self) -> float:
        """FLOPs of the K2/K3 records (fused checks of their own)."""
        return self._sum("kernel")

    @property
    def known_unprotected(self) -> dict:
        out: dict = {}
        for c in self.ops:
            if c.status == "known_unprotected":
                out[c.kind] = out.get(c.kind, 0.0) + c.op.flops
        return out

    @property
    def unprotected_ops(self) -> tuple:
        return tuple(c for c in self.ops if c.status == "unprotected")

    @property
    def protected_fraction(self) -> float:
        """Protected share of the FLOPs that are SUPPOSED to be on the
        matmul-ABFT surface (allowlisted / known-unprotected excluded —
        they are accounted for, not missing)."""
        denom = self.protected_flops + self.unprotected_flops
        return 1.0 if denom == 0 else self.protected_flops / denom

    def to_json(self) -> dict:
        return {
            "phase": self.phase,
            "n_ops": len(self.ops),
            "protected_flops": self.protected_flops,
            "allowlisted_flops": self.allowlisted_flops,
            "unprotected_flops": self.unprotected_flops,
            "known_unprotected": {
                kind: {"flops": fl, "note": KNOWN_GAP_NOTES.get(kind, "")}
                for kind, fl in sorted(self.known_unprotected.items())
            },
            "protected_fraction": self.protected_fraction,
            "unprotected": [
                {"path": c.op.path, "primitive": c.op.primitive,
                 "flops": c.op.flops,
                 "m": c.op.m, "k": c.op.k, "n": c.op.n}
                for c in self.unprotected_ops
            ],
        }


@dataclasses.dataclass(frozen=True)
class AuditReport:
    """One model's full audit: per-phase coverage + plan crosscheck."""

    model: str
    phases: dict                       # phase -> PhaseCoverage
    crosscheck: CrossCheckResult
    flash_consistent: bool | None      # None: not applicable / rejected

    @property
    def protected_fraction(self) -> float:
        return min(p.protected_fraction for p in self.phases.values())

    @property
    def known_unprotected(self) -> dict:
        out: dict = {}
        for p in self.phases.values():
            for kind, fl in p.known_unprotected.items():
                out[kind] = max(out.get(kind, 0.0), fl)
        return out

    def to_json(self) -> dict:
        return {
            "model": self.model,
            "protected_fraction": self.protected_fraction,
            "phases": {ph: cov.to_json()
                       for ph, cov in sorted(self.phases.items())},
            "crosscheck": self.crosscheck.to_json(),
            "flash_consistent": self.flash_consistent,
        }

    def summary(self) -> str:
        lines = [f"coverage audit: {self.model}"]
        for ph, cov in sorted(self.phases.items()):
            gaps = ", ".join(
                f"{k}={v:.3g}" for k, v in sorted(
                    cov.known_unprotected.items())) or "none"
            lines.append(
                f"  {ph:8s} protected={cov.protected_fraction:.4f} "
                f"({cov.protected_flops:.3g} flops; "
                f"allowlisted={cov.allowlisted_flops:.3g}; "
                f"known gaps: {gaps})")
            for c in cov.unprotected_ops:
                lines.append(
                    f"    UNPROTECTED {c.op.primitive} "
                    f"m={c.op.m} k={c.op.k} n={c.op.n} "
                    f"flops={c.op.flops:.3g} at {c.op.path}")
        lines.append("  " + self.crosscheck.report().replace("\n", "\n  "))
        if self.flash_consistent is not None:
            lines.append(
                f"  flash allowlist consistent: {self.flash_consistent}")
        return "\n".join(lines)


# --------------------------------------------------------- entry points

def _audit_abft(flash: bool = False, hardware=None):
    from repro_torch.core.hardware import DEFAULT
    from repro_torch.core.protected import ABFTConfig

    return ABFTConfig(flash_attention=flash, hardware=hardware or DEFAULT)


def _zero_params(model, dtype, device):
    """Parameters of zeros in ``init_params``' exact structure (the
    reference's ``eval_shape`` zeros): the greedy engine then emits token
    0, which the n-gram proposer matches in an all-zero prompt."""
    from repro_torch.core.tree import tree_map

    return tree_map(torch.zeros_like,
                    model.init_params(0, dtype=dtype, device=device))


def _example_batch(model, batch: int, seq: int, device) -> tuple:
    """(tokens (batch, seq), memory inputs) of zeros, as the reference's."""
    cfg = model.cfg
    tokens = torch.zeros((batch, seq), dtype=torch.long, device=device)
    inputs = {}
    if cfg.is_encoder_decoder:
        if cfg.n_mels:
            # stride-2 SAME conv halves T: 2*enc_seq_len frames in
            inputs["audio"] = torch.zeros(
                (batch, 2 * cfg.enc_seq_len, cfg.n_mels), dtype=F32,
                device=device)
        else:
            inputs["enc_input"] = torch.zeros(
                (batch, cfg.enc_seq_len, cfg.d_model), dtype=F32,
                device=device)
    if cfg.vision_dim:
        inputs["images"] = torch.zeros(
            (batch, cfg.n_image_tokens, cfg.vision_dim), dtype=F32,
            device=device)
    return tokens, inputs


def trace_prefill(model, params, abft, *, batch=2, seq=8, max_len=16,
                  dtype=F32, device="cpu") -> list:
    from repro_torch.models.layers import LayerCtx

    ctx = LayerCtx(abft=abft)
    cache = model.init_cache(batch, max_len, dtype, device)
    tokens, inputs = _example_batch(model, batch, seq, device)
    with torch.no_grad():
        return flop_ops(lambda: model.prefill(params, tokens, cache, ctx,
                                              inputs=inputs),
                        entry="prefill")


def trace_decode(model, params, abft, *, batch=2, max_len=16, dtype=F32,
                 device="cpu") -> list:
    from repro_torch.models.layers import LayerCtx

    ctx = LayerCtx(abft=abft)
    cache = model.init_cache(batch, max_len, dtype, device)
    token = torch.zeros((batch, 1), dtype=torch.long, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    with torch.no_grad():
        return flop_ops(lambda: model.decode(params, token, cache, pos, ctx),
                        entry="decode")


def _requests(batch: int, seq: int, new_tokens: int) -> list:
    from repro_torch.serve.scheduler import Request

    return [Request(uid=i, prompt=np.zeros((seq,), np.int32),
                    max_new_tokens=new_tokens) for i in range(batch)]


def chunk_engine(model, params, abft, *, batch=2, seq=8, max_len=16,
                 dtype=F32, device="cpu") -> tuple:
    """An engine of ``batch`` slots with ``chunk_tokens=seq`` and
    ``batch`` prompts of ``seq`` tokens admitted, and its next chunk
    batch taking every prompt whole (the reference's ``_prefill_chunk``
    of (batch, seq) tokens from position 0): (engine, rows)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, params, slots=batch, max_len=max_len,
                      abft=abft, dtype=dtype, chunk_tokens=seq,
                      device=device)
    eng.admit(_requests(batch, seq, 2))
    return eng, eng.scheduler.plan_chunks(batch * seq)


def verify_engine(model, params, abft, *, batch=2, seq=8, draft_len=3,
                  max_len=16, dtype=F32, device="cpu"):
    """An n-gram engine with ``draft_len`` and ``batch`` all-zero prompts
    of ``seq`` tokens admitted: with zero weights the greedy token is 0,
    so each slot drafts ``draft_len`` zeros and the next verify window is
    ``draft_len + 1`` wide, the reference's."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, params, slots=batch, max_len=max_len,
                      abft=abft, dtype=dtype, spec_decode="ngram",
                      draft_len=draft_len, device=device)
    eng.admit(_requests(batch, seq, draft_len + 2))
    return eng


def trace_engine_chunk(model, params, abft, **kw) -> list:
    """Run the engine's REAL ``_run_prefill_chunk`` step — the mixed
    prefill+decode serving path — on ``chunk_engine``'s engine."""
    eng, rows = chunk_engine(model, params, abft, **kw)
    return flop_ops(lambda: eng._run_prefill_chunk(rows, None),
                    entry="engine._run_prefill_chunk")


def trace_engine_verify(model, params, abft, **kw) -> list:
    """Run the engine's REAL ``_verify_core`` step — the speculative
    K+1-token batched verify path — on ``verify_engine``'s engine.
    Verify sites reuse the decode ``LayerSpec`` names with K-scaled token
    dims, so the plan crosscheck (which ignores the M dim) keeps its
    bijection with zero plan edits."""
    return flop_ops(verify_engine(model, params, abft, **kw)._verify_core,
                    entry="engine._verify_core")


def flash_allowlist_check(model, params, *, batch=2, max_len=16, dtype=F32,
                          device="cpu", hardware=None):
    """Validate the softmax allowlist against the model's real flash
    routing: re-run decode with ``flash_attention=True`` — the
    allowlisted score/PV products must vanish (K3 replaces them).
    Returns None when the model has no flash-routed attention (MLA never
    routes to flash; cross-attention is not flash-routed) or the kernel
    wrapper rejects the audit shapes (``ValueError``)."""
    from repro_torch.models.model import layer_tags

    cfg = model.cfg
    if cfg.attention != "gqa" or cfg.cross_attn_every:
        return None
    if not any(t.split(":")[0] == "attn" for t in layer_tags(cfg)):
        return None
    try:
        ops = trace_decode(model, params,
                           _audit_abft(flash=True, hardware=hardware),
                           batch=batch, max_len=max_len, dtype=dtype,
                           device=device)
    except ValueError:
        return None                    # kernel wrapper rejected shapes
    return not any(c.status == "allowlisted" for c in classify(ops))


# ------------------------------------------------------------------ audits

def audit_model(model, phase: str = "mixed", *, plan=None, batch=2, seq=8,
                max_len=16, dtype=F32, check_flash: bool = True,
                hardware=None, device=None) -> AuditReport:
    """Audit one built Model.  ``phase``: prefill | decode | mixed
    (mixed runs the engine's ``_run_prefill_chunk``, decode and
    ``_verify_core`` when the stack supports chunked prefill, else the
    prefill+decode union).  The plan crosscheck always runs over the
    union of all phases run — some sites (``cross.k``, ``vision.proj``,
    ``enc.*``) execute only during prefill.  ``hardware``: the roofline
    the policy selects against and the plan is compiled for (the H100 by
    default); ``device``: CUDA unless ``"cpu"``."""
    from repro_torch.serve.executor import resolve_device

    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
    dev = resolve_device(device)
    abft = _audit_abft(hardware=hardware)
    params = _zero_params(model, dtype, dev)
    kw = dict(batch=batch, max_len=max_len, dtype=dtype, device=dev)

    pre = trace_prefill(model, params, abft, seq=seq, **kw)
    dec = trace_decode(model, params, abft, **kw)
    traces = {"prefill": pre, "decode": dec}
    if phase == "mixed":
        if model.supports_chunked_prefill:
            # chunked-prefill mixed step + plain decode + the speculative
            # K+1-token verify step: with speculation on, EVERY serving
            # FLOP still flows through a registered scheme
            traces["mixed"] = (
                trace_engine_chunk(model, params, abft, seq=seq, **kw)
                + dec + trace_engine_verify(model, params, abft, seq=seq,
                                            **kw))
        else:
            traces["mixed"] = pre + dec

    want = {"mixed": ("prefill", "decode", "mixed")}.get(phase, (phase,))
    phases = {ph: PhaseCoverage(phase=ph, ops=classify(traces[ph]))
              for ph in want}
    union = [op for ops in traces.values() for op in ops]
    plan = plan if plan is not None else model.protection_plan(
        abft.hardware)
    xc = crosscheck_plan(plan, union, model=model.cfg.name)
    flash = (flash_allowlist_check(model, params, hardware=hardware, **kw)
             if check_flash else None)
    return AuditReport(model=model.cfg.name, phases=phases, crosscheck=xc,
                       flash_consistent=flash)


def resolve_arch(name: str) -> str:
    """Registry name for a CLI-friendly alias (dashes/dots/underscores
    used interchangeably: ``llama3_2_1b`` -> ``llama3.2-1b``)."""
    from repro_torch.configs import list_archs

    archs = list_archs()
    if name in archs:
        return name

    def canon(s: str) -> str:
        return s.replace("-", "_").replace(".", "_")

    hits = [a for a in archs if canon(a) == canon(name)]
    if len(hits) != 1:
        raise KeyError(
            f"unknown arch {name!r}; available: {archs}")
    return hits[0]


def audit_config(name: str, phase: str = "mixed", **kw) -> AuditReport:
    """Audit one registered architecture (scaled-down build: the audit
    is a shape-level property — site structure, not weights — so the
    small config proves the same bijection)."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.models.model import Model

    cfg = scaled_down(get_config(resolve_arch(name)))
    return audit_model(Model(cfg), phase=phase, **kw)


@dataclasses.dataclass(frozen=True)
class ServedStepAudit:
    """One served engine call walked: its coverage, the engine's own plan
    (the per-shard plan under ``model_parallel``) crosschecked against the
    sites the call executed, and each fused kernel's records."""

    model: str
    model_parallel: int
    coverage: PhaseCoverage
    crosscheck: CrossCheckResult
    records: dict

    def to_json(self) -> dict:
        return {"model": self.model, "model_parallel": self.model_parallel,
                "protected_fraction": self.coverage.protected_fraction,
                "coverage": self.coverage.to_json(),
                "crosscheck": self.crosscheck.to_json(),
                "records": self.records}


def audit_served_step(engine, fn, phase: str = "decode") -> ServedStepAudit:
    """Walk ``fn()`` (an engine's ``step``, or an ``admit``) on ``engine``
    and audit it against ``engine.plan``.  On a mesh rank this is the
    rank's own step: its shard's GEMMs under the TP=k plan (every rank
    must step alike, since the step's collectives need them all)."""
    with torch.no_grad():
        ops = flop_ops(fn, entry=phase)
    cfg = engine.model.cfg
    return ServedStepAudit(
        model=cfg.name, model_parallel=engine.model_parallel,
        coverage=PhaseCoverage(phase=phase, ops=classify(ops)),
        crosscheck=crosscheck_plan(engine.plan, ops, model=cfg.name),
        records=kernel_records(ops))
