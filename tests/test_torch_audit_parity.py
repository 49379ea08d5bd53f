"""The port's coverage audit against the reference's LIVE audit, config by
config (``repro_torch.analysis.audit_config`` vs
``repro.analysis.audit.audit_config``, both at phase ``mixed`` on the
scaled-down configs and the TPU v5e roofline the reference selects
against by default).

The reference's walker reads ``jax.core.ClosedJaxpr``, which jax 0.9.0
no longer has (``src/repro/analysis/jaxpr_walk.py``, ``_sub_jaxprs``);
these tests replace that one function, inside the test process only, by
the same function reading ``jax.extend.core``.  The reference then
reproduces its committed ``AUDIT_coverage.json`` number for number.

Held equal per phase: the protected fraction (1.0), the empty
unprotected list, the site -> {(k, n)} map, the plan bijection,
``flash_consistent``, and the protected, allowlisted and
known-unprotected FLOPs.  One difference is asserted exactly, with its
cause: the SSD scan's ``ssm_scan`` FLOPs (``_ssm_gap``).  FLOP counts are
exact integers, held with ``==``.
"""

import json
import os
import sys

import jax
import jax.extend as jex
import pytest
import torch

from repro.analysis import audit as ref_audit
from repro.analysis import jaxpr_walk
from repro.analysis.crosscheck import traced_sites as ref_traced_sites
from repro_torch.analysis.audit import (
    _audit_abft,
    _zero_params,
    audit_config,
    classify,
    trace_decode,
)
from repro_torch.analysis.crosscheck import traced_sites
from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.hardware import TPU_V5E
from repro_torch.launch.audit import to_payload
from repro_torch.models.model import Model, layer_tags

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 2, 8          # the audits' example batch (both packages)


def _sub_jaxprs(eqn):
    """``jaxpr_walk._sub_jaxprs`` reading ``jax.extend.core``'s types."""
    subs = []
    for v in eqn.params.values():
        vals = v if isinstance(v, (tuple, list)) else (v,)
        for item in vals:
            if isinstance(item, jex.core.ClosedJaxpr):
                subs.append(item.jaxpr)
            elif isinstance(item, jex.core.Jaxpr):
                subs.append(item)
    return subs


@pytest.fixture(scope="module")
def reports():
    """(reference report, port report) per arch, each audit run once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jaxpr_walk, "_sub_jaxprs", _sub_jaxprs)
                ref = ref_audit.audit_config(arch, "mixed")
            port = audit_config(arch, "mixed", hardware=TPU_V5E,
                                device="cpu")
            cache[arch] = (ref, port)
        return cache[arch]

    return get


def _ssm_gap(arch: str, phase: str) -> float:
    """Reference minus port ``ssm_scan`` FLOPs.  The reference writes the
    SSD scan's three-operand einsums and the decode step's conv window
    and state update as einsums, which JAX lowers to pairwise
    ``dot_general``s, its elementwise factors included as contractions of
    depth 1 (and the conv window as one of depth W).  The port computes
    those factors elementwise (``models/mamba.py``), which carries no
    FLOP-carrying op, and contracts only the true sums.  Per Mamba2
    layer, at batch B:

    * prefill (one chunk, Q = L = seq): ``scores * L_mat`` (B Q Q H),
      ``decay_out * xdt`` and ``exp(cs) * y_off`` (B Q H P each):
      2 B Q H (Q + 2 P);
    * decode: the conv windows (B W (d_inner + 2 N)), ``dt * B`` (B H N)
      and ``(dt B) * x`` (B H P N): 2 B (W (d_inner + 2 N) + H N + H P N).
    """
    cfg = scaled_down(get_config(arch))
    n_mamba = sum(t.startswith("mamba") for t in layer_tags(cfg))
    B, Q = BATCH, min(cfg.ssm_chunk, SEQ)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    pre = 2 * B * Q * H * (Q + 2 * P)
    dec = 2 * B * (cfg.ssm_conv_width * (cfg.d_inner + 2 * N) + H * N
                   + H * P * N)
    per_layer = {"prefill": pre, "decode": dec, "mixed": pre + dec}[phase]
    return float(n_mamba * per_layer)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_fraction_bijection_and_flash_match_the_reference(arch, reports):
    ref, port = reports(arch)
    assert ref.protected_fraction == port.protected_fraction == 1.0
    assert set(port.phases) == set(ref.phases) == {"prefill", "decode",
                                                   "mixed"}
    for ph in ref.phases:
        assert port.phases[ph].unprotected_ops == ()
        assert ref.phases[ph].unprotected_ops == ()
    assert ref.crosscheck.bijective and port.crosscheck.bijective
    assert port.crosscheck.matched == ref.crosscheck.matched
    assert port.flash_consistent == ref.flash_consistent


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_site_classes_match_the_reference(arch, reports):
    """Per phase, the executed site -> {(k, n)} map is the reference's."""
    ref, port = reports(arch)
    for ph in ref.phases:
        want = ref_traced_sites([c.op for c in ref.phases[ph].ops])
        got = traced_sites([c.op for c in port.phases[ph].ops])
        assert got == want, ph


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_flops_by_class_match_the_reference(arch, reports):
    """Protected, allowlisted and known-gap FLOPs equal the reference's
    per phase; ``ssm_scan`` differs by exactly ``_ssm_gap``."""
    ref, port = reports(arch)
    for ph in ref.phases:
        r, p = ref.phases[ph], port.phases[ph]
        assert p.protected_flops == r.protected_flops, ph
        assert p.allowlisted_flops == r.allowlisted_flops, ph
        want = dict(r.known_unprotected)
        if "ssm_scan" in want:
            want["ssm_scan"] -= _ssm_gap(arch, ph)
        assert p.known_unprotected == want, ph
        assert p.kernel_flops == 0.0, ph          # flash off: no K2/K3


def _by_class(classified, in_layers) -> dict:
    """FLOPs by (status, kind, site) over the ops ``in_layers`` keeps."""
    out: dict = {}
    for c in classified:
        if in_layers(c.op):
            key = (c.status, c.kind, c.site)
            out[key] = out.get(key, 0.0) + c.op.flops
    return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "jamba-v0.1-52b"])
def test_per_layer_totals_equal_the_scan_multiplied_ones(arch):
    """The reference traces one scanned layer body and multiplies its
    FLOPs by the trip count (``repeats``); the port runs every layer and
    records each once, under ``layer[i]``.  Over a decode step, the
    port's layers summed equal the reference's multiplied bodies, class
    by class and site by site (``ssm_scan`` short by ``_ssm_gap``)."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import scaled_down as ref_scaled_down
    from repro.models import build_model

    ref_model = build_model(ref_scaled_down(ref_get_config(arch)))
    params = ref_audit._zero_params(ref_model, jax.numpy.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxpr_walk, "_sub_jaxprs", _sub_jaxprs)
        ref_ops = ref_audit.trace_decode(ref_model, params,
                                         ref_audit._audit_abft())
    assert any(op.repeats > 1 for op in ref_ops)
    model = Model(scaled_down(get_config(arch)))
    port_ops = trace_decode(model, _zero_params(model, torch.float32, CPU),
                            _audit_abft(hardware=TPU_V5E), device=CPU)
    assert all(op.repeats == 1 for op in port_ops)
    want = _by_class(ref_audit.classify(ref_ops), lambda op: "scan[" in
                     op.path)
    got = _by_class(classify(port_ops), lambda op: "layer[" in op.path)
    gap = _ssm_gap(arch, "decode")
    if gap:
        got[("known_unprotected", "ssm_scan", None)] += gap
    assert got == want


def test_port_json_covers_the_committed_audit():
    """Every key path of the committed ``AUDIT_coverage.json`` is in the
    port's JSON of all ten configs, apart from the reference checker's
    conditional keys, and the checker's invariants hold
    (``benchmarks/check_audit_schema.py``, run as a library)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    try:
        import check_audit_schema
    finally:
        sys.path.pop(0)
    reps = {arch: audit_config(arch, "mixed", hardware=TPU_V5E,
                               device="cpu") for arch in ALL_ARCHS}
    payload = json.loads(json.dumps(to_payload(reps, "mixed")))
    with open(os.path.join(ROOT, "AUDIT_coverage.json")) as fh:
        baseline = json.load(fh)
    assert check_audit_schema.check(payload, baseline) == []
    assert set(payload["configs"]) == set(baseline["configs"])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_live_reference_reproduces_the_committed_audit(arch, reports):
    """With the one-function replacement, the reference's live audit
    equals its committed ``AUDIT_coverage.json`` per phase: op count,
    protected, allowlisted and known-gap FLOPs, fraction and bijection —
    so the parity above is against the numbers the reference published."""
    with open(os.path.join(ROOT, "AUDIT_coverage.json")) as fh:
        committed = json.load(fh)["configs"][arch]
    live = json.loads(json.dumps(reports(arch)[0].to_json()))
    for ph, cov in committed["phases"].items():
        got = live["phases"][ph]
        for key in ("n_ops", "protected_flops", "allowlisted_flops",
                    "known_unprotected", "protected_fraction"):
            assert got[key] == cov[key], (ph, key)
    assert live["crosscheck"] == committed["crosscheck"]
    assert live["flash_consistent"] == committed["flash_consistent"]
