"""The port's protection-coverage auditor (``repro_torch.analysis``) on
its own: the op walker and its FLOP geometry, the marker protocol, the
kernels' single records, classification, the plan crosscheck, the audits
of llama and whisper, the engine left as an un-audited run leaves it, and
the CLI.  The reference's counterparts are in
``tests/test_coverage_audit.py``; the per-config parity against the
reference's live audit is ``tests/test_torch_audit_parity.py``.

FLOP counts are exact integers held with ``==``.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import markers
from repro_torch.analysis.audit import (
    KNOWN_GAP_NOTES,
    _audit_abft,
    _zero_params,
    audit_config,
    chunk_engine,
    classify,
    kernel_records,
    resolve_arch,
    trace_decode,
    trace_prefill,
    verify_engine,
)
from repro_torch.analysis.crosscheck import crosscheck_plan
from repro_torch.analysis.op_walk import OpWalker, flop_ops
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import FixedPolicy
from repro_torch.core.protected import ABFTConfig, protected_matmul
from repro_torch.core.schemes import Scheme
from repro_torch.kernels import flash_ops, ops
from repro_torch.kernels.ref import abft_matmul_ref
from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------------- op walker

def test_unmarked_product_detected_with_path_and_flops():
    """A deliberately unmarked product next to a protected one is
    classified unprotected, with its path and exact FLOP count; the
    protected call is one K1 record under its site."""
    abft = ABFTConfig(policy=FixedPolicy(Scheme.BLOCK_1S))
    rng = np.random.default_rng(0)
    x, w1, w2 = _rand(rng, 4, 16), _rand(rng, 16, 32), _rand(rng, 32, 8)

    def fn():
        y, _ = protected_matmul(x, w1, abft, out_dtype=torch.float32,
                                site="toy.protected")
        return y @ w2                      # the drift this auditor catches

    ops_ = classify(flop_ops(fn, entry="toy"))
    bad = [c for c in ops_ if c.status == "unprotected"]
    assert len(bad) == 1
    assert bad[0].op.primitive == "mm"
    assert bad[0].op.flops == 2.0 * 4 * 32 * 8
    assert bad[0].op.path == "toy/mm"
    good = [c for c in ops_ if c.status == "protected"]
    assert [c.op.primitive for c in good] == ["K1"]
    assert {c.site for c in good} == {"toy.protected"}
    assert good[0].scheme == "block_1s"
    assert good[0].op.flops == 2.0 * 4 * 16 * 32 + 4.0 * 4 * 16


def test_global_scheme_records_product_and_both_checks():
    """``global`` runs a plain product and two rank-1 check contractions
    (the reference's einsums), all under the site's marker."""
    abft = ABFTConfig(policy=FixedPolicy(Scheme.GLOBAL))
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 2, 3, 16), _rand(rng, 16, 24)
    got = classify(flop_ops(lambda: protected_matmul(x, w, abft,
                                                     site="s")))
    assert [c.status for c in got] == ["protected"] * 3
    assert [(c.op.m, c.op.k, c.op.n) for c in got] == [
        (6, 16, 24), (6, 16, 1), (6, 16, 1)]
    assert sum(c.op.flops for c in got) == 2.0 * 6 * 16 * 24 + 4.0 * 6 * 16


def test_walker_geometry_of_every_flop_op():
    """Batch folds into m; a convolution's m is batch x out positions, k
    in-channels-per-group x kernel, n out channels (the reference's
    ``_conv_geometry``)."""
    rng = np.random.default_rng(2)
    a, b = _rand(rng, 3, 4, 5), _rand(rng, 3, 5, 6)
    x, w = _rand(rng, 2, 8, 10), _rand(rng, 6, 4, 3)
    v = _rand(rng, 5)

    def fn():
        torch.bmm(a, b)
        torch.addmm(torch.zeros(6), a[0].t().contiguous()[:4, :4],
                    _rand(rng, 4, 6))
        torch.mv(a[0], v)
        torch.dot(v, v)
        torch.nn.functional.conv1d(x, w, stride=2, groups=2)

    got = {op.primitive: (op.m, op.k, op.n, op.flops)
           for op in flop_ops(fn)}
    assert got["bmm"] == (12, 5, 6, 2.0 * 12 * 5 * 6)
    assert got["addmm"] == (4, 4, 6, 2.0 * 4 * 4 * 6)
    assert got["mv"] == (4, 5, 1, 2.0 * 4 * 5)
    assert got["dot"] == (1, 5, 1, 10.0)
    out_len = (10 - 3) // 2 + 1
    assert got["convolution"] == (2 * out_len, 4 * 3, 6,
                                  2.0 * 2 * out_len * 12 * 6)


def test_layer_paths_and_one_op_set_per_layer():
    """The port has no scan: each layer's ops appear once under
    ``layer[i]``, every layer alike, and ``repeats`` stays 1."""
    cfg = scaled_down(get_config("llama3.2-1b"))
    model = Model(cfg)
    params = _zero_params(model, torch.float32, CPU)
    got = trace_decode(model, params, _audit_abft(), device=CPU)
    by_layer = {}
    for op in got:
        by_layer.setdefault(op.path.split("/")[1], []).append(
            (op.primitive, op.flops))
    layers = [f"layer[{i}]" for i in range(cfg.n_layers)]
    assert set(by_layer) == set(layers) | {"K1"}      # the head
    assert all(by_layer[name] == by_layer[layers[0]] for name in layers)
    assert all(op.repeats == 1 for op in got)


# ---------------------------------------------------------------- markers

def test_no_marker_pushed_without_a_walker():
    """Every scope opener returns the one shared no-op context while no
    walker records, and a served step leaves the stack empty."""
    assert markers._WALKERS == []
    assert markers.protection_scope("block_1s", "attn.q") is markers._NULL
    assert markers.coverage_scope("softmax") is markers._NULL
    assert markers.kernel_scope("K1", 1, 2, 3, 4.0) is markers._NULL
    assert markers.logical_scope("x", ((1, 2, 3),)) is markers._NULL
    assert markers.layer_scope("", 0) is markers._NULL
    with pytest.raises(ValueError, match="unknown coverage kind"):
        markers.coverage_scope("conv")
    cfg = scaled_down(get_config("llama3.2-1b"))
    model = Model(cfg)
    params = model.init_params(0, dtype=torch.float32)
    cache = model.init_cache(2, 16, torch.float32)
    with torch.no_grad():
        model.decode(params, torch.zeros((2, 1), dtype=torch.long), cache,
                     torch.zeros(2, dtype=torch.int32), LayerCtx())
    assert markers._STACK == [] and markers._WALKERS == []


def test_walker_state_restored_after_an_error():
    with pytest.raises(RuntimeError, match="boom"):
        with OpWalker():
            with markers.coverage_scope("softmax"):
                raise RuntimeError("boom")
    assert markers._STACK == [] and markers._WALKERS == []


def test_parse_name_stack_reads_every_family():
    m = markers.parse_name_stack(
        "layer[0]/flops[softmax]/abft[global][attn.q]/kernel[K1]")
    assert (m.scheme, m.site, m.kinds, m.kernel) == (
        "global", "attn.q", ("softmax",), "K1")
    assert m.protected
    assert not markers.parse_name_stack("flops[mla]").protected


# ------------------------------------------------------- kernel records

def test_k1_records_once_and_drops_the_plain_versions_ops():
    """One K1 call is one op of 2 m k n + 4 m k FLOPs (batched: experts
    folded into m), whatever the plain version ran inside: here its
    per-block einsums over operands padded to 128-multiples."""
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 5, 40), _rand(rng, 40, 24)
    inner = flop_ops(lambda: abft_matmul_ref(x, w, mode="1s", bm=8, bk=16,
                                             bn=24, out_dtype=torch.float32))
    assert len(inner) > 1                 # what the record hides
    for mode in ("1s", "2s", "replica"):
        got = flop_ops(lambda: ops.abft_matmul(x, w, mode=mode))
        assert [(o.primitive, o.m, o.k, o.n, o.flops) for o in got] == [
            ("K1", 5, 40, 24, 2.0 * 5 * 40 * 24 + 4.0 * 5 * 40)]
        assert markers.parse_name_stack(got[0].name_stack).kernel == "K1"
    xe, we = _rand(rng, 3, 4, 40), _rand(rng, 3, 40, 24)
    got = flop_ops(lambda: ops.abft_matmul_batched(xe, we))
    assert [(o.primitive, o.m, o.k, o.n, o.flops) for o in got] == [
        ("K1", 12, 40, 24, 2.0 * 12 * 40 * 24 + 4.0 * 12 * 40)]


def test_k2_k3_record_once_with_score_and_pv_flops():
    rng = np.random.default_rng(4)
    B, L, H, KV, D = 2, 16, 4, 2, 16
    q, k, v = _rand(rng, B, L, H, D), _rand(rng, B, L, KV, D), \
        _rand(rng, B, L, KV, D)
    got = flop_ops(lambda: flash_ops.flash_attention(q, k, v))
    assert [(o.primitive, o.m, o.k, o.n, o.flops) for o in got] == [
        ("K2", B * L * H, D, L, 2.0 * B * L * H * L * 2 * D)]
    S = 24
    kc, vc = _rand(rng, B, S, KV, D), _rand(rng, B, S, KV, D)
    got = flop_ops(lambda: flash_ops.flash_decode(q[:, :1], kc, vc,
                                                  torch.tensor([3, 9])))
    assert [(o.primitive, o.m, o.k, o.n, o.flops) for o in got] == [
        ("K3", B * H, D, S, 2.0 * B * H * S * 2 * D)]
    pool = _rand(rng, 6, 8, KV, D)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    got = flop_ops(lambda: flash_ops.flash_decode_paged(
        q[:, :1], pool, pool, tables, torch.tensor([5, 20])))
    assert [(o.primitive, o.m, o.k, o.n, o.flops) for o in got] == [
        ("K3", B * H, D, 24, 2.0 * B * H * 24 * 2 * D)]
    assert kernel_records(got) == {"K1": 0, "K2": 0, "K3": 1}


def test_flash_on_decode_is_kernel_not_allowlisted():
    """With flash on, decode attention is one K3 record a layer, classified
    ``kernel`` (before the softmax allowlist), and no allowlisted product
    is left: the allowlist is consistent."""
    cfg = scaled_down(get_config("llama3.2-1b"))
    model = Model(cfg)
    params = _zero_params(model, torch.float32, CPU)
    got = classify(trace_decode(model, params, _audit_abft(flash=True),
                                device=CPU))
    statuses = {c.status for c in got}
    assert statuses == {"protected", "kernel"}
    assert kernel_records([c.op for c in got])["K3"] == cfg.n_layers


# ------------------------------------------------------------ crosscheck

def test_crosscheck_catches_plan_drift():
    """Dropping a plan entry / renaming a site produces diff-style
    plan-only / trace-only lines, not a silent pass."""
    model = Model(scaled_down(get_config("llama3.2-1b")))
    params = _zero_params(model, torch.float32, CPU)
    got = trace_decode(model, params, _audit_abft(hardware=TPU_V5E),
                       device=CPU)
    plan = model.protection_plan(TPU_V5E)
    assert crosscheck_plan(plan, got, model="llama").bijective

    dropped = dataclasses.replace(plan, entries=plan.entries[1:])
    xc = crosscheck_plan(dropped, got, model="llama")
    assert not xc.bijective
    assert xc.trace_only == (plan.entries[0].layer.name,)
    assert plan.entries[0].layer.name in xc.report()

    e0 = plan.entries[0]
    renamed = dataclasses.replace(plan, entries=(
        dataclasses.replace(e0, layer=dataclasses.replace(
            e0.layer, name="ghost.site")),) + plan.entries[1:])
    xc = crosscheck_plan(renamed, got, model="llama")
    assert "ghost.site" in xc.plan_only
    assert "plan-only" in xc.report()

    e1 = plan.entries[1]
    resized = dataclasses.replace(plan, entries=(
        plan.entries[0], dataclasses.replace(e1, layer=dataclasses.replace(
            e1.layer, dims=dataclasses.replace(e1.layer.dims, k=7))),
    ) + plan.entries[2:])
    xc = crosscheck_plan(resized, got, model="llama")
    assert [name for name, _, _ in xc.dim_mismatches] == [e1.layer.name]
    assert "dims differ" in xc.report()


def test_resolve_arch_aliases_and_errors():
    assert resolve_arch("llama3.2-1b") == "llama3.2-1b"
    assert resolve_arch("llama3_2_1b") == "llama3.2-1b"
    assert resolve_arch("whisper_tiny") == "whisper-tiny"
    with pytest.raises(KeyError, match="unknown arch"):
        resolve_arch("gpt-5")


# ------------------------------------------------------------ full audits

def test_llama_mixed_audit_full_coverage():
    """The acceptance gate: llama3.2-1b at phase mixed is fully protected
    with a bijective plan and a consistent flash allowlist (alias spelling
    exercises resolve_arch), on the H100 plan and on the reference's."""
    for hw in (None, TPU_V5E):
        rep = audit_config("llama3_2_1b", phase="mixed", hardware=hw,
                           device="cpu")
        assert rep.protected_fraction == 1.0
        assert set(rep.phases) == {"prefill", "decode", "mixed"}
        assert all(not p.unprotected_ops for p in rep.phases.values())
        assert rep.crosscheck.bijective
        assert rep.flash_consistent is True
        # attention score/PV products are allowlisted, not silently absent
        assert rep.phases["mixed"].allowlisted_flops > 0


def test_model_audit_coverage_is_audit_model():
    model = Model(scaled_down(get_config("llama3.2-1b")))
    rep = model.audit_coverage("decode", hardware=TPU_V5E, device="cpu")
    ref = audit_config("llama3.2-1b", "decode", hardware=TPU_V5E,
                       device="cpu")
    assert rep.to_json() == ref.to_json()


def test_whisper_conv_stem_is_known_unprotected():
    """The conv frontend shows up as an explicit, annotated gap — not as
    a silent pass and not as an audit failure."""
    rep = audit_config("whisper_tiny", phase="prefill", check_flash=False,
                       device="cpu")
    assert rep.protected_fraction == 1.0
    gaps = rep.phases["prefill"].known_unprotected
    assert gaps.get("conv_stem", 0) > 0
    assert "5a" in KNOWN_GAP_NOTES["conv_stem"]
    payload = rep.to_json()
    note = (payload["phases"]["prefill"]["known_unprotected"]
            ["conv_stem"]["note"])
    assert "5a" in note and "conv" in note
    assert rep.flash_consistent is None


def _engine_state(eng):
    return (dataclasses.asdict(eng.stats), eng.pos.copy().tolist(),
            [{k: v.clone() for k, v in layer.items()} for layer in
             eng.cache])


@pytest.mark.parametrize("step", ["chunk", "verify"])
def test_audit_leaves_the_engine_as_an_unaudited_run(step):
    """The walker only observes: an engine stepped under it ends with the
    stats, cursors and cache cells of the same calls run un-audited."""
    model = Model(scaled_down(get_config("llama3.2-1b")))
    params = model.init_params(0, dtype=torch.float32)
    abft = _audit_abft(hardware=TPU_V5E)
    states = []
    for walk in (True, False):
        if step == "chunk":
            eng, rows = chunk_engine(model, params, abft, device=CPU)
            call = functools.partial(eng._run_prefill_chunk, rows, None)
        else:
            eng = verify_engine(model, params, abft, device=CPU)
            call = eng._verify_core
        if walk:
            assert flop_ops(call)
        else:
            call()
        states.append(_engine_state(eng))
    (s1, p1, c1), (s2, p2, c2) = states
    assert s1 == s2 and p1 == p2
    assert s1["prefill_chunks" if step == "chunk" else "draft_proposed"]
    for a, b in zip(c1, c2):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_mixed_phase_runs_the_engine_steps():
    """The mixed phase holds one ``_run_prefill_chunk`` of 2 x 8 tokens
    and one ``_verify_core`` of a 4-token window: its verify products run
    at 2 x 4 rows."""
    rep = audit_config("llama3.2-1b", "mixed", hardware=TPU_V5E,
                       device="cpu")
    entries = {c.op.path.split("/")[0] for c in rep.phases["mixed"].ops}
    assert entries == {"engine._run_prefill_chunk", "decode",
                       "engine._verify_core"}
    verify = [c.op for c in rep.phases["mixed"].ops
              if c.op.path.startswith("engine._verify_core")
              and c.status == "protected" and c.op.n > 1]
    assert {op.m for op in verify} == {8}
    chunk = [c.op for c in rep.phases["mixed"].ops
             if c.op.path.startswith("engine._run_prefill_chunk")
             and c.status == "protected" and c.op.n > 1
             and "lm_head" not in c.op.name_stack]
    assert {op.m for op in chunk} == {16}


def test_prefill_trace_feeds_memory_inputs():
    """whisper's and vision's prefill run their memory paths: the encoder
    and ``vision.proj`` sites are executed."""
    for arch, site in (("whisper-tiny", "enc.attn.q"),
                       ("llama-3.2-vision-11b", "vision.proj")):
        model = Model(scaled_down(get_config(arch)))
        params = _zero_params(model, torch.float32, CPU)
        got = trace_prefill(model, params, _audit_abft(), device=CPU)
        sites = {markers.parse_name_stack(o.name_stack).site for o in got}
        assert site in sites


# ------------------------------------------------------------------ the CLI

def test_audit_cli_json_and_exit_codes(tmp_path, capsys):
    from repro_torch.launch.audit import main

    out = tmp_path / "audit.json"
    rc = main(["--config", "llama3_2_1b", "--phase", "decode", "--device",
               "cpu", "--hardware", "tpu-v5e", "--fail-under", "1.0",
               "--json", str(out)])
    assert rc == 0
    payload = json.loads(out.read_text())
    assert payload["schema"] == "repro/audit_coverage/v1"
    assert payload["phase"] == "decode"
    rep = payload["configs"]["llama3.2-1b"]
    assert rep["protected_fraction"] == 1.0
    assert rep["crosscheck"]["bijective"]
    assert "coverage audit: llama3.2-1b" in capsys.readouterr().out
    rc = main(["--config", "llama3.2-1b", "--phase", "decode", "--device",
               "cpu", "--fail-under", "1.5"])
    assert rc == 1
    assert "FAIL llama3.2-1b: protected fraction" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--device", "cpu"])


def test_audit_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        audit_config("llama3.2-1b", "decode")


def test_fault_spec_untouched_by_records():
    """A faulted K1 call still records one op (the fault rides in the
    plain version the record hides)."""
    rng = np.random.default_rng(5)
    x, w = _rand(rng, 4, 32), _rand(rng, 32, 16)
    f = FaultSpec(enabled=True, row=1, col=2, bit=-1, delta=100.0)
    got = flop_ops(lambda: ops.abft_matmul(x, w, fault=f))
    assert [o.primitive for o in got] == ["K1"]
