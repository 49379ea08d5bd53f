"""The port's serving CLI on the CPU with the campaign, adaptive,
sampling and telemetry flags: it writes a plan, a metrics artifact and a
Perfetto trace, and the artifact passes the reference's own schema gate
(``benchmarks/check_telemetry_schema.py``, imported unchanged)."""

import importlib.util
import json
import os

import pytest
import torch

from repro.core.policy import ProtectionPlan as JPlan
from repro_torch.core.policy import ProtectionPlan
from repro_torch.launch import serve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry_schema",
        os.path.join(ROOT, "benchmarks", "check_telemetry_schema.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats_line(out: str) -> dict:
    return next(json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{"))


@pytest.mark.parametrize("flags", [
    ["--fault-rate", "0.4", "--adaptive", "--escalate-threshold", "0.02"],
    ["--fault-rate", "0.3", "--fault-kind", "permanent",
     "--fault-duration", "2", "--cache", "paged", "--temperature", "0.8",
     "--top-k", "20"],
    ["--fault-rate", "0.5", "--fault-magnitude", "0", "--abft", "off"],
], ids=["adaptive", "permanent_sampled_paged", "bitflip_off"])
def test_serve_cli_writes_plan_metrics_and_trace(tmp_path, capsys, flags):
    plan, metrics, trace = (str(tmp_path / n) for n in
                            ("plan.json", "metrics.json", "trace.json"))
    rc = serve.main(["--device", "cpu", "--requests", "3",
                     "--new-tokens", "4", "--slots", "2",
                     "--plan-out", plan, "--metrics-out", metrics,
                     "--trace-out", trace] + flags)
    assert rc == 0
    line = _stats_line(capsys.readouterr().out)
    camp = line["campaign"]
    assert camp["faults_injected"] == (
        camp["faults_corrected"] + camp["faults_uncorrected"]
        + camp["sdc_faults"] + camp["masked_faults"])
    assert len(camp["schedule"]) >= camp["faults_injected"] > 0
    if "--adaptive" in flags:
        assert line["protection_escalations"] >= 1
    with open(plan) as fh:
        text = fh.read()
    assert ProtectionPlan.from_json(text).to_json() == text
    JPlan.from_json(text)                     # the reference accepts it
    with open(metrics) as fh:
        doc = json.load(fh)
    with open(trace) as fh:
        tdoc = json.load(fh)
    assert doc["counters_match_stats"] is True
    assert _checker().check(doc, tdoc) == []
    names = {e["name"] for e in tdoc["traceEvents"]}
    assert {"admit", "decode_step", "abft_check", "plan_row",
            "fault_injected"} <= names


def test_serve_cli_log_events_streams_json_lines(capsys):
    rc = serve.main(["--device", "cpu", "--requests", "2",
                     "--new-tokens", "8", "--log-events",
                     "--inject-faults"])
    assert rc == 0
    err = capsys.readouterr().err.splitlines()
    events = [json.loads(ln) for ln in err if ln.startswith("{")]
    assert events and {"fault_detected", "abft_retry"} <= {
        e["name"] for e in events}


@pytest.mark.parametrize("arch", ["qwen3-14b", "stablelm-1.6b",
                                  "qwen1.5-32b"])
def test_serve_cli_runs_the_dense_family(capsys, arch):
    """``--arch`` takes the dense family (scaled down by ``--scale
    smoke``), paged, flash on, with an injected fault recovered."""
    rc = serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                     "--new-tokens", "5", "--slots", "2", "--cache",
                     "paged", "--flash-attention", "--inject-faults"])
    assert rc == 0
    line = _stats_line(capsys.readouterr().out)
    assert line["tokens"] == 15 and line["errors"] == {}
    assert line["faults_detected"] == line["retries"] == 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b",
                                  "whisper-tiny"])
def test_cli_refuses_an_unported_arch_with_its_message(capsys, arch):
    """Every registered config is an ``--arch`` choice: whisper, whose
    memory (audio) neither the engine nor the training data passes, exits
    with a message naming its memory inputs, as the reference's CLIs
    cannot serve or train it; the SSM family serves and trains at smoke
    scale."""
    from repro_torch.launch import train

    args = {serve.main: ["--requests", "2", "--new-tokens", "3"],
            train.main: ["--steps", "1", "--batch", "1", "--seq", "8"]}
    for main, extra in args.items():
        argv = ["--device", "cpu", "--arch", arch]
        if arch == "whisper-tiny":
            with pytest.raises(SystemExit) as exc:
                main(argv + extra)
            msg = str(exc.value)
            assert "per-request memory (audio or enc_input)" in msg, msg
        else:
            assert main(argv + extra) == 0
    if arch != "whisper-tiny":
        assert _stats_line(capsys.readouterr().out)["tokens"] == 6


@pytest.mark.parametrize("flags", [
    ["--cache", "paged", "--prefix-sharing"],
    ["--chunk-tokens", "8"],
    ["--chunk-tokens", "auto", "--cache", "paged", "--prefix-sharing",
     "--inject-faults"],
], ids=["prefix_sharing", "chunk_8", "chunk_auto_shared_fault"])
def test_serve_cli_prefix_sharing_and_chunked_prefill(tmp_path, capsys,
                                                      flags):
    """``--prefix-sharing`` and ``--chunk-tokens N|auto`` on the CPU: the
    same tokens as the plain run, the chunk spans and counters, and a
    metrics artifact and trace that pass the reference's schema gate."""
    metrics, trace = (str(tmp_path / n) for n in ("m.json", "t.json"))
    base = ["--device", "cpu", "--requests", "4", "--new-tokens", "5",
            "--slots", "2"]
    assert serve.main(base) == 0
    plain = _stats_line(capsys.readouterr().out)
    assert serve.main(base + ["--metrics-out", metrics, "--trace-out",
                              trace] + flags) == 0
    line = _stats_line(capsys.readouterr().out)
    assert line["tokens"] == plain["tokens"] == 20
    assert line["errors"] == {}
    chunked = "--chunk-tokens" in flags
    assert (line["prefill_chunks"] > 0) == chunked
    assert isinstance(line["chunk_tokens"], int) == chunked
    if "--inject-faults" in flags:
        assert line["faults_detected"] == line["retries"] == 1
    with open(metrics) as fh:
        doc = json.load(fh)
    with open(trace) as fh:
        tdoc = json.load(fh)
    assert doc["counters_match_stats"] is True
    assert _checker().check(doc, tdoc) == []
    names = {e["name"] for e in tdoc["traceEvents"]}
    assert ("prefill_chunk" in names) == chunked


@pytest.mark.parametrize("flags", [
    ["--spec-decode", "ngram"],
    ["--spec-decode", "ngram", "--draft-len", "3", "--cache", "paged",
     "--inject-faults"],
    ["--spec-decode", "self-draft", "--draft-len", "auto",
     "--draft-model", "2@16"],
], ids=["ngram_auto", "ngram_3_paged_fault", "self_draft_2at16"])
def test_serve_cli_speculative_decoding(tmp_path, capsys, flags):
    """``--spec-decode ngram|self-draft`` with ``--draft-len 3|auto`` and
    ``--draft-model 2@16`` on the CPU: the same token count as the plain
    run, no error, the ``spec_decode`` block of the stats line (and none
    without the flag), a recovered verify fault, and a metrics artifact
    and trace that pass the reference's schema gate."""
    metrics, trace = (str(tmp_path / n) for n in ("m.json", "t.json"))
    base = ["--device", "cpu", "--requests", "4", "--new-tokens", "6",
            "--slots", "2"]
    assert serve.main(base) == 0
    plain = _stats_line(capsys.readouterr().out)
    assert plain["spec_decode"] is None
    assert serve.main(base + ["--metrics-out", metrics, "--trace-out",
                              trace] + flags) == 0
    line = _stats_line(capsys.readouterr().out)
    assert line["tokens"] == plain["tokens"] == 24 and line["errors"] == {}
    spec = line["spec_decode"]
    assert spec["proposer"] == flags[1].replace("-", "_")
    assert spec["draft_len"] == (3 if "3" in flags else spec["draft_len"])
    assert spec["draft_len"] >= 1
    assert 0 <= spec["draft_accepted"] <= spec["draft_proposed"]
    if spec["draft_proposed"]:
        assert spec["accept_rate"] == pytest.approx(
            spec["draft_accepted"] / spec["draft_proposed"])
    if "--inject-faults" in flags:
        assert line["faults_detected"] == spec["verify_retries"] == 1
    with open(metrics) as fh:
        doc = json.load(fh)
    with open(trace) as fh:
        tdoc = json.load(fh)
    assert doc["counters_match_stats"] is True
    assert _checker().check(doc, tdoc) == []
    assert "verify_step" in {e["name"] for e in tdoc["traceEvents"]}


def test_serve_cli_draft_model_needs_self_draft(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--spec-decode", "ngram",
                    "--draft-model", "2@16"])
    assert "--draft-model requires" in capsys.readouterr().err
