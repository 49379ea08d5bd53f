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
