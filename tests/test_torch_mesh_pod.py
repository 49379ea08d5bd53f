"""The ``pod`` axis and the default head padding on the CPU.

A ``(pod, data, model)`` mesh lays ``pod`` out as the reference's
specs do: the batch splits over ``pod`` x ``data``
(``src/repro/distributed/sharding.py:26``), while FSDP weights, ZeRO-1
moments and a sequence-sharded cache split over ``data`` alone
(``:79,155-158,192-198``).  One spawn of four gloo ranks
(``repro_torch.distributed.spawn``; workers in
``tests/test_torch_pod_worker.py``) runs every scenario, while this
process runs the one-process twins and the walks:

* serving scaled-down llama3.2-1b (bf16) at (pod=2, data=1, model=2)
  equals the (data=2, model=2) run of the same seed bit for bit (a rank
  computes the same thing: its two slots, its model shard), a decode
  fault on logical row 3 (pod rank 1's row 1) included;
* one slot at (2, 2, 1): the cache's positions split over ``data``, its
  group the data line, each pod a replica, the streams those of the
  (data=2, model=1) run;
* training llama (f32) at (2, 2, 1), ZeRO-1 and FSDP: losses and grad
  norms within ``tests/test_torch_mesh_train.py``'s 1e-5 of the
  one-process twin; the ZeRO, FSDP and batch groups are the data line,
  the data line and the whole grid, the pod group the pod line;
* a pod cell's dry-run walk equals the single-pod cell's where a rank
  sees the same batch (prefill and decode op for op, train FLOPs);
* head padding by default: a 6-head stack served at model = 4 (padded
  to 8 / 8 by ``executor.layout_config``) equals an explicit
  ``pad_heads_to=8`` run bit for bit and the unpadded local run's
  streams; scaled whisper-tiny (6 / 6 heads) trained at (1, 4) equals
  the explicit run bit for bit and the one-process twin within 1e-5;
  the plan stays at logical heads (its rows equal the reference's), and
  the nine padded dry-run cells' ``model_flops`` equal the reference's.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import test_torch_mesh_worker as W
import test_torch_pod_worker as PW
import torch

from repro.configs import get_config as jget
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import ProtectionPlan as JPlan
from repro.models.counting import model_flops as jmodel_flops
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import ProtectionPlan
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import virtual_mesh
from repro_torch.launch import dryrun
from repro_torch.models.counting import count_params, model_flops
from repro_torch.models.model import Model
from repro_torch.roofline.analysis import analyze_step
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.executor import layout_config

torch.set_num_threads(1)

# the dry run's nine cells whose heads the rules would split at model=16
PADDED_ARCHS = {"qwen3-14b": (48, 8), "qwen1.5-32b": (48, 48),
                "whisper-tiny": (16, 16)}
SCALED = {"train_4k": dict(kind="train", seq=32, batch=4),
          "prefill_32k": dict(kind="prefill", seq=64, batch=4),
          "decode_32k": dict(kind="decode", seq=64, batch=4)}


@pytest.fixture(scope="module")
def setup():
    small = W.small_config()
    llama_bf16 = Model(small).init_params(0, dtype=torch.bfloat16)
    llama_f32 = Model(small).init_params(0, dtype=torch.float32)
    pad = Model(PW.pad_config()).init_params(0, dtype=torch.bfloat16)
    whisper = Model(PW.whisper_config()).init_params(0, dtype=torch.float32)
    thr = count_params(small) - 1
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn.run, PW.pod_rank, 4, llama_bf16, llama_f32, pad,
                      whisper, thr, device="cpu")
    yield {"fut": fut, "llama_f32": llama_f32, "pad": pad,
           "whisper": whisper}
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def twins(setup):
    """The one-process runs, while the ranks run."""
    base = PW.pad_config()
    eng = ServeEngine(Model(base), setup["pad"], slots=3, max_len=64,
                      dtype=torch.bfloat16, device="cpu")
    rs = W.reqs(base, n=4, seed=1, new_tokens=5)
    return {
        "train": PW.train_run(W.small_config(), setup["llama_f32"], None,
                              PW.llama_batches()),
        "whisper": PW.train_run(PW.whisper_config(), setup["whisper"], None,
                                PW.whisper_batches()),
        "pad_serve": W._record(eng, rs, eng.run(rs)),
    }


@pytest.fixture(scope="module")
def ranks(setup, twins):
    return setup["fut"].result()


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("name", PW.SERVE_NAMES)
def test_pod_serving_equals_2x2_bit_for_bit(ranks, name):
    for r, rec in enumerate(ranks):
        assert rec["servepod"][name] == rec["serve22"][name], (r, name)
        assert rec["servepod"][name] == ranks[0]["servepod"][name]


def test_pod_splits_the_slots_over_the_batch(ranks):
    """Four slots over pod x data = 2 x 1: pod rank p holds and decodes
    slots 2p and 2p + 1; its batch group is its pod line (the ranks of
    its model index), and at data = 1 it has no data group."""
    for r, rec in enumerate(ranks):
        c = rec["coords"]["pod"]
        assert rec["pod_layout"] == {"rows": [2 * c["pod"], 2],
                                     "kv_rows": 2,
                                     "bp": [c["model"], 2 + c["model"]],
                                     "dp": []}, r


def test_decode_fault_on_pod_rank_1_is_recovered(ranks):
    st = ranks[0]["servepod"]["fault"]["stats"]
    assert st["faults_detected"] >= 2 and st["hard_faults"] == 0
    assert ranks[0]["servepod"]["fault"]["streams"] == \
        ranks[0]["servepod"]["paged"]["streams"]
    assert ranks[0]["servepod"]["sped"]["stats"]["draft_accepted"] > 0


def test_sequence_shard_spans_data_only(ranks):
    """One slot at (2, 2, 1): the cache's 64 positions split over
    ``data`` (data rank d its [32 d, 32 d + 32)), the group the data line
    (its pod's two ranks); every rank's streams are the (2, 1) run's."""
    want = ranks[0]["seq21"]
    for r, rec in enumerate(ranks):
        c = rec["coords"]["train"]
        assert rec["seq"]["split"] == ["seq", 32 * c["data"], 32], r
        assert rec["seq"]["dp"] == [2 * c["pod"], 2 * c["pod"] + 1], r
        assert rec["seq"]["record"] == want, r
    assert ranks[1]["seq21"] == want


# ------------------------------------------------------------ training
@pytest.mark.parametrize("name", ["train", "train_fsdp"])
def test_pod_training_matches_the_one_process_twin(ranks, twins, name):
    want = twins["train"]
    for rec in ranks:
        got = rec[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)
        assert not any(got["flag"])
    if name == "train":
        # model = 1 and no FSDP: every rank holds the whole params
        for rec in ranks:
            for k, a in twins["train"]["params"].items():
                np.testing.assert_allclose(rec[name]["params"][k], a,
                                           rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["train", "train_fsdp"])
def test_pod_training_groups_span_data_only(ranks, twins, name):
    """ZeRO-1 (and FSDP) over ``data`` alone: the data group is the
    rank's pod's data line, each moment half its leaf along one dim; the
    batch group spans the grid, the pod group the pod line."""
    full = twins["train"]["mu_shapes"]
    for rec in ranks:
        c, got = rec["coords"]["train"], rec[name]
        assert got["groups"] == {"dp": [2 * c["pod"], 2 * c["pod"] + 1],
                                 "bp": [0, 1, 2, 3],
                                 "pp": [c["data"], 2 + c["data"]]}
        for k, shape in got["mu_shapes"].items():
            assert np.prod(shape) * 2 == np.prod(full[k]) or \
                np.prod(full[k]) == shape[0] == 1 or shape == full[k], k
        assert sum(np.prod(s) * 2 == np.prod(full[k])
                   for k, s in got["mu_shapes"].items()) > 0
    assert (ranks[0][name]["fsdp"] != []) == (name == "train_fsdp")


# ------------------------------------------------------------ dry-run walks
@pytest.mark.parametrize("shape", list(SCALED))
def test_pod_walk_equals_the_single_pod_walk(monkeypatch, shape):
    """Scaled llama at (pod=2, data=1, model=2) against (data=2,
    model=2): a rank sees the same two rows, so prefill and decode walk
    the same ops with the same costs, and a train step the same FLOPs
    (its optimizer runs whole leaves where (2, 2)'s ZeRO-1 runs halves)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: scaled_down(get_config(a)))
    monkeypatch.setattr(dryrun, "SHAPES", dict(SCALED))
    monkeypatch.setitem(dryrun.VARIANT, "abft", "off")
    walks = []
    for mesh in (virtual_mesh(data=2, model=2),
                 virtual_mesh(pod=2, data=1, model=2)):
        fn, args, _ = dryrun.build_cell("llama3.2-1b", shape, mesh)
        rec, ops = analyze_step(fn, args, entry=shape)
        walks.append((rec["flops_per_device"],
                      [(o.kind, o.geometry, o.flops, o.bytes, o.payload)
                       for o in ops]))
    (f22, ops22), (fpod, opspod) = walks
    assert f22 == fpod > 0
    if shape != "train_4k":
        assert ops22 == opspod
    else:
        assert [o for o in ops22 if o[2]] == [o for o in opspod if o[2]]


# ------------------------------------------------------------ head padding
def test_default_padding_serves_bit_equal_to_explicit(ranks, twins):
    for rec in ranks:
        got = rec["pad_serve"]
        assert got["default"] == got["explicit"]
        assert got["default"]["heads"] == [8, 8]
        assert got["default"]["wq"][1] == 8 * 16 // 4
        assert got["default"]["stats"]["faults_detected"] >= 1
        assert got["default"]["streams"] == twins["pad_serve"]["streams"]


def test_default_padding_trains_bit_equal_to_explicit(ranks, twins):
    want = twins["whisper"]
    for rec in ranks:
        d, e = rec["pad_train"]["default"], rec["pad_train"]["explicit"]
        assert d["loss"] == e["loss"] and d["grad_norm"] == e["grad_norm"]
        for k in e["params"]:
            assert np.array_equal(d["params"][k], e["params"][k]), k
        assert d["wq"][1] == 8 * 16 // 4
        np.testing.assert_allclose(d["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(d["grad_norm"], want["grad_norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("k,arch,want", [
    (16, "qwen3-14b", (48, 8)), (16, "qwen1.5-32b", (48, 48)),
    (16, "whisper-tiny", (16, 16)), (4, "whisper-tiny", (8, 8)),
    (16, "llama3.2-1b", (0, 0)), (16, "deepseek-v3-671b", (0, 0))])
def test_layout_config_pads_to_the_least_counts(k, arch, want):
    """Where the rules would split a q head (or kv heads neither divide
    the axis nor are divided by it) the heads pad to the least counts
    that fit, kv-major; elsewhere, and under an explicit padding, the
    config comes back as it is."""
    cfg = get_config(arch)
    mesh = virtual_mesh(data=1, model=k)
    got = layout_config(cfg, mesh)
    assert (got.pad_heads_to, got.pad_kv_heads_to) == want
    assert (got is cfg) == (want == (0, 0))
    mine = dataclasses.replace(cfg, pad_heads_to=cfg.n_heads + 2)
    assert layout_config(mine, mesh) is mine


@pytest.mark.parametrize("arch", list(PADDED_ARCHS))
def test_padded_plan_and_model_flops_stay_logical(arch):
    """The plan of a padded cell counts the logical heads (the reference
    caveat), so its rows equal the reference's at model = 16 string for
    string; each of the nine cells' ``model_flops`` equals the
    reference's."""
    mesh = virtual_mesh(data=16, model=16)
    cfg = layout_config(get_config(arch), mesh)
    assert (cfg.pad_heads_to, cfg.pad_kv_heads_to) == PADDED_ARCHS[arch]
    for n in (1, 8):
        ours = ProtectionPlan.for_model(cfg, hw=TPU_V5E, n_tokens=n,
                                        model_parallel=16).report_rows()
        theirs = JPlan.for_model(jget(arch), hw=JTPU, n_tokens=n,
                                 model_parallel=16).report_rows()
        assert json.dumps(ours, sort_keys=True) == \
            json.dumps(theirs, sort_keys=True)
    for shape, spec in dryrun.SHAPES.items():
        if dryrun.skip_reason(arch, shape):
            continue
        tokens = spec["batch"] * (1 if spec["kind"] == "decode"
                                  else spec["seq"])
        train = spec["kind"] == "train"
        assert model_flops(cfg, tokens, train) == \
            jmodel_flops(jget(arch), tokens, train)


@pytest.mark.parametrize("arch", list(PADDED_ARCHS))
def test_full_width_padded_decode_walks(tmp_path, arch):
    """decode_32k of each padded config at (16, 16) on the meta device:
    walked, its q heads 48 (16) over 16 ranks, so K3 runs 3 (1) heads a
    rank."""
    rec = dryrun.run_cell(arch, "decode_32k", "single", tmp_path,
                          force=True)
    assert rec["status"] == "ok", rec.get("error") or rec.get("reason")
    from repro_torch.roofline.reanalyze import load_ops

    ops = load_ops(tmp_path / f"{arch}__decode_32k__single.ops.jsonl.gz")
    k3 = [o for o in ops if o.kind == "K3"]
    assert k3 and k3[0].geometry[0] == 8 * PADDED_ARCHS[arch][0] // 16
