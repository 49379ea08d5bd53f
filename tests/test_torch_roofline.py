"""The port's roofline tooling (``repro_torch.roofline``) on hand-counted
programs: the cost walk's FLOPs, bytes, collective payloads and live
peak, the kernels' declared records, the three terms against the
reference's ``roofline_terms``, the report tables string for string
against the reference's, a dry-run cell's round trip through
``reanalyze`` and ``profile``'s ranking.

Every count is an exact integer or float held with ``==``: the walk adds
the same products the test adds by hand.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro.roofline import report as jreport
from repro.roofline.analysis import roofline_terms as jroofline_terms
from repro_torch.core.hardware import NVIDIA_H100_SXM, TPU_V5E
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import build_mesh, virtual_mesh
from repro_torch.kernels import flash_ops, ops
from repro_torch.roofline import profile, reanalyze, report
from repro_torch.roofline.analysis import (
    analyze_step,
    collective_bytes,
    roofline_terms,
)
from repro_torch.roofline.op_cost import CostOp, CostWalker, analyze_ops

torch.set_num_threads(1)
META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _stack(x, ws):
    for w in ws:
        x = x @ w
    return x


# ------------------------------------------------------------ the walk

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_linear_stack_flops_and_bytes_exact(device):
    """L linear layers: FLOPs 2 m k n each, bytes x + w + y each, every
    weight charged once (never the whole stack a layer), on the meta
    device and the CPU alike."""
    L, m, d = 5, 8, 32
    x = torch.zeros((m, d), device=device)
    ws = [torch.zeros((d, d), device=device) for _ in range(L)]
    rec, ops_ = analyze_step(_stack, (x, ws))
    assert [o.kind for o in ops_] == ["mm"] * L
    assert rec["flops_per_device"] == L * 2 * m * d * d
    per_layer = (m * d + d * d + m * d) * 4
    assert rec["bytes_per_device"] == L * per_layer
    assert rec["bytes_per_device"] < L * L * d * d * 4
    assert rec["memory"]["argument_size_in_bytes"] == (m * d + L * d * d) * 4
    assert rec["memory"]["output_size_in_bytes"] == m * d * 4
    # two activations live at once at most: the layer's input and output
    assert rec["memory"]["temp_size_in_bytes"] == m * d * 4
    assert rec["memory"]["alias_size_in_bytes"] == 0


def test_views_free_inplace_once_and_gathers_move_what_they_return():
    x = _meta(16, 64)
    table = _meta(1000, 64)
    idx = torch.empty((16,), dtype=torch.long, device=META)
    with CostWalker() as w:
        v = x.t().reshape(64, 16)           # views: free
        x.add_(1.0)                         # in place: x once
        rows = table[idx]                   # a gather: 2 x what it returns
        cache = _meta(4, 64)
        cache[idx[:4]] = rows[:4]           # an indexed write: 2 x values
    by = {o.kind: o.bytes for o in w.costs}
    assert "t" not in by and "view" not in by and v.shape == (64, 16)
    assert by["add_"] == 16 * 64 * 4
    assert by["index"] == 2 * 16 * 64 * 4
    assert by["index_put_"] == 2 * 4 * 64 * 4


def test_cache_written_in_place_is_an_alias():
    cache = _meta(4, 32, 8)

    def step(cache, new):
        cache[:, 3] = new
        return cache

    rec, _ = analyze_step(step, (cache, _meta(4, 8)))
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] == mem["output_size_in_bytes"] \
        == 4 * 32 * 8 * 4
    assert rec["hbm_per_device_gib"] * 2**30 == \
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def test_kernel_records_declare_bytes_and_hide_plain_ops():
    """K1 on CPU operands: one record with ``k1_flops`` and ``k1_bytes``,
    none of its plain version's aten ops; the OpWalker inventory keeps
    its one FLOP record."""
    m, k, n = 12, 64, 40
    x, w = torch.ones((m, k)), torch.ones((k, n))
    with CostWalker() as cw:
        ops.abft_matmul(x, w, mode="1s")
    kern = [o for o in cw.costs if o.kind == "K1"]
    assert len(kern) == 1 and len(cw.ops) == 1
    bm, bn = 16, 40               # the default blocks clamped to 8-multiples
    assert kern[0].flops == ops.k1_flops(m, k, n)
    assert kern[0].bytes == (m * k + k * n + m * n) * 4 \
        + 2 * 4 * math.ceil(m / bm) * math.ceil(n / bn) * bm
    assert all(o.path.count("kernel") == 0 for o in cw.costs)
    assert not any(o.kind in ("einsum", "bmm") for o in cw.costs)


def test_decode_bytes_count_the_cache_capacity():
    B, S, H, KV, D = 2, 48, 4, 2, 16
    q = torch.zeros((B, 1, H, D))
    kc = torch.zeros((B, S, KV, D))
    with CostWalker() as cw:
        flash_ops.flash_decode(q, kc, kc, torch.tensor([5, 9]))
    (rec,) = [o for o in cw.costs if o.kind == "K3"]
    assert rec.bytes == flash_ops.decode_bytes(q, kc, kc, S)
    assert rec.bytes == (B * H * D * 4 + B * S * KV * 2 * D * 4 + 4 * B
                         + B * H * D * 4 + 4 * B * H * 4)
    assert rec.flops == flash_ops.attn_flops(B * H, D, D, S)


# ----------------------------------------------------------- collectives

def test_virtual_row_parallel_sum_records_payload():
    """L row-parallel layers at a virtual (1, 4) mesh: each f32 partial
    summed over the model axis records m x n x 4 bytes, L counts."""
    L, m, k, n = 3, 8, 64, 32
    mesh = virtual_mesh(data=1, model=4)
    tp = C.TPGroup(rank=mesh.model_rank, size=4, group=mesh.group,
                   backend=C.backend_of(mesh.group))
    xs = _meta(m, k // 4)
    ws = [_meta(k // 4, n) for _ in range(L)]

    def rows(x, ws):
        return [C.all_reduce_sum(x @ w, tp) for w in ws]

    C.reset_counts()
    rec, ops_ = analyze_step(rows, (xs, ws))
    assert rec["collectives"]["all-reduce"] == L * m * n * 4
    assert rec["collectives"]["_counts"]["all-reduce"] == L
    assert rec["collective_bytes_per_device"] == L * m * n * 4
    assert C.COUNTS["model_sum"] == L and C.BYTES["model_sum"] == L * m * n * 4
    assert collective_bytes(ops_)["all-reduce"] == L * m * n * 4


def test_virtual_gather_shape_and_payload():
    mesh = virtual_mesh(data=2, model=4)
    tp = C.TPGroup(rank=0, size=4, group=mesh.group, backend="virtual")
    with CostWalker() as cw:
        y = C.gather_last(_meta(3, 5, dtype=torch.bfloat16), tp)
    assert y.shape == (3, 20) and y.is_meta
    (g,) = [o for o in cw.costs if o.payload]
    assert (g.kind, g.geometry, g.payload) == ("all-gather",
                                               ("model_gather",), 3 * 20 * 2)


def test_virtual_group_refuses_real_tensors():
    mesh = virtual_mesh(data=1, model=2)
    tp = C.TPGroup(rank=0, size=2, group=mesh.group, backend="virtual")
    with pytest.raises(RuntimeError, match="meta tensors"):
        C.all_reduce_sum(torch.zeros(4), tp)
    with pytest.raises(RuntimeError, match="meta tensors"):
        C.gather_last(torch.zeros(4, 2), tp)


def test_virtual_mesh_follows_build_mesh_rules():
    from repro_torch.launch.mesh import make_production_mesh

    m = make_production_mesh(virtual=True)
    assert m.virtual and m.shape == {"data": 16, "model": 16}
    assert m.group.ranks == tuple(range(16))
    assert m.data_group.ranks == tuple(range(0, 256, 16))
    assert m.device == META and m.grid_group.size == 256
    pod = make_production_mesh(multi_pod=True, virtual=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    v = virtual_mesh(data=2, model=2, rank=3)
    assert v.coords() == {"data": 1, "model": 1}
    assert (v.group.ranks, v.data_group.ranks) == ((2, 3), (1, 3))
    real = build_mesh(data=1, model=1, devices=[torch.device("cpu")])
    assert not real.virtual


# ---------------------------------------------------------------- terms

@pytest.mark.parametrize("terms", [(1e12, 1e9, 1e6), (1e9, 1e12, 1e6),
                                   (1e9, 1e9, 1e12), (0.0, 0.0, 0.0),
                                   (3.7e13, 2.2e11, 4.1e9)])
def test_roofline_terms_equal_reference(terms):
    assert roofline_terms(*terms, TPU_V5E) == jroofline_terms(*terms)


def test_roofline_terms_default_to_h100():
    t = roofline_terms(989e12, 3.35e12, 450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    assert roofline_terms(1.0, 2.0, 3.0) == roofline_terms(
        1.0, 2.0, 3.0, NVIDIA_H100_SXM)


# --------------------------------------------------------------- report

def _records():
    ok = {"arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "single",
          "status": "ok", "chips": 256, "hbm_per_device_gib": 8.2764,
          "compile_s": 4.8, "compute_s": 3.4e-6, "memory_s": 0.00187,
          "collective_s": 0.25, "bottleneck": "collective",
          "useful_flops_ratio": 0.3646}
    return [
        ok,
        dict(ok, shape="train_4k", mesh="pod", compute_s=0.12,
             memory_s=1.16, collective_s=0.26, bottleneck="memory"),
        dict(ok, shape="prefill_32k", compute_s=2.5, memory_s=0.5,
             bottleneck="compute"),
        {"arch": "qwen3-14b", "shape": "train_4k", "mesh": "single",
         "status": "skipped", "reason": "not ported: qwen3-14b: the rules "
                                        "split a q head; ROADMAP A.3b-ii"},
        {"arch": "whisper-tiny", "shape": "long_500k", "mesh": "pod",
         "status": "skipped",
         "reason": "long_500k skipped: pure full-attention arch"},
        {"arch": "jamba-v0.1-52b", "shape": "decode_32k", "mesh": "single",
         "status": "error", "error": "RuntimeError: x"},
    ]


@pytest.mark.parametrize("table", ["dryrun", "single", "pod"])
def test_report_tables_equal_reference(table):
    recs = _records()
    if table == "dryrun":
        assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    else:
        assert report.roofline_table(recs, table) == \
            jreport.roofline_table(recs, table)


def test_report_load_reads_a_directory(tmp_path):
    for i, r in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path))


# ------------------------------------------------ reanalyze and profile

def test_reanalyze_rebuilds_a_saved_cell_exactly(tmp_path, monkeypatch):
    """A small dry-run cell written by ``run_cell`` and re-derived from
    its ``.ops.jsonl.gz``: the same record, key for key."""
    from repro_torch.configs import get_config, scaled_down
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: scaled_down(get_config(a)))
    monkeypatch.setitem(dryrun.SHAPES, "decode_32k",
                        dict(kind="decode", seq=64, batch=4))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod, virtual: virtual_mesh(data=2,
                                                                model=2))
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", "single", tmp_path,
                          force=True)
    assert rec["status"] == "ok" and rec["chips"] == 4
    path = tmp_path / "llama3.2-1b__decode_32k__single.json"
    saved = json.loads(path.read_text())
    bumped = dict(saved, flops_per_device=0.0, bytes_per_device=0.0,
                  compute_s=1.0, hlo_flops_global=0.0)
    path.write_text(json.dumps(bumped))
    assert reanalyze.reanalyze_dir(tmp_path) == 1
    assert json.loads(path.read_text()) == saved
    ops_ = reanalyze.load_ops(tmp_path / "llama3.2-1b__decode_32k__single"
                                         ".ops.jsonl.gz")
    assert analyze_ops(ops_)["flops"] == saved["flops_per_device"]
    rows = profile.top_contributors(ops_, 5)
    assert len(rows) == 5
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)


def test_profile_folds_layers_and_ranks_by_bytes():
    ops_ = [CostOp("mm", 10.0, 100.0, (1, 2, 3), f"d/layer[{i}]/mm")
            for i in range(4)]
    ops_ += [CostOp("add", 0.0, 150.0, (4,), "d/add"),
             CostOp("all-reduce", 0.0, 0.0, ("model_sum",),
                    "d/layer[0]/all-reduce", payload=50.0)]
    rows = profile.top_contributors(ops_, 3)
    assert rows[0] == (400.0, 4, "mm", "d/layer[*]/mm", (1, 2, 3))
    assert rows[1] == (150.0, 1, "add", "d/add", (4,))
    assert rows[2][2] == "[coll]all-reduce" and rows[2][0] == 50.0
    assert profile.format_rows(rows, 3)[0].startswith("top-3 contributors")


def test_cost_op_json_round_trip():
    op = CostOp("K1", 1.5e9, 3.25e6, (4, 2048, 8192), "decode/layer[1]/K1")
    assert CostOp.from_json(json.loads(json.dumps(op.to_json()))) == op
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(4) * 1e9
    op = CostOp("mm", float(vals[0]), float(abs(vals[1])), (1,), "p")
    assert CostOp.from_json(json.loads(json.dumps(op.to_json()))) == op
