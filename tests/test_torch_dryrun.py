"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on the same scaled cells, and on
the production meshes at full width.

Scaled llama, qwen2-moe and mamba2 at (1, 2) and (2, 2) meshes for train,
prefill and decode, at ``abft=off`` and ``auto``: the port's cells run
here (rank 0 of a virtual mesh, on the meta device); the reference's
cells are compiled in one subprocess over four XLA host devices (as
``tests/test_roofline.py`` does), its config and shapes replaced only
inside that process, and read with its own ``analyze_compiled``.  The
port's ``auto`` selects against the reference's TPU v5e, so both pick
the same schemes.

What is held, and how close:

* ``model_flops``: equal to the reference's counting for every cell.
* prefill: the per-device FLOPs equal the reference's, exactly (both run
  the chunked attention over every block, and the same products; held
  here on llama at (1, 2) ``off`` and mamba2 at (2, 2) ``auto``, measured
  once on all three archs at both).
* decode at (1, 2), ``abft=off``: equal for qwen2-moe (and llama,
  measured once).  mamba2
  differs by its depthwise conv window alone: the reference contracts the
  window with a dot (2 B W C FLOPs in its HLO), the port with an
  elementwise product and a sum, which carry no FLOP record; the test
  adds them back and holds the sum exactly.
* decode at (2, 2): the port's split decode is exactly half the (1, 2)
  cell's (each data rank its own slots), and never above the reference's,
  whose compiled step keeps part of its products unsplit over ``data``.
* train: the port's FLOPs equal the reference's on llama, at (1, 2)
  and on the pod cell (2, 1, 2): a layer's last projection (the FFN's
  ``down``, the SSD mixer's ``out``) runs outside the recomputed region
  of ``run_stack``'s checkpoint, as XLA's dead-code elimination drops
  its recompute.  ``TRAIN_GAP`` bounds what remains, 4%: an MoE layer
  ends in the experts' combine, whose inputs the backward reads (the
  router weights' gradient), so its recomputed region takes in the
  shared experts' ``down`` too, which XLA drops (qwen2-moe: exactly two
  such GEMMs, 3.33% at (1, 2) and 3.17% at (2, 2) when measured once;
  mamba2 within 1.2%, by the conv window below); 3.33% plus a margin of
  0.67 points.
* ``abft=auto`` decode: the reference emulates the block schemes with
  per-block checksum products (``use_pallas=False``) that cost more FLOPs
  than the fused kernel's declared check (``ops.k1_flops``: 2 m k twice),
  so only the port's own relation (auto above off) is held there.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.models.counting import model_flops as jmodel_flops
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.hardware import TPU_V5E
from repro_torch.distributed.mesh import virtual_mesh
from repro_torch.distributed.sharding import (
    cache_specs,
    map_with_path,
    opt_state_specs,
    param_specs,
    shard_shape,
)
from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import analyze_step

torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "qwen2-moe-a2.7b", "mamba2-1.3b")
MESHES = ((1, 2), (2, 2))
SHAPES = {"train_4k": dict(kind="train", seq=32, batch=4),
          "prefill_32k": dict(kind="prefill", seq=64, batch=4),
          "decode_32k": dict(kind="decode", seq=64, batch=4)}
CELLS = [(a, s, d, m, ab) for a in ARCHS for d, m in MESHES for s in SHAPES
         for ab in ("off", "auto")]
# the reference compiles only these (one subprocess, ≈ 30 s; the suite's
# time is tight): every relation below is held on one arch or two; a
# data entry [pod, data] is a (pod, data, model) mesh
REF_CELLS = [("llama3.2-1b", "prefill_32k", 1, 2, "off"),
             ("mamba2-1.3b", "prefill_32k", 2, 2, "auto"),
             ("qwen2-moe-a2.7b", "decode_32k", 1, 2, "off"),
             ("mamba2-1.3b", "decode_32k", 1, 2, "off"),
             ("llama3.2-1b", "decode_32k", 2, 2, "off"),
             ("llama3.2-1b", "train_4k", 1, 2, "off"),
             ("qwen2-moe-a2.7b", "train_4k", 1, 2, "off"),
             ("llama3.2-1b", "train_4k", (2, 1), 2, "off")]
CELLS += [c for c in REF_CELLS if isinstance(c[2], tuple)]
# the train gap's bound (the module docstring)
TRAIN_GAP = 0.04
PRODUCTION = (dryrun.get_config, dict(dryrun.SHAPES), dryrun.dryrun_abft)

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.devices()          # the backend is up before the dry run's flags
import repro.launch.dryrun as D
from repro.configs import get_config, scaled_down
from repro.distributed.mesh import build_mesh
from repro.roofline.analysis import analyze_compiled
cells, shapes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
D.SHAPES.clear()
D.SHAPES.update(shapes)
D.get_config = lambda a: scaled_down(get_config(a))
out = {}
for arch, shape, d, m, abft in cells:
    D.VARIANT.clear()
    D.VARIANT["abft"] = abft
    mesh = (build_mesh(pod=d[0], data=d[1], model=m) if isinstance(d, list)
            else build_mesh(data=d, model=m))
    fn, args, in_sh, out_sh, meta = D.build_cell(arch, shape, mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=in_sh,
                           out_shardings=out_sh).lower(*args).compile()
    d = tuple(d) if isinstance(d, list) else d
    out["|".join(map(str, (arch, shape, d, m, abft)))] = \
        analyze_compiled(compiled)["flops_per_device"]
json.dump(out, sys.stdout)
"""


def _key(cell) -> str:
    return "|".join(map(str, cell))


def _mesh(d, m):
    """The virtual mesh of a cell's (data, model), data a (pod, data)
    pair for a pod cell."""
    if isinstance(d, tuple):
        return virtual_mesh(pod=d[0], data=d[1], model=m)
    return virtual_mesh(data=d, model=m)


@pytest.fixture(scope="module")
def ref_flops():
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _REF, json.dumps(REF_CELLS),
         json.dumps(SHAPES)], capture_output=True, text=True, timeout=400,
        env={"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
             "HOME": os.environ.get("HOME", "/tmp")})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout)
    out["_seconds"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def scaled():
    """The dry run's module patched to the scaled configs and shapes,
    ``auto`` on the reference's TPU v5e; restored after the module."""
    saved = (dryrun.get_config, dict(dryrun.SHAPES), dryrun.dryrun_abft)
    orig_abft = dryrun.dryrun_abft
    dryrun.get_config = lambda a: scaled_down(get_config(a))
    dryrun.SHAPES.clear()
    dryrun.SHAPES.update(SHAPES)
    dryrun.dryrun_abft = lambda a, k="decode": dataclasses.replace(
        orig_abft(a, k), hardware=TPU_V5E)
    yield
    dryrun.get_config = saved[0]
    dryrun.SHAPES.clear()
    dryrun.SHAPES.update(saved[1])
    dryrun.dryrun_abft = saved[2]
    dryrun.VARIANT.clear()


@pytest.fixture(scope="module")
def port(scaled):
    """Every cell's record and walk on the port's side."""
    out = {}
    for cell in CELLS:
        arch, shape, d, m, abft = cell
        dryrun.VARIANT.clear()
        dryrun.VARIANT["abft"] = abft
        fn, args, meta = dryrun.build_cell(arch, shape, _mesh(d, m))
        rec, ops = analyze_step(fn, args, entry=shape)
        out[_key(cell)] = dict(rec=rec, ops=ops, args=args, meta=meta)
    dryrun.VARIANT.clear()
    return out


@pytest.mark.parametrize("cell", CELLS, ids=_key)
def test_cell_ok_and_model_flops_equal_reference(port, cell):
    arch, shape, *_ = cell
    r = port[_key(cell)]
    assert r["rec"]["flops_per_device"] > 0
    meta = r["meta"]
    assert meta["tokens"] == SHAPES[shape]["batch"] * (
        1 if SHAPES[shape]["kind"] == "decode" else SHAPES[shape]["seq"])
    from repro_torch.models.counting import model_flops

    assert model_flops(scaled_down(get_config(arch)), meta["tokens"],
                       meta["training"]) == \
        jmodel_flops(jscaled(jget(arch)), meta["tokens"], meta["training"])


@pytest.mark.parametrize("cell", [c for c in REF_CELLS
                                  if c[1] == "prefill_32k"], ids=_key)
def test_prefill_flops_equal_reference(port, ref_flops, cell):
    key = _key(cell)
    assert port[key]["rec"]["flops_per_device"] == ref_flops[key]


def _conv_window_flops(r) -> float:
    """The reference's dot over a decode step's depthwise conv window:
    2 x B x (W - 1 + 1) x channels, from the rank's conv caches."""
    cache = r["args"][2]
    total = 0.0
    for layer in cache:
        for name in ("conv_x", "conv_bc"):
            if name in layer:
                B, w1, ch = layer[name].shape
                total += 2.0 * B * (w1 + 1) * ch
    return total


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_decode_flops_equal_reference(port, ref_flops, arch):
    key = _key((arch, "decode_32k", 1, 2, "off"))
    r = port[key]
    extra = _conv_window_flops(r) if arch == "mamba2-1.3b" else 0.0
    assert arch != "mamba2-1.3b" or extra > 0
    assert r["rec"]["flops_per_device"] + extra == ref_flops[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("abft", ["off", "auto"])
def test_split_decode_is_half_the_model_only_cell(port, arch, abft):
    one = port[_key((arch, "decode_32k", 1, 2, abft))]["rec"]
    two = port[_key((arch, "decode_32k", 2, 2, abft))]["rec"]
    assert 2 * two["flops_per_device"] == one["flops_per_device"]
    assert two["collectives"]["_counts"]["all-gather"] >= 1


def test_split_decode_never_above_reference(port, ref_flops):
    key = _key(("llama3.2-1b", "decode_32k", 2, 2, "off"))
    assert port[key]["rec"]["flops_per_device"] <= ref_flops[key]


def test_train_flops_within_the_recompute_gap(port, ref_flops):
    """llama's train step at (1, 2) and on the pod cell: the port's FLOPs
    are the reference's, exactly (no FFN ``down`` is recomputed)."""
    for d in (1, (2, 1)):
        key = _key(("llama3.2-1b", "train_4k", d, 2, "off"))
        got, ref = port[key]["rec"]["flops_per_device"], ref_flops[key]
        assert ref <= got <= (1 + TRAIN_GAP) * ref
        assert got == ref, d


def test_moe_train_gap_is_the_shared_experts_down(port, ref_flops):
    """The gap that remains (the module docstring): qwen2-moe's two
    shared-expert ``down`` GEMMs recomputed inside the MoE layers'
    checkpointed region: tokens 4 x 32, the shared d_ff 128 split over 2,
    d_model 64."""
    key = _key(("qwen2-moe-a2.7b", "train_4k", 1, 2, "off"))
    got, ref = port[key]["rec"]["flops_per_device"], ref_flops[key]
    assert ref < got <= (1 + TRAIN_GAP) * ref
    assert got - ref == 2 * (2 * 128 * 64 * 64)


@pytest.mark.parametrize("d", [1, 2, (2, 1)])
def test_sharded_train_walk_holds_no_whole_vocab_logits(port, d):
    """The vocab-parallel loss: no op of a sharded train step's walk at
    model = 2 outputs the whole vocab (the head's logits and the loss's
    ops stay at the rank's half), while the unsharded-vocab reckoning of
    the same step would hold (rows, 32, vocab) f32 tensors."""
    from repro_torch.configs import get_config, scaled_down

    vocab = scaled_down(get_config("llama3.2-1b")).vocab_size
    ops = port[_key(("llama3.2-1b", "train_4k", d, 2, "off"))]["ops"]
    assert not [o for o in ops if o.geometry and o.geometry[-1] == vocab]
    assert [o for o in ops if o.geometry and o.geometry[-1] == vocab // 2]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_auto_adds_checks_to_off(port, arch, shape):
    for d, m in MESHES:
        off = port[_key((arch, shape, d, m, "off"))]["rec"]
        auto = port[_key((arch, shape, d, m, "auto"))]["rec"]
        assert auto["flops_per_device"] > off["flops_per_device"]
        assert any(o.kind == "K1" for o in port[_key(
            (arch, shape, d, m, "auto"))]["ops"]) or shape == "train_4k"


def _shard_bytes(cfg, tree, specs_fn, mesh, itemsize=None) -> int:
    """The bytes of a tree's shards on rank 0 of ``mesh`` under
    ``specs_fn``'s specs (``itemsize``: for every leaf, else each
    leaf's own)."""
    specs, total = {}, 0
    map_with_path(lambda ps, sp: specs.__setitem__(ps, sp),
                  specs_fn(cfg, tree, mesh))

    def one(ps, t):
        nonlocal total
        n = 1
        for s in shard_shape(specs[ps], t.shape, mesh):
            n *= int(s)
        total += n * (itemsize or t.element_size())

    map_with_path(one, tree)
    return total


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_argument_bytes_equal_shard_shapes(port, arch, shape):
    """The record's argument bytes are the rank's shards': params by
    ``param_specs``; the step counter, both moments by
    ``opt_state_specs`` (ZeRO-1) and a 0-d error residual a leaf; or the
    dense cache by ``cache_specs`` as the serving executor lays it; and
    the inputs (the global batch in training, the rank's rows in a split
    prefill, every slot's token and cursor in decode)."""
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import _MOMENT_DTYPES

    d, m = 2, 2
    r = port[_key((arch, shape, d, m, "off"))]
    mesh = virtual_mesh(data=d, model=m)
    cfg = scaled_down(get_config(arch))
    model = Model(cfg)
    full = model.param_shapes(torch.bfloat16)
    want = _shard_bytes(cfg, full, param_specs, mesh)
    spec = SHAPES[shape]
    B, S = spec["batch"], spec["seq"]
    if spec["kind"] == "train":
        mdt = _MOMENT_DTYPES[dryrun._moment_dtype(cfg)]
        size = torch.empty((), dtype=mdt).element_size()
        n_leaves = len(_leaves(r["args"][0]))
        want += 4 + 2 * _shard_bytes(cfg, full, opt_state_specs, mesh,
                                     size) + 4 * n_leaves
        want += 2 * B * S * 8
    else:
        cache = model.init_cache(B, S, dtype=torch.bfloat16, device="meta")
        want += _shard_bytes(cfg, cache, lambda c, t, mm: cache_specs(
            c, t, mm, B, kv_fallback="replicate"), mesh)
        want += (B // d * S * 8 if spec["kind"] == "prefill"
                 else 2 * B * 4)
    assert r["rec"]["memory"]["argument_size_in_bytes"] == want


def _leaves(tree) -> list:
    from repro_torch.roofline.op_cost import _tensors

    return _tensors(tree)


# ------------------------------------------------- production meshes

@pytest.fixture
def production(monkeypatch):
    """The dry run's own configs, shapes and policy (the scaled fixture
    above holds the module's until its end)."""
    monkeypatch.setattr(dryrun, "get_config", PRODUCTION[0])
    monkeypatch.setattr(dryrun, "SHAPES", dict(PRODUCTION[1]))
    monkeypatch.setattr(dryrun, "dryrun_abft", PRODUCTION[2])
    dryrun.VARIANT.clear()

@pytest.mark.parametrize("arch,shape,mesh,over,needle", [
    ("deepseek-v3-671b", "decode_32k", "single", {"n_heads": 40},
     "40 MLA heads do not divide model=16.*ROADMAP A.3b-ii"),
    ("mamba2-1.3b", "train_4k", "pod", {"ssm_head_dim": 512},
     "split an SSD head over model=16.*ROADMAP A.3b-ii"),
    ("deepseek-v3-671b", "prefill_32k", "pod", {"mtp_depth": 2},
     "one MTP head is ported; ROADMAP A.3$"),
])
def test_refused_layouts_are_skipped_naming_the_roadmap(production,
                                                        monkeypatch,
                                                        tmp_path, arch,
                                                        shape, mesh, over,
                                                        needle):
    """What the port still refuses, on configs no published one reaches
    (the pod axis and GQA head splits are laid out since): an MLA head
    split, an SSD head split and a second MTP head, each skipped naming
    its ROADMAP item."""
    import re

    monkeypatch.setattr(dryrun, "get_config", lambda a: dataclasses.replace(
        PRODUCTION[0](a), **over))
    rec = dryrun.run_cell(arch, shape, mesh, tmp_path, force=True)
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("not ported: ")
    assert re.search(needle, rec["reason"]), rec["reason"]


def test_reference_skips_stay_reference_skips(production, tmp_path):
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", "single", tmp_path)
    assert rec["status"] == "skipped"
    assert rec["reason"].startswith("long_500k skipped")


def test_unknown_knob_raises():
    dryrun.VARIANT["fsdp"] = "off"
    try:
        with pytest.raises(ValueError, match="not a knob"):
            dryrun.check_variant()
    finally:
        dryrun.VARIANT.clear()


def test_full_width_decode_on_the_production_mesh(production, tmp_path):
    """llama3.2-1b decode_32k at (16, 16): rank 0's walk on the meta
    device in seconds, its record whole: 8 slots a data rank, the head's
    vocab and the q heads split 16 ways, K1 and K3 in the walk, the
    collectives those of a split decode step."""
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", "single", tmp_path,
                          force=True)
    took = time.perf_counter() - t0
    assert rec["status"] == "ok", rec.get("error")
    assert took < 60
    assert rec["chips"] == 256 and rec["hardware"] == "nvidia-h100-sxm"
    assert rec["bottleneck"] in ("memory", "collective", "compute")
    assert rec["hlo_flops_global"] == rec["flops_per_device"] * 256
    assert rec["useful_flops_ratio"] == \
        rec["model_flops"] / rec["hlo_flops_global"]
    from repro_torch.roofline.reanalyze import load_ops

    ops = load_ops(tmp_path / "llama3.2-1b__decode_32k__single.ops.jsonl.gz")
    kinds = {o.kind for o in ops}
    assert {"K1", "K3", "all-reduce", "all-gather"} <= kinds
    # one K3 a layer, 8 slots x 32 / 16 q heads a rank
    k3 = [o for o in ops if o.kind == "K3"]
    assert len(k3) == 16 and k3[0].geometry == (8 * 2, 64, 32768)
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] > 0
    assert mem["argument_size_in_bytes"] > mem["alias_size_in_bytes"]
