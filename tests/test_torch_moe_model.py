"""qwen2-moe-a2.7b in the port against the reference, on the CPU at
``scaled_down`` (2 MoE layers, 8 experts, top 2, 4 shared, f32), carried
across by ``params_from_reference``: the full forward, prefill and decode
on the dense and the paged cache, one train step, and the launcher.  The
mixed dense + MoE stack is ``tests/test_torch_moe_stack.py``.

The reference runs its block schemes through the XLA emulation
(``use_pallas=False``), the port the K1 plain versions.  Tolerances (f32,
sums in another order): logits within 1e-4 absolute and relative,
``aux_loss`` within 1e-5 relative, the train step's loss within 1e-5
relative; flags equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.data.pipeline import DataConfig as JData, SyntheticLM as JSynth
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train.train_step import (
    TrainConfig as JTrainConfig,
    make_train_step as jstep_fn,
)
from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models import model as tmodel
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
SERVED = ("llama3.2-1b", "qwen3-14b", "stablelm-1.6b", "qwen1.5-32b", ARCH,
          "deepseek-v3-671b", "mamba2-1.3b", "jamba-v0.1-52b")
SLOTS, MAX_LEN, BS = 3, 32, 8


def build_pair(**over):
    """The reference's model and params (seed 1, f32) at ``scaled_down``
    qwen2-moe-a2.7b with ``over``, and the port's, carried across."""
    jm = build_model(jscaled(jget(ARCH), **over))
    jp = jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32)
    cfg = scaled_down(get_config(ARCH), **over)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module")
def stack():
    return ("moe",) + build_pair()


def _ctxs(fault=None, flash=False):
    jf = tf = None
    if fault is not None:
        layer, site = fault
        jf = JMF.at(layer, site, JFault.value(0, 2, 1e4))
        tf = ModelFault.at(layer, site, FaultSpec.value(0, 2, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU, flash_attention=flash),
                fault=jf)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E,
                                                flash_attention=flash),
                    fault=tf)
    return jctx, tctx


def test_every_config_is_served_or_refused():
    """The port takes every config, full size too (qwen2-moe-a2.7b
    constructs); the two that read a per-request memory (whisper,
    vision) name it, and the rest read none."""
    for arch in ALL_ARCHS:
        model = Model(get_config(arch))
        assert bool(model.memory_inputs) == (arch not in SERVED)


def test_seg_plan_is_the_references():
    for arch in ALL_ARCHS:
        for cfg, jcfg in ((get_config(arch), jget(arch)),
                          (scaled_down(get_config(arch)),
                           jscaled(jget(arch)))):
            got = [(s.unit, s.repeats) for s in tmodel.seg_plan(cfg)]
            want = [(s.unit, s.repeats) for s in jmodel.seg_plan(jcfg)]
            assert got == want, arch
    mixed = scaled_down(get_config(ARCH), n_layers=13, first_dense_layers=1)
    assert [(s.unit, s.repeats) for s in tmodel.seg_plan(mixed)] == [
        (("attn:dense:0",), 1), (("attn:moe:0",), 12)]


def test_params_cross_over_with_the_ports_own_layout(stack):
    name, jm, jp, tm, tp = stack
    own = tm.init_params(0, dtype=torch.float32)
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tp)}
    assert got == {p: tuple(t.shape) for p, t in tree_leaves_with_path(own)}
    kinds = ["router" in lp["ffn"] for lp in tp["layers"]]
    assert kinds == [t.endswith("moe:0") for t in tmodel.layer_tags(tm.cfg)]
    assert sum(kinds) == len(kinds) == 2
    moe = tp["layers"][-1]["ffn"]
    assert tuple(moe["w_up"].shape) == (8, 64, 32)
    assert tuple(moe["shared"]["down"].shape) == (128, 64)
    # a tree cut to another plan is refused
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["segments"] = bad["segments"][:1] + bad["segments"]
    with pytest.raises(ValueError):
        params_from_reference(tm.cfg, bad)


@pytest.mark.parametrize("fault", [None, (1, "expert_down")],
                         ids=["clean", "fault"])
def test_forward_logits_flag_and_aux_match_reference(stack, fault):
    name, jm, jp, tm, tp = stack
    toks = np.random.default_rng(3).integers(1, 256, size=(2, 16)).astype(
        np.int32)
    jctx, tctx = _ctxs(fault)
    # the reference jitted (its op-by-op run takes longer)
    jo = jax.jit(lambda p, b: jm.forward(p, b, jctx))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss),
                               rtol=1e-5)
    assert float(to.aux_loss) > 0
    assert bool(to.flag) == bool(jo.flag) == (fault is not None)


def _prefill_decode(stack, kind, fault=None, flash=False):
    name, jm, jp, tm, tp = stack
    rng = np.random.default_rng(11)
    lengths = np.array([9, 16], np.int32)
    slots = np.array([2, 0], np.int32)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    if kind == "paged":
        nb = SLOTS * MAX_LEN // BS
        pool = BlockPool(nb, BS, SLOTS, MAX_LEN // BS)
        for s, n in zip(slots, lengths):
            pool.alloc(int(s), int(n) + 1)
        jcache = jm.init_paged_cache(SLOTS, nb, BS, dtype=jnp.float32)
        tcache = tm.init_paged_cache(nb, BS, dtype=torch.float32)
        pre_tab, dec_tab = pool.tables[slots], pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
        pre_tab = dec_tab = None
    jctx, tctx = _ctxs(fault, flash)
    jl, jcache, jf = jax.jit(
        lambda p, b, c, s, n, t: jm.prefill(p, b, c, jctx, slots=s,
                                            lengths=n, block_tables=t))(
        jp, {"tokens": jnp.asarray(toks)}, jcache, jnp.asarray(slots),
        jnp.asarray(lengths),
        None if pre_tab is None else jnp.asarray(pre_tab))
    with torch.no_grad():
        tl, tcache, tf = tm.prefill(
            tp, torch.from_numpy(toks).long(), tcache, tctx,
            slots=torch.from_numpy(slots),
            lengths=torch.from_numpy(lengths),
            block_tables=None if pre_tab is None
            else torch.from_numpy(pre_tab))
    out = {"prefill": (np.asarray(jl), tl.numpy(), bool(jf), bool(tf))}
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    tok = rng.integers(1, 256, size=(SLOTS, 1)).astype(np.int32)
    jl, _, jf = jax.jit(
        lambda p, k, c, q, t: jm.decode(p, k, c, q, jctx, block_tables=t))(
        jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
        None if dec_tab is None else jnp.asarray(dec_tab))
    with torch.no_grad():
        tl, _, tf = tm.decode(
            tp, torch.from_numpy(tok).long(), tcache,
            torch.from_numpy(pos), tctx,
            block_tables=None if dec_tab is None
            else torch.from_numpy(dec_tab))
    out["decode"] = (np.asarray(jl), tl.numpy(), bool(jf), bool(tf))
    return out


@pytest.mark.parametrize("kind,flash", [("dense", False), ("paged", True)])
def test_prefill_and_decode_match_reference(stack, kind, flash):
    """Every slot is routed, the free one included (its token takes
    capacity, as the reference's), so all three decode rows compare."""
    out = _prefill_decode(stack, kind, flash=flash)
    for phase, (jl, tl, jf, tf) in out.items():
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4,
                                   err_msg=phase)
        assert jf is False and tf is False, phase


def test_router_fault_flags_prefill_and_decode_as_the_reference(stack):
    out = _prefill_decode(stack, "dense", fault=(1, "router"))
    for phase, (jl, tl, jf, tf) in out.items():
        assert jf is True and tf is True, phase


def test_train_step_loss_and_aux_match_reference(stack):
    name, jm, jp, tm, tp = stack
    jab = JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)
    tab = ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)
    batch = JSynth(JData(global_batch=2, seq_len=16,
                         vocab_size=256)).batch(0)
    _, _, jmet = jax.jit(jstep_fn(jm, jab, JTrainConfig()))(
        jp, jopt.init_opt_state(jp, jopt.OptConfig()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, tmet = make_train_step(tm, tab, TrainConfig(), device="cpu")(
        tp, topt.init_opt_state(tp, topt.OptConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["total_loss"]),
                               float(jmet["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert not bool(tmet["abft_flag"])


def test_verify_refuses_moe_layers(stack):
    """Verify on the MoE stack is ported (the name is the refusal this
    test held before): it routes the window's rows through ``moe_forward``
    (``tests/test_torch_moe_spec.py`` holds the served streams to the
    reference's)."""
    name, jm, jp, tm, tp = stack
    cache = tm.init_cache(1, 16, dtype=torch.float32)
    with torch.no_grad():
        logits, _, flag = tm.verify(
            tp, torch.ones(1, 2, dtype=torch.long), cache,
            torch.zeros(1, dtype=torch.int32), LayerCtx(),
            torch.full((1,), 2))
    assert logits.shape == (1, 2, tm.cfg.vocab_size) and not bool(flag)
    assert bool(torch.isfinite(logits).all())


def test_the_launcher_serves_the_moe_arch(capsys):
    import json

    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                       "3", "--new-tokens", "4", "--slots", "2",
                       "--inject-faults"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tokens"] == 12 and line["errors"] == {}
    assert line["faults_detected"] >= 1


def test_the_launcher_refuses_speculation_on_moe(capsys):
    """Speculation on MoE is ported (the name is the refusal this test
    held before): the launcher serves with ``--spec-decode``."""
    import json

    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                       "2", "--new-tokens", "4", "--slots", "2",
                       "--spec-decode", "ngram"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tokens"] == 8 and line["errors"] == {}
    assert line["spec_decode"]["draft_len"] >= 1


def test_init_routes_dense_and_moe_layers_by_tag():
    cfg = dataclasses.replace(scaled_down(get_config(ARCH)), n_layers=3,
                              first_dense_layers=1)
    p = Model(cfg).init_params(0, dtype=torch.float32)
    assert "up" in p["layers"][0]["ffn"]
    assert all("router" in lp["ffn"] for lp in p["layers"][1:])
    assert abs(p["layers"][2]["ffn"]["w_up"].std().item() - 0.02) < 3e-3
