"""The SSM family in the port against the reference, on the CPU in f32:
mamba2-1.3b at ``scaled_down`` (2 ``mamba:none:0`` layers) and
jamba-v0.1-52b at ``scaled_down`` cut to one 8-layer unit of its
interleave (``mamba:moe``, ``mamba:dense`` x 3, ``attn:moe`` at 4, ...;
8 experts, top 2), params carried across by ``params_from_reference``:
the segment plan and the cache layouts, the full forward, prefill and
decode on the dense and the paged cache (logits, flags and every state
leaf), one train step's loss on mamba2, the refusals, and the launchers.

The reference runs its block schemes through the XLA emulation
(``use_pallas=False``), the port the K1 plain versions.  Tolerances (f32,
sums in another order): logits and states within 1e-4 absolute and
relative, the train step's loss within 1e-5 relative; flags equal.  A
faulted call runs one row (``tests/test_torch_mamba.py`` says why).
"""

import dataclasses
import json

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
from repro_torch.configs import get_config, scaled_down
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

SLOTS, MAX_LEN, BS = 3, 32, 8
# arch -> scaled_down overrides: jamba cut to one unit of its interleave
ARCHS = {"mamba2-1.3b": {}, "jamba-v0.1-52b": {"n_layers": 8}}
UNIT = ("mamba:moe:0", "mamba:dense:0", "mamba:moe:0", "mamba:dense:0",
        "attn:moe:0", "mamba:dense:0", "mamba:moe:0", "mamba:dense:0")
TOL = dict(atol=1e-4, rtol=1e-4)


def build_pair(arch, **over):
    """The reference's model and params (seed 1, f32) at ``scaled_down``
    ``arch`` with ``over``, and the port's, carried across."""
    over = {**ARCHS[arch], **over}
    jm = build_model(jscaled(jget(arch), **over))
    jp = jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32)
    cfg = scaled_down(get_config(arch), **over)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module", params=sorted(ARCHS))
def stack(request):
    return (request.param,) + build_pair(request.param)


def _ctxs(fault=None):
    jf = tf = None
    if fault is not None:
        layer, site = fault
        jf = JMF.at(layer, site, JFault.value(0, 2, 1e4))
        tf = ModelFault.at(layer, site, FaultSpec.value(0, 2, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU), fault=jf)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E), fault=tf)
    return jctx, tctx


def test_seg_plan_takes_jambas_unit():
    """jamba's 32 layers are 4 repeats of one 8-layer unit (its 1:7
    attention interleave at offset 4 and MoE every other layer); the
    8-layer cut is that unit once; mamba2 is one tag 48 times."""
    for cfg, jcfg, want in (
            (get_config("jamba-v0.1-52b"), jget("jamba-v0.1-52b"),
             [(UNIT, 4)]),
            (dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8),
             dataclasses.replace(jget("jamba-v0.1-52b"), n_layers=8),
             [(UNIT, 1)]),
            (get_config("mamba2-1.3b"), jget("mamba2-1.3b"),
             [(("mamba:none:0",), 48)])):
        got = [(s.unit, s.repeats) for s in tmodel.seg_plan(cfg)]
        assert got == want
        assert got == [(s.unit, s.repeats) for s in jmodel.seg_plan(jcfg)]


def test_params_cross_over_with_the_ports_own_layout(stack):
    arch, jm, jp, tm, tp = stack
    own = tm.init_params(0, dtype=torch.float32)
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tp)}
    assert got == {p: tuple(t.shape) for p, t in tree_leaves_with_path(own)}
    tags = tmodel.layer_tags(tm.cfg)
    assert [tmodel._layer_kind(lp) for lp in tp["layers"]] == tags
    # a layer without an FFN has no FFN norm either, as the reference's
    none = [lp for lp, t in zip(tp["layers"], tags) if t.endswith("none:0")]
    assert all(set(lp) == {"mixer_norm", "mixer"} for lp in none)
    assert bool(none) == (arch == "mamba2-1.3b")
    # the scan's f32 leaves stay f32 in a bf16 model
    bf = params_from_reference(tm.cfg, jax.tree_util.tree_map(np.asarray, jp),
                               dtype=torch.bfloat16)
    mx = bf["layers"][0]["mixer"]
    assert mx["A_log"].dtype == mx["D"].dtype == mx["dt_bias"].dtype \
        == torch.float32
    assert mx["in_x"].dtype == torch.bfloat16
    # a tree whose unit does not match the plan is refused
    bad = jax.tree_util.tree_map(np.asarray, jp)
    seg = bad["segments"][0]
    if len(seg) > 1:
        seg["pos0"], seg["pos4"] = seg["pos4"], seg["pos0"]
    else:
        seg["pos0"]["ffn"] = {"router": np.zeros((1,))}
    with pytest.raises(ValueError):
        params_from_reference(tm.cfg, bad)


def test_cache_layouts_are_the_references(stack):
    """Dense and paged: attention leaves as before, a Mamba2 layer's state
    a slot (conv windows in the cache dtype, the SSD state in f32), the
    same shapes as the reference's leaves; the paged cache needs the slot
    count."""
    arch, jm, jp, tm, tp = stack
    cfg = tm.cfg
    nb = SLOTS * MAX_LEN // BS
    for tc, jc in ((tm.init_cache(SLOTS, MAX_LEN, dtype=torch.bfloat16),
                    jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.bfloat16)),
                   (tm.init_paged_cache(nb, BS, dtype=torch.bfloat16,
                                        slots=SLOTS),
                    jm.init_paged_cache(SLOTS, nb, BS,
                                        dtype=jnp.bfloat16))):
        i = 0
        for seg, segc in zip(jm.plan, jc):
            for r in range(seg.repeats):
                for q in range(len(seg.unit)):
                    want = segc[f"pos{q}"]["attn"]
                    got = tc[i]
                    assert set(got) == set(want)
                    for k, leaf in want.items():
                        assert tuple(got[k].shape) == tuple(leaf.shape[1:])
                        assert str(got[k].dtype).removeprefix("torch.") \
                            == str(leaf.dtype)
                    i += 1
        assert i == cfg.n_layers
    st = tm.state_layers
    assert sum(st) == (cfg.n_layers if arch == "mamba2-1.3b" else 7)
    with pytest.raises(ValueError):
        tm.init_paged_cache(nb, BS)
    assert (tm.kv_leaf(tm.init_cache(SLOTS, MAX_LEN)) is None) == all(st)


@pytest.mark.parametrize("fault", [None, "ssm_in", "ssm_out"])
def test_forward_logits_and_flag_match_reference(stack, fault):
    arch, jm, jp, tm, tp = stack
    B = 1 if fault else 2
    toks = np.random.default_rng(3).integers(1, 256, size=(B, 13)).astype(
        np.int32)
    jctx, tctx = _ctxs(None if fault is None else (1, fault))
    # the reference jitted: its op-by-op run of jamba's 8 layers takes 4x
    jo = jax.jit(lambda p, b: jm.forward(p, b, jctx))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **TOL)
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss),
                               rtol=1e-5, atol=1e-7)
    assert bool(to.flag) == bool(jo.flag) == (fault is not None)


def _state(jm, jcache, tcache):
    """(reference leaf, port leaf) pairs of every layer's cache."""
    out, i = [], 0
    for seg, segc in zip(jm.plan, jcache):
        for r in range(seg.repeats):
            for q in range(len(seg.unit)):
                for k, leaf in segc[f"pos{q}"]["attn"].items():
                    out.append((f"{i}.{k}", np.asarray(leaf[r]),
                                tcache[i][k].numpy()))
                i += 1
    return out


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_prefill_and_decode_match_reference(stack, kind):
    """A ragged admission of two prompts (9 and 16 tokens) into slots 2 and
    0, then one decode step for every slot: logits, flags and every cache
    leaf, the state's included, equal the reference's.  ``Model.decode``
    hands a Mamba2 layer's next state back and leaves the cache's."""
    arch, jm, jp, tm, tp = stack
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
        tcache = tm.init_paged_cache(nb, BS, dtype=torch.float32,
                                     slots=SLOTS)
        pre_tab, dec_tab = pool.tables[slots], pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
        pre_tab = dec_tab = None
    jctx, tctx = _ctxs()
    # the reference jitted (its op-by-op run takes several times longer)
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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not bool(jf) and not bool(tf)
    for name, j, t in _state(jm, jcache, tcache):
        np.testing.assert_allclose(t, j, err_msg=f"prefill {name}", **TOL)
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    tok = rng.integers(1, 256, size=(SLOTS, 1)).astype(np.int32)
    jl, jcache, jf = jax.jit(
        lambda p, k, c, q, t: jm.decode(p, k, c, q, jctx, block_tables=t))(
        jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
        None if dec_tab is None else jnp.asarray(dec_tab))
    before = [t.clone() for layer, st in zip(tcache, tm.state_layers)
              if st for t in layer.values()]
    with torch.no_grad():
        tl, new, tf = tm.decode(
            tp, torch.from_numpy(tok).long(), tcache,
            torch.from_numpy(pos), tctx,
            block_tables=None if dec_tab is None
            else torch.from_numpy(dec_tab))
    after = [t for layer, st in zip(tcache, tm.state_layers)
             if st for t in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not bool(jf) and not bool(tf)
    for name, j, t in _state(jm, jcache, new):
        np.testing.assert_allclose(t, j, err_msg=f"decode {name}", **TOL)


def test_train_step_loss_matches_reference():
    jm, jp, tm, tp = build_pair("mamba2-1.3b")
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
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert not bool(tmet["abft_flag"])


def test_verify_and_mid_prompt_prefill_refuse_ssm_layers(stack):
    arch, jm, jp, tm, tp = stack
    assert not tm.supports_prefix_sharing
    assert not tm.supports_chunked_prefill
    cache = tm.init_cache(1, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="roll the SSM"):
        tm.verify(tp, torch.ones(1, 2, dtype=torch.long), cache,
                  torch.zeros(1, dtype=torch.int32), LayerCtx(),
                  torch.full((1,), 2))
    with pytest.raises(ValueError, match="resume"):
        tm.prefill(tp, torch.ones(1, 4, dtype=torch.long), cache,
                   LayerCtx(), slots=torch.zeros(1, dtype=torch.int32),
                   lengths=torch.full((1,), 4),
                   prefix_lens=torch.full((1,), 2))


def test_init_draws_the_mixers_laws():
    # the published widths; the laws are read off layer 0, so one layer
    # of the 48 is drawn
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=1)
    p = Model(cfg).init_params(0, dtype=torch.float32)
    mx = p["layers"][0]["mixer"]
    assert abs(mx["in_x"].std().item() - 0.02) < 1e-3
    assert abs(mx["conv_x_w"].std().item() - 0.5) < 0.02
    assert mx["A_log"].dtype == torch.float32
    assert float(mx["dt_bias"][0]) == -4.0 and float(mx["D"][0]) == 1.0
    assert set(p["layers"][0]) == {"mixer_norm", "mixer"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_the_launchers_serve_and_train_the_ssm_archs(capsys, arch):
    from repro_torch.launch import serve, train

    assert serve.main(["--device", "cpu", "--arch", arch, "--requests",
                       "3", "--new-tokens", "4", "--slots", "2",
                       "--cache", "paged"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tokens"] == 12 and line["errors"] == {}
    assert train.main(["--device", "cpu", "--arch", arch, "--steps", "1",
                       "--batch", "1", "--seq", "16"]) == 0
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--arch", arch, "--spec-decode",
                    "ngram"])
    assert "SSM recurrence" in str(exc.value)


# ROADMAP C's mamba2 precision check: the port's bf16 error against its
# own f32 run, over the reference's bf16 error against its f32 run, on
# the same weights.  Both round the same products to bf16, in other
# places (XLA fuses elementwise chains in f32 where eager torch rounds
# each op's output): a ratio up to 1.5 is the same precision; an SSD path
# that lost precision (a bf16 scan state, a bf16 chunk sum) would show as
# several times the reference's error.
PRECISION_RATIO = 1.5


def test_mamba2_bf16_error_against_f32_matches_the_reference():
    over = dict(n_layers=8, d_model=256)
    jm = build_model(jscaled(jget("mamba2-1.3b"), **over))
    cfg = scaled_down(get_config("mamba2-1.3b"), **over)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               size=(2, 64))
    jctx = JCtx(abft=JABFT(use_pallas=False))
    fwd = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jctx).logits)
    ref, port = {}, {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jp = jm.init_params(jax.random.PRNGKey(0), dtype=jdt)
        ref[name] = np.asarray(fwd(jp, jnp.asarray(tokens)), np.float32)
        params = params_from_reference(
            cfg, jax.tree_util.tree_map(np.asarray, jp), dtype=tdt)
        with torch.no_grad():
            port[name] = Model(cfg).forward(
                params, {"tokens": tokens}, LayerCtx(abft=ABFTConfig()),
                device="cpu").logits.float().numpy()
    np.testing.assert_allclose(port["f32"], ref["f32"], **TOL)

    def err(run):
        return float(np.abs(run["bf16"] - run["f32"]).max()
                     / np.abs(run["f32"]).max())

    assert 0 < err(port) <= PRECISION_RATIO * err(ref)
