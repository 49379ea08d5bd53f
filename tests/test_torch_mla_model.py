"""deepseek-v3-671b in the port against the reference, on the CPU at
``scaled_down`` (2 layers: ``mla:dense:0`` then ``mla:moe:0``, 8 experts
top 2, one shared, the MTP head; f32), carried across by
``params_from_reference``: the full forward with ``mtp_logits``, prefill
and decode on the dense and the paged cache, faults at ``q_a``, ``kv_a``
and ``mlp_up`` (which also fires in ``mtp.proj``), verify on the
all-dense one-layer stack, one train step with the MTP loss term, and the
launchers.

The reference runs its block schemes through the XLA emulation
(``use_pallas=False``), or, for a faulted run, through K1 in interpret
mode (its emulation corrupts a fault's (row, col) in every batch row, the
kernel and the port flattened row ``row`` only); the port runs the K1
plain versions.  Tolerances (f32, sums in another order): logits and
``mtp_logits`` within 1e-4 absolute and relative, ``aux_loss`` within
1e-5 relative, the train step's losses within 1e-5 relative and its
gradient norm within 1e-4; flags equal.
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
from repro_torch.kernels import flash_ops
from repro_torch.models import model as tmodel
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

ARCH = "deepseek-v3-671b"
SLOTS, MAX_LEN, BS = 3, 32, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def build_pair(**over):
    """The reference's model and params (seed 1, f32) at ``scaled_down``
    deepseek-v3-671b with ``over``, and the port's, carried across."""
    jm = build_model(jscaled(jget(ARCH), **over))
    jp = jax.jit(lambda k: jm.init_params(k, dtype=jnp.float32))(
        jax.random.PRNGKey(1))
    cfg = scaled_down(get_config(ARCH), **over)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module")
def stack():
    return build_pair()


@pytest.fixture(scope="module")
def dense_stack():
    """The all-dense MLA stack: one ``mla:dense:0`` layer."""
    return build_pair(n_layers=1)


def _ctxs(fault=None, flash=False):
    jf = tf = None
    if fault is not None:
        layer, site = fault
        jf = JMF.at(layer, site, JFault.value(0, 2, 1e4))
        tf = ModelFault.at(layer, site, FaultSpec.value(0, 2, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=jf is not None,
                                       hardware=JTPU, flash_attention=flash),
                fault=jf)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E,
                                                flash_attention=flash),
                    fault=tf)
    return jctx, tctx


def _jforward(jm, jp, toks, jctx):
    """The reference's forward, compiled whole (its eager op-by-op run
    compiles every primitive alone, ten times slower here)."""
    return jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jctx))(
        jp, jnp.asarray(toks))


def test_tags_and_params_cross_over_with_the_ports_own_layout(stack):
    jm, jp, tm, tp = stack
    assert tmodel.layer_tags(tm.cfg) == ["mla:dense:0", "mla:moe:0"]
    own = tm.init_params(0, dtype=torch.float32)
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tp)}
    assert got == {p: tuple(t.shape) for p, t in tree_leaves_with_path(own)}
    mtp = tp["mtp"]
    assert tuple(mtp["proj"].shape) == (128, 64)
    assert "router" in mtp["layer"]["ffn"]           # the last tag's kind
    assert tuple(mtp["layer"]["mixer"]["w_uk"].shape) == (4, 16, 32)
    np.testing.assert_array_equal(mtp["proj"].numpy(),
                                  np.asarray(jp["mtp"]["proj"]))
    assert abs(own["layers"][0]["mixer"]["w_uv"].std().item() - 0.02) < 3e-3
    assert "mtp" not in Model(scaled_down(get_config("llama3.2-1b"))) \
        .init_params(0, dtype=torch.float32)


@pytest.mark.parametrize("fault", [None, (0, "q_a"), (1, "kv_a"),
                                   (0, "mlp_up")],
                         ids=["clean", "q_a", "kv_a", "mlp_up"])
def test_forward_logits_mtp_and_aux_match_reference(stack, fault):
    jm, jp, tm, tp = stack
    toks = np.random.default_rng(3).integers(1, 256, size=(2, 16)).astype(
        np.int32)
    jctx, tctx = _ctxs(fault)
    jo = _jforward(jm, jp, toks, jctx)
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **TOL)
    assert to.mtp_logits.shape == to.logits.shape
    np.testing.assert_allclose(to.mtp_logits.numpy(),
                               np.asarray(jo.mtp_logits), **TOL)
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss),
                               rtol=1e-5)
    assert bool(to.flag) == bool(jo.flag) == (fault is not None)


def test_mtp_head_takes_faults_whatever_their_layer(stack):
    """A fault at a layer the stack does not have (7) still fires in the
    MTP head, whose ``proj`` (site ``mlp_up``) and layer run with no layer
    index: the logits stay clean, the flag rises and ``mtp_logits`` move,
    as the reference's."""
    jm, jp, tm, tp = stack
    toks = np.random.default_rng(4).integers(1, 256, size=(2, 16)).astype(
        np.int32)
    with torch.no_grad():
        clean = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                           _ctxs()[1], device="cpu")
        jctx, tctx = _ctxs((7, "mlp_up"))
        hit = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                         device="cpu")
    jo = _jforward(jm, jp, toks, jctx)
    assert bool(hit.flag) and bool(jo.flag)
    assert torch.equal(hit.logits, clean.logits)
    assert (hit.mtp_logits - clean.mtp_logits).abs().max() > 1e-2
    np.testing.assert_allclose(hit.mtp_logits.numpy(),
                               np.asarray(jo.mtp_logits), **TOL)


def test_mla_never_takes_the_flash_kernels(stack, monkeypatch):
    """With ``flash_attention`` on, MLA still runs the plain chunked and
    decode attention (the reference's ``_mla_attend``): the flash entry
    points are never reached."""
    jm, jp, tm, tp = stack

    def refuse(*a, **k):
        raise AssertionError("MLA reached a flash kernel")

    for name in ("flash_attention", "flash_decode", "flash_decode_paged"):
        monkeypatch.setattr(flash_ops, name, refuse)
    _, tctx = _ctxs(flash=True)
    toks = torch.ones(1, 8, dtype=torch.long)
    with torch.no_grad():
        tm.forward(tp, {"tokens": toks}, tctx, device="cpu")
        cache = tm.init_cache(1, 16, dtype=torch.float32)
        tm.prefill(tp, toks, cache, tctx)
        tm.decode(tp, toks[:, :1], cache, torch.tensor([8]), tctx)


def _prefill_decode(stack, kind, fault=None, flash=False):
    jm, jp, tm, tp = stack
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
    assert all(list(c) == ["latent"] for c in tcache)
    jctx, tctx = _ctxs(fault, flash)
    jl, jcache, jf = jax.jit(lambda p, t, c, s, n, tb: jm.prefill(
        p, {"tokens": t}, c, jctx, slots=s, lengths=n, block_tables=tb))(
        jp, jnp.asarray(toks), jcache, jnp.asarray(slots),
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
    jl, jcache, jf = jax.jit(lambda p, t, c, q, tb: jm.decode(
        p, t, c, q, jctx, block_tables=tb))(
        jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
        None if dec_tab is None else jnp.asarray(dec_tab))
    with torch.no_grad():
        tl, _, tf = tm.decode(
            tp, torch.from_numpy(tok).long(), tcache,
            torch.from_numpy(pos), tctx,
            block_tables=None if dec_tab is None
            else torch.from_numpy(dec_tab))
    out["decode"] = (np.asarray(jl), tl.numpy(), bool(jf), bool(tf))
    out["latent"] = (_ref_latents(jcache),
                      [c["latent"].numpy() for c in tcache])
    return out


def _ref_latents(jcache) -> list:
    """The reference's latent leaves a layer, in layer order: segment by
    segment, repeat r of unit position q is layer ``r * P + q``."""
    out = []
    for seg in jcache:
        leaves = [np.asarray(seg[f"pos{q}"]["attn"]["latent"])
                  for q in range(len(seg))]
        for r in range(leaves[0].shape[0]):
            out.extend(leaf[r] for leaf in leaves)
    return out


@pytest.mark.parametrize("kind,flash", [("dense", False), ("paged", True)])
def test_prefill_and_decode_match_reference(stack, kind, flash):
    out = _prefill_decode(stack, kind, flash=flash)
    jlat, tlat = out.pop("latent")
    for j, t in zip(jlat, tlat, strict=True):
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    for phase, (jl, tl, jf, tf) in out.items():
        np.testing.assert_allclose(tl, jl, **TOL, err_msg=phase)
        assert jf is False and tf is False, phase


@pytest.mark.parametrize("fault", [(0, "q_a"), (1, "kv_a"), (1, "mlp_up")],
                         ids=["q_a", "kv_a", "mlp_up"])
def test_faults_flag_prefill_and_decode_as_the_reference(stack, fault):
    out = _prefill_decode(stack, "dense", fault=fault)
    out.pop("latent")
    for phase, (jl, tl, jf, tf) in out.items():
        assert jf is True and tf is True, phase


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_matches_reference_on_the_dense_stack(dense_stack, kind):
    """After the prefill of ``_prefill_decode``'s prompts, a verify window
    of T = 4 (valid 4, 1 and 0: a free slot writes nothing): logits of the
    valid rows and the latent cells as the reference's."""
    jm, jp, tm, tp = dense_stack
    rng = np.random.default_rng(21)
    slots = np.array([2, 0], np.int32)
    lengths = np.array([9, 16], np.int32)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    T = 4
    if kind == "paged":
        nb = SLOTS * MAX_LEN // BS
        pool = BlockPool(nb, BS, SLOTS, MAX_LEN // BS)
        for s, n in zip(slots, lengths):
            pool.alloc(int(s), int(n) + T)
        jcache = jm.init_paged_cache(SLOTS, nb, BS, dtype=jnp.float32)
        tcache = tm.init_paged_cache(nb, BS, dtype=torch.float32)
        pre_tab, ver_tab = pool.tables[slots], pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
        pre_tab = ver_tab = None
    jctx, tctx = _ctxs()
    _, jcache, _ = jax.jit(lambda p, t, c, s, n, tb: jm.prefill(
        p, {"tokens": t}, c, jctx, slots=s, lengths=n, block_tables=tb))(
        jp, jnp.asarray(toks), jcache, jnp.asarray(slots),
        jnp.asarray(lengths),
        None if pre_tab is None else jnp.asarray(pre_tab))
    with torch.no_grad():
        tm.prefill(tp, torch.from_numpy(toks).long(), tcache, tctx,
                   slots=torch.from_numpy(slots),
                   lengths=torch.from_numpy(lengths),
                   block_tables=None if pre_tab is None
                   else torch.from_numpy(pre_tab))
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    valid = np.array([1, 0, 4], np.int32)
    window = rng.integers(1, 256, size=(SLOTS, T)).astype(np.int32)
    jl, jcache, jf = jax.jit(lambda p, t, c, q, v, tb: jm.verify(
        p, t, c, q, jctx, v, block_tables=tb))(
        jp, jnp.asarray(window), jcache, jnp.asarray(pos),
        jnp.asarray(valid),
        None if ver_tab is None else jnp.asarray(ver_tab))
    with torch.no_grad():
        tl, tcache, tf = tm.verify(
            tp, torch.from_numpy(window).long(), tcache,
            torch.from_numpy(pos), tctx, torch.from_numpy(valid),
            block_tables=None if ver_tab is None
            else torch.from_numpy(ver_tab))
    for b, n in enumerate(valid):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)
    np.testing.assert_allclose(tcache[0]["latent"].numpy(),
                               _ref_latents(jcache)[0], atol=1e-5,
                               rtol=1e-5)
    assert not bool(tf) and not bool(jf)


def test_verify_refuses_the_moe_layer(stack):
    """Verify through the MoE layer is ported (the name is the refusal
    this test held before)."""
    jm, jp, tm, tp = stack
    cache = tm.init_cache(1, 16, dtype=torch.float32)
    with torch.no_grad():
        logits, _, flag = tm.verify(
            tp, torch.ones(1, 2, dtype=torch.long), cache,
            torch.zeros(1, dtype=torch.int32), LayerCtx(),
            torch.full((1,), 2))
    assert logits.shape == (1, 2, tm.cfg.vocab_size) and not bool(flag)
    assert bool(torch.isfinite(logits).all())


def test_train_step_with_the_mtp_loss_matches_reference(stack):
    """The total loss carries ``mtp_loss_coef`` x the MTP head's NLL of
    token t + 2 (masked where t + 1 or t + 2 has no label); the gradient
    reaches the MTP head."""
    jm, jp, tm, tp = stack
    jab = JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)
    tab = ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)
    batch = JSynth(JData(global_batch=2, seq_len=16,
                         vocab_size=256)).batch(0)
    batch["labels"][1, -3:] = -1                     # masked labels
    jpar, _, jmet = jax.jit(jstep_fn(jm, jab, JTrainConfig()))(
        jp, jopt.init_opt_state(jp, jopt.OptConfig()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tpar, _, tmet = make_train_step(tm, tab, TrainConfig(), device="cpu")(
        tp, topt.init_opt_state(tp, topt.OptConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    # the MTP term is in the total: without it the totals part
    no_mtp = make_train_step(tm, tab, TrainConfig(mtp_loss_coef=0.0),
                             device="cpu")(
        tp, topt.init_opt_state(tp, topt.OptConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})[2]
    assert float(tmet["total_loss"]) - float(no_mtp["total_loss"]) > 0.5
    moved = (tpar["mtp"]["proj"] - tp["mtp"]["proj"]).abs().max()
    np.testing.assert_allclose(
        tpar["mtp"]["proj"].numpy(), np.asarray(jpar["mtp"]["proj"]),
        atol=1e-6)
    assert moved > 0
    assert not bool(tmet["abft_flag"])


def test_the_model_constructs_at_full_size():
    cfg = get_config(ARCH)
    m = Model(cfg)
    assert tmodel.seg_plan(cfg)[0].repeats == cfg.first_dense_layers == 3
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(cfg, mtp_depth=2))
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(cfg, kv_lora_rank=0))
    assert m.supports_prefix_sharing and m.supports_chunked_prefill


@pytest.mark.parametrize("flags", [[], ["--cache", "paged",
                                        "--prefix-sharing",
                                        "--chunk-tokens", "8",
                                        "--inject-faults"]],
                         ids=["plain", "paged_shared_chunked_fault"])
def test_the_launcher_serves_deepseek(capsys, flags):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                       "3", "--new-tokens", "4", "--slots", "2"]
                      + flags) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tokens"] == 12 and line["errors"] == {}
    if "--inject-faults" in flags:
        assert line["faults_detected"] >= 1


def test_the_launchers_refuse_speculation_and_train_deepseek(capsys):
    from repro_torch.launch import serve, train

    # speculation on the MoE stack is ported: the launcher serves with it
    assert serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                       "2", "--new-tokens", "3", "--spec-decode",
                       "ngram"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "spec_decode"]["draft_len"] >= 1
    assert train.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                       "--batch", "2", "--seq", "16"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["steps"] == 2 and np.isfinite(rec["last_loss"])
