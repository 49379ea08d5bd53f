"""Model parity: the port's dense GQA stack against the reference
``Model`` on scaled-down llama3.2-1b (2 layers, f32, the reference's own
parameters converted through numpy), for engine-style ragged prefill and
per-slot decode on the dense and the paged cache, with fused-ABFT flash
decode on and off.

Tolerance: logits within 1e-4 absolute (f32; sums in another order, and
the reference runs the block schemes through its XLA emulation while the
port runs the K1 plain version).  Flags must be equal — clean and with an
injected ``mlp_down`` fault.
"""

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
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.paged_cache import BlockPool

torch.set_num_threads(1)

SLOTS, MAX_LEN, BS = 3, 32, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, Model(cfg), tp


def _ctxs(flash, fault):
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU,
                                       flash_attention=flash),
                fault=None if not fault else JMF.at(
                    1, "mlp_down", JFault.value(0, 2, 1e4)))
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E,
                                                flash_attention=flash),
                    fault=None if not fault else ModelFault.at(
                        1, "mlp_down", FaultSpec.value(0, 2, 1e4)))
    return jctx, tctx


def _run(models, kind, flash, fault_prefill=False, fault_decode=False):
    jm, jp, tm, tp = models
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
        pre_tab = pool.tables[slots]
        dec_tab = pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
        pre_tab = dec_tab = None
    jctx, tctx = _ctxs(flash, fault_prefill)
    jl, jcache, jf = jm.prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcache, jctx,
        slots=jnp.asarray(slots), lengths=jnp.asarray(lengths),
        block_tables=None if pre_tab is None else jnp.asarray(pre_tab))
    tl, tcache, tf = tm.prefill(
        tp, torch.from_numpy(toks).long(), tcache, tctx,
        slots=torch.from_numpy(slots), lengths=torch.from_numpy(lengths),
        block_tables=None if pre_tab is None else torch.from_numpy(pre_tab))
    out = {"prefill": (np.asarray(jl), tl.numpy(), bool(jf), bool(tf))}
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    tok = rng.integers(1, 256, size=(SLOTS, 1)).astype(np.int32)
    jctx, tctx = _ctxs(flash, fault_decode)
    jl, _, jf = jm.decode(
        jp, jnp.asarray(tok), jcache, jnp.asarray(pos), jctx,
        block_tables=None if dec_tab is None else jnp.asarray(dec_tab))
    tl, _, tf = tm.decode(
        tp, torch.from_numpy(tok).long(), tcache, torch.from_numpy(pos),
        tctx,
        block_tables=None if dec_tab is None else torch.from_numpy(dec_tab))
    out["decode"] = (np.asarray(jl), tl.numpy(), bool(jf), bool(tf))
    return out


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_prefill_and_decode_logits_match_reference(models, kind, flash):
    out = _run(models, kind, flash)
    for phase, (jl, tl, jf, tf) in out.items():
        active = [0, 2] if phase == "decode" else slice(None)
        np.testing.assert_allclose(tl[active], jl[active], atol=1e-4,
                                   rtol=1e-4, err_msg=phase)
        assert jf is False and tf is False, phase


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_fault_flags_match_reference(models, kind, flash):
    pre = _run(models, kind, flash, fault_prefill=True)["prefill"]
    assert pre[2] is True and pre[3] is True
    dec = _run(models, kind, flash, fault_decode=True)["decode"]
    assert dec[2] is True and dec[3] is True


def test_paged_decode_equals_dense_decode(models):
    dense = _run(models, "dense", False)["decode"][1]
    paged = _run(models, "paged", False)["decode"][1]
    np.testing.assert_allclose(paged[[0, 2]], dense[[0, 2]], atol=1e-5)


def test_seeded_init_is_deterministic_and_scaled():
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    a = Model(cfg).init_params(7, dtype=torch.float32)
    b = Model(cfg).init_params(7, dtype=torch.float32)
    assert torch.equal(a["embed"], b["embed"])
    assert abs(a["layers"][1]["ffn"]["down"].std().item() - 0.02) < 2e-3
    assert len(a["layers"]) == 2 and "lm_head" not in a


def test_unported_architectures_raise():
    import dataclasses

    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    moe = dict(n_experts=4, experts_per_token=2, moe_d_ff=32)
    for ok in (dict(qk_norm=True), dict(qkv_bias=True), dict(rope_pct=0.25),
               dict(norm="layernorm"), moe, dict(mtp_depth=1),
               dict(act="gelu"), dict(is_encoder_decoder=True),
               dict(cross_attn_every=2, vision_dim=32),
               dict(pad_heads_to=8), dict(pad_heads_to=8, pad_kv_heads_to=4)):
        Model(dataclasses.replace(cfg, **ok))
    # TP head padding that breaks the kv-major groups (4 q heads over 4 kv
    # heads where 2 share one): the reference's assert, as a ValueError
    with pytest.raises(ValueError, match="invalid head padding"):
        Model(dataclasses.replace(cfg, pad_kv_heads_to=4))
    # attention="mla" on llama has no latent ranks: not an MLA to run; the
    # GELU FFN is ported for dense FFNs only, cross-attention for GQA
    # layers with a memory to read
    for bad in (dict(act="relu"), dict(attention="mla"), dict(family="ssm"),
                dict(norm="scalenorm"), dict(mtp_depth=2),
                dict(act="gelu", **moe), dict(family="ssm",
                                              cross_attn_every=2),
                dict(cross_attn_every=2)):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(cfg, **bad))
