"""TP head padding (``pad_heads_to``/``pad_kv_heads_to``) in the port,
held against the reference (``tests/test_head_padding.py``'s five cases,
its parameters through numpy): the padded model computes the logical one
(padded heads have zero K/V projections and zero ``wo`` rows, so their
attention never reaches the residual stream), its caches hold the padded
kv heads, and the kv-major (kv, group) layout is kept.

Then what padding is for: a 5-head stack refuses k = 2 (the rules would
split a q head) and runs its attention whole on every rank at k = 3;
padded to 6 its attention shards, and it serves at k = 2 and 3 over gloo
ranks, flash attention on (K2's and K3's plain versions on the CPU), and
every stream and ``EngineStats`` field equals the unpadded local run's
(the same seed draws the same logical weights: ``init_gqa`` draws at the
logical shapes, then pads).

The reference caveat, mirrored: the plan counts the logical heads
(reference ``models/counting.py:82-84, 118-120``), so a padded stack's
plan rows for q/k/v/o are narrower than the GEMMs that run, and the
audit's plan crosscheck reports those sites' dims apart.

Tolerances: the padded and unpadded forwards agree to 1e-5 in f32 (the
reference's own bound), and the port's to the reference's to 1e-4 (f32
sums in other orders through 2 layers).  With the same seed's weights the
padded and unpadded bf16 runs are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_mesh_worker as W
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, build_model
from repro.models.attention import eff_counts as j_eff_counts
from repro.models.counting import layer_gemms as j_layer_gemms
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.protected import ABFTConfig
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import Mesh
from repro_torch.models.attention import eff_counts
from repro_torch.models.counting import layer_gemms
from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.executor import check_shardable

torch.set_num_threads(1)

CTX = LayerCtx(abft=ABFTConfig())
TOKENS = np.arange(32, dtype=np.int32).reshape(2, 16) % 17


def _pair(arch="qwen1.5-32b", pad=6, pad_kv=6, **over):
    """(reference, port) configs of the reference's ``_models``: 5 heads,
    5 kv heads, head dim 16, padded to ``pad`` / ``pad_kv``."""
    kw = dict(n_heads=5, n_kv_heads=5, head_dim=16, **over)
    jb, b = jscaled(jget(arch), **kw), scaled_down(get_config(arch), **kw)
    return ((jb, dataclasses.replace(jb, pad_heads_to=pad,
                                     pad_kv_heads_to=pad_kv)),
            (b, dataclasses.replace(b, pad_heads_to=pad,
                                    pad_kv_heads_to=pad_kv)))


def _graft(pb, pp, hd):
    """The reference test's graft: the logical block of ``pb`` at the
    first heads of ``pp``'s padded head axis, zeros elsewhere."""
    if pb.shape == pp.shape:
        return pb
    ax = next(i for i in range(pb.ndim) if pb.shape[i] != pp.shape[i])
    lead, tail = pb.shape[:ax], pb.shape[ax + 1:]
    z = jnp.zeros_like(pp).reshape(lead + (pp.shape[ax] // hd, hd) + tail)
    idx = tuple([slice(None)] * len(lead) + [slice(0, pb.shape[ax] // hd)])
    return z.at[idx].set(pb.reshape(lead + (pb.shape[ax] // hd, hd) + tail)
                         ).reshape(pp.shape)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------- the reference's five cases
@pytest.mark.parametrize("arch,pads,heads,want", [
    ("qwen1.5-32b", (6, 6), (5, 5), (6, 6)),
    ("qwen1.5-32b", (0, 0), (5, 5), (5, 5)),
    ("llama3.2-1b", (6, 2), (4, 2), (6, 2)),
    ("llama3.2-1b", (40, 10), (32, 8), (40, 10))])
def test_eff_counts(arch, pads, heads, want):
    """``eff_counts`` equals the reference's, and a padding that breaks
    the kv-major groups raises as the reference's asserts."""
    kw = dict(n_heads=heads[0], n_kv_heads=heads[1], head_dim=8,
              pad_heads_to=pads[0], pad_kv_heads_to=pads[1])
    cfg = dataclasses.replace(scaled_down(get_config(arch)), **kw)
    jcfg = dataclasses.replace(jscaled(jget(arch)), **kw)
    assert eff_counts(cfg) == j_eff_counts(jcfg) == want
    with pytest.raises(ValueError, match="invalid head padding"):
        eff_counts(dataclasses.replace(cfg, pad_heads_to=want[0] + 1))


def test_padded_params_embed_logical_weights():
    """The padded draw embeds the unpadded model's weights of the same
    seed at their kv-major places, zeros in the padded head slots of
    ``wq``, ``wk``, ``wv``, their biases and ``wo``'s rows; the leaves'
    shapes equal the reference's padded ``init_params``'."""
    (jb, jp), (base, padded) = _pair()
    hd = padded.resolved_head_dim
    p = Model(padded).init_params(0, dtype=torch.float32)
    b = Model(base).init_params(0, dtype=torch.float32)
    mx, bx = p["layers"][0]["mixer"], b["layers"][0]["mixer"]
    assert mx["wq"].shape == (padded.d_model, 6 * hd)
    w4 = mx["wq"].reshape(padded.d_model, 6, hd)
    assert torch.all(w4[:, 5:] == 0)
    assert torch.equal(w4[:, :5].reshape(padded.d_model, -1), bx["wq"])
    wo4 = mx["wo"].reshape(6, hd, padded.d_model)
    assert torch.all(wo4[5:] == 0)
    assert torch.equal(wo4[:5].reshape(-1, padded.d_model), bx["wo"])
    for name in ("bq", "bk", "bv"):
        assert mx[name].shape == (6 * hd,)
    ref = _np(build_model(jp).init_params(jax.random.PRNGKey(0),
                                          dtype=jnp.float32))
    assert params_from_reference(padded, ref)["layers"][0]["mixer"][
        "wq"].shape == mx["wq"].shape


def test_forward_exact_equivalence():
    """The reference's padded tree (its test's graft of the logical
    weights) through ``params_from_reference`` gives the unpadded port's
    logits and the reference's, in f32."""
    (jb, jp), (base, padded) = _pair()
    mb, mp = build_model(jb), build_model(jp)
    pb = mb.init_params(jax.random.PRNGKey(7), dtype=jnp.float32)
    pp = mp.init_params(jax.random.PRNGKey(7), dtype=jnp.float32)
    hd = base.resolved_head_dim
    pp = jax.tree_util.tree_map(lambda a, b: _graft(a, b, hd), pb, pp)
    want = np.asarray(mp.forward(pp, {"tokens": jnp.asarray(TOKENS)},
                                 JCtx(abft=JABFT.off())).logits)
    tb = params_from_reference(base, _np(pb))
    tp = params_from_reference(padded, _np(pp))
    with torch.no_grad():
        lb = Model(base).forward(tb, {"tokens": TOKENS}, CTX,
                                 device="cpu").logits.numpy()
        lp = Model(padded).forward(tp, {"tokens": TOKENS}, CTX,
                                   device="cpu").logits.numpy()
    np.testing.assert_allclose(lp, lb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp, want, rtol=1e-4, atol=1e-4)


def test_padded_decode_cache_shape():
    """The dense and paged caches hold the padded kv heads, as the
    reference's dense cache does."""
    (_, jp), (_, padded) = _pair()
    m = Model(padded)
    jk = build_model(jp).init_cache(2, 8, dtype=jnp.float32)[0]["pos0"][
        "attn"]["k"]
    k = m.init_cache(2, 8, dtype=torch.float32)[0]["k"]
    assert k.shape[-2] == jk.shape[-2] == 6
    assert m.init_paged_cache(4, 8, dtype=torch.float32)[0]["k"].shape == \
        (4, 8, 6, padded.resolved_head_dim)


def test_gqa_group_padding():
    """GQA: 4 / 2 heads padded to 6 / 2 pad each kv head's group (the
    kv-major layout kept): the zero slots are the reference's."""
    from repro.models.attention import init_gqa as j_init_gqa

    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    base = scaled_down(get_config("llama3.2-1b"), **kw)
    padded = dataclasses.replace(base, pad_heads_to=6, pad_kv_heads_to=2)
    jpad = dataclasses.replace(jscaled(jget("llama3.2-1b"), **kw),
                               pad_heads_to=6, pad_kv_heads_to=2)
    assert eff_counts(padded) == (6, 2)
    w = Model(padded).init_params(0, dtype=torch.float32)["layers"][0][
        "mixer"]["wq"].reshape(padded.d_model, 2, 3, 8).numpy()
    jw = np.asarray(j_init_gqa(jpad, jax.random.PRNGKey(0), jnp.float32)[
        "wq"]).reshape(padded.d_model, 2, 3, 8)
    assert np.all(w[:, :, 2:] == 0) and np.any(w[:, :, :2] != 0)
    assert np.array_equal(w == 0, jw == 0)


# ------------------------------------------------ flash on, one process
def test_padded_flash_forward_and_decode_equal_unpadded():
    """With flash attention on (K2 in the forward, K3 at decode, their
    plain versions here) the padded stack's forward logits and its
    dense and paged served streams equal the unpadded stack's (same
    seed, bf16)."""
    base, padded = W.pad_configs()
    flash = LayerCtx(abft=ABFTConfig(flash_attention=True))
    out, streams = {}, {}
    for name, cfg in (("base", base), ("padded", padded)):
        m = Model(cfg)
        p = m.init_params(0, dtype=torch.bfloat16)
        with torch.no_grad():
            out[name] = m.forward(p, {"tokens": TOKENS}, flash,
                                  device="cpu").logits
        for kind in ("dense", "paged"):
            eng = ServeEngine(m, p, slots=3, max_len=64, dtype=torch.bfloat16,
                              device="cpu", cache_kind=kind, block_size=8,
                              abft=ABFTConfig(flash_attention=True))
            streams[name, kind] = {int(u): list(map(int, s)) for u, s in
                                   eng.run(W.reqs(cfg)).items()}
    assert torch.equal(out["base"], out["padded"])
    for kind in ("dense", "paged"):
        assert streams["base", kind] == streams["padded", kind]


# -------------------------------------------------- padded over k ranks
def _model_mesh(k):
    return Mesh(grid=np.arange(k).reshape(1, k),
                axis_names=("data", "model"),
                devices=(torch.device("cpu"),) * k)


@pytest.fixture(scope="module")
def unpadded_local():
    base, _ = W.pad_configs()
    model = Model(base)
    params = model.init_params(0, dtype=torch.bfloat16)
    recs, _ = W.stack_scenarios(model, params, None, W.PAD_NAMES,
                                W.PAD_FAULTS, W.BF16,
                                abft=ABFTConfig(flash_attention=True))
    return recs


@pytest.fixture(scope="module", params=[2, 3], ids=["k2", "k3"])
def padded_ranks(request):
    k = request.param
    params = Model(W.pad_configs()[1]).init_params(0, dtype=torch.bfloat16)
    return k, spawn.run(W.padding_rank, k, k, params, True, device="cpu")


@pytest.mark.parametrize("k", [2, 3])
def test_padding_makes_the_heads_divide_the_axis(k):
    """5 heads of 16 over 2 ranks would split a q head (80 columns divide
    by 2, 5 heads do not): refused, naming ``pad_heads_to``.  Over 3 the
    80 columns do not divide, so the rules replicate the attention on
    every rank.  Padded to 6 the stack's attention shards at both."""
    from repro_torch.distributed.sharding import param_specs

    base, padded = W.pad_configs()
    if k == 2:
        with pytest.raises(NotImplementedError,
                           match="pad_heads_to.*A.3b-ii"):
            check_shardable(base, _model_mesh(k))
    else:
        check_shardable(base, _model_mesh(k))
        specs = param_specs(base, Model(base).param_shapes(), _model_mesh(k))
        assert "model" not in specs["layers"][0]["mixer"]["wq"]
    check_shardable(padded, _model_mesh(k))
    specs = param_specs(padded, Model(padded).param_shapes(), _model_mesh(k))
    mixer = specs["layers"][0]["mixer"]
    assert all("model" in mixer[n] for n in ("wq", "wk", "wv", "wo"))


@pytest.mark.parametrize("name", W.PAD_NAMES)
def test_padded_mesh_streams_equal_unpadded_local(padded_ranks,
                                                  unpadded_local, name):
    """Every scenario of the padded stack at k = 2 and 3 equals the
    unpadded local run on every rank (streams, errors, every
    ``EngineStats`` field but the plan's intensities, blocks)."""
    k, recs = padded_ranks
    want = W.comparable(unpadded_local[name])
    for r, rec in enumerate(recs):
        assert W.comparable(rec["scenarios"][name]) == want, (k, r, name)


def test_padded_mesh_runs_its_shards(padded_ranks, unpadded_local):
    """Each rank holds 6 / k q heads and kv heads (the padded counts
    divide the axis), its cache 6 / k kv heads; the faults were retried
    and the eviction ran."""
    k, recs = padded_ranks
    hd = W.pad_configs()[1].resolved_head_dim
    for rec in recs:
        assert rec["wq"][1] == 6 * hd // k
        assert rec["cache"][2] == 6 // k
        assert {"mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo", "mixer/bq",
                "mixer/bk", "mixer/bv"} <= set(rec["sharded"])
    st = unpadded_local["qkv_faults"]["stats"]
    assert st["faults_detected"] >= 2 and st["hard_faults"] == 0
    assert unpadded_local["hard_fault"]["stats"]["evictions"] >= 1


# ------------------------------------------------ the reference caveat
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plan_counts_logical_heads(k):
    """The reference caveat: its counting (and the port's copy) sizes the
    q/k/v/o sites by the logical heads, so the padded stack's plan equals
    the unpadded one's and its q/o rows are narrower than the GEMMs that
    run; the audit's crosscheck sees exactly those sites' dims apart."""
    base, padded = W.pad_configs()
    jpad = dataclasses.replace(jscaled(jget("qwen1.5-32b"), n_heads=5,
                                       n_kv_heads=5, head_dim=16),
                               pad_heads_to=6, pad_kv_heads_to=6)
    ours = layer_gemms(padded, 4, model_parallel=k)
    theirs = j_layer_gemms(jpad, 4, model_parallel=k)
    assert {n: (d.k, d.n, c) for n, (d, c) in ours.items()} == \
        {n: (d.k, d.n, c) for n, (d, c) in theirs.items()}
    assert ours == layer_gemms(base, 4, model_parallel=k)
    hd = padded.resolved_head_dim
    n = 5 * hd // k if (5 * hd) % k == 0 else 5 * hd
    assert ours["attn.q"][0].n == n
    assert ours["attn.o"][0].k == n


def test_audit_sees_the_padded_gemms_apart_from_the_plan():
    """A padded engine's decode step: protected fraction 1.0 (every GEMM
    under ABFT), the crosscheck's dims apart at q, k, v and o only."""
    from repro_torch.analysis.audit import audit_served_step

    _, padded = W.pad_configs()
    m = Model(padded)
    eng = ServeEngine(m, m.init_params(0, dtype=torch.bfloat16), slots=2,
                      max_len=32, dtype=torch.bfloat16, device="cpu")
    eng.admit(W.reqs(padded, n=2, new_tokens=4))
    a = audit_served_step(eng, eng.step).to_json()
    assert a["protected_fraction"] == 1.0
    apart = {d["site"] for d in a["crosscheck"]["dim_mismatches"]}
    assert apart == {"attn.q", "attn.k", "attn.v", "attn.o"}
    assert not a["crosscheck"]["plan_only"]
    assert not a["crosscheck"]["trace_only"]
