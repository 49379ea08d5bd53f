"""The memory path in the port against the reference, on the CPU in f32:
whisper-tiny (an encoder of 2 layers, its memory from ``enc_input``
frames or from ``audio`` through the conv stem) and llama-3.2-vision-11b
(layer 0 of 2 a cross layer over 8 projected image tokens), both at
``scaled_down``, params carried across by ``params_from_reference``.

Both trees get the same seeded non-zero biases, norm gains and shifts,
and cross gates of ``GATE``: the reference starts its gates at 0, where
the images never reach the logits and nothing of the cross path would be
compared.  Compared: the params and cache layouts, ``_memory``, the
forward's logits, flag and aux loss (clean, with a fault at ``qkv`` in
layer 0, which fires in the encoder's layer 0 as well, and at
``cross_qkv``, which fires in ``vision.proj``), greedy ``prefill`` +
``decode`` on the batch-deep and the paged cache (logits, tokens, flags
and the cross K/V), one train step's loss and every gradient, whisper
with flash attention on against the reference's Pallas interpret mode,
``verify``, and the engines' refusals.

The reference runs its block schemes through the XLA emulation
(``use_pallas=False``), the port the K1 plain versions.  Tolerances (f32,
sums in another order): logits, memory and cache leaves within 1e-4
absolute and relative; the loss within 1e-5 and each gradient within
1e-4 of its leaf's scale; greedy tokens and flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_shared_runners import shared_runners
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine
from repro.train.train_step import (
    TrainConfig as JTrainConfig,
    make_loss_fn as jloss_fn,
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
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_cache import BlockPool
from repro_torch.train.train_step import (
    TrainConfig,
    make_loss_fn,
    value_and_grad,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _shared_reference_runners():
    """The reference's engines share their jitted steps
    (``test_torch_shared_runners``)."""
    with shared_runners():
        yield


WHISPER, VISION = "whisper-tiny", "llama-3.2-vision-11b"
# (arch, the memory input it reads)
VARIANTS = [(WHISPER, "enc_input"), (WHISPER, "audio"), (VISION, "images")]
IDS = ["whisper-enc_input", "whisper-audio", "vision"]
GATE = 0.7
SLOTS, MAX_LEN, BS = 3, 32, 8
TOL = dict(atol=1e-4, rtol=1e-4)
NORMS = ("mixer_norm", "ffn_norm", "cross_norm", "final_norm")


def _perturb(tree, rng, parent=""):
    """Seeded non-zero biases (``b`` of a LayerNorm, ``up_b``,
    ``down_b``, the stem's ``b1``/``b2``), norm gains 1 + N(0, 0.1) and
    cross gates of ``GATE``, in place on a numpy tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng, k)
        elif isinstance(v, list):
            for s in v:
                _perturb(s, rng, k)
        elif k == "cross_gate":
            tree[k] = np.full(v.shape, GATE, v.dtype)
        elif k in ("up_b", "down_b", "b1", "b2") or (
                parent in NORMS and k in ("w", "b")):
            tree[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)


def build_pair(arch):
    """The reference's model and params (seed 1, f32, perturbed) at
    ``scaled_down`` ``arch``, and the port's, carried across."""
    jm = build_model(jscaled(jget(arch)))
    np_p = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(1), dtype=jnp.float32))
    _perturb(np_p, np.random.default_rng(5))
    cfg = scaled_down(get_config(arch))
    return (jm, jax.tree_util.tree_map(jnp.asarray, np_p), Model(cfg),
            params_from_reference(cfg, np_p))


@pytest.fixture(scope="module")
def pairs():
    return {arch: build_pair(arch) for arch in (WHISPER, VISION)}


def _memory_inputs(cfg, name, B, seed=0):
    rng = np.random.default_rng(seed)
    shape = {"enc_input": (B, cfg.enc_seq_len, cfg.d_model),
             "audio": (B, 2 * cfg.enc_seq_len, cfg.n_mels),
             "images": (B, cfg.n_image_tokens, cfg.vision_dim)}[name]
    return {name: rng.standard_normal(shape).astype(np.float32)}


# the reference's entry points jitted, one compile a (model, entry,
# context) (its op-by-op run through the encoder or the cross layers
# takes several times longer); the positions of ``ctx`` in each call
_CTX_AT = {"_memory": 2, "forward": 2, "prefill": 3, "decode": 4}
_JITTED: dict = {}


def _ref(jm, entry: str, jctx):
    """``jm.<entry>`` with ``jctx`` in its place, under ``jax.jit`` (the
    context keyed by its repr: a fault holds arrays)."""
    key = (id(jm), entry, repr(jctx))
    if key not in _JITTED:
        fn, n = getattr(jm, entry), _CTX_AT[entry]
        _JITTED[key] = (jm, jax.jit(
            lambda *a, **kw: fn(*a[:n], jctx, *a[n:], **kw)))
    return _JITTED[key][1]


def _batches(toks, mem):
    """(reference batch, port batch) of tokens and memory inputs."""
    jb = {"tokens": jnp.asarray(toks),
          **{k: jnp.asarray(v) for k, v in mem.items()}}
    tb = {"tokens": torch.from_numpy(toks).long(),
          **{k: torch.from_numpy(v) for k, v in mem.items()}}
    return jb, tb


def _ctxs(fault=None, flash=False):
    jf = tf = None
    if fault is not None:
        site, layer = fault
        jf = JMF.at(layer, site, JFault.value(0, 2, 1e4))
        tf = ModelFault.at(layer, site, FaultSpec.value(0, 2, 1e4))
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                       hardware=JTPU, flash_attention=flash),
                fault=jf)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(
        IntensityGuidedPolicy(), hardware=TPU_V5E, flash_attention=flash),
        fault=tf)
    return jctx, tctx


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_params_cross_over_with_the_ports_own_layout(pairs, arch):
    jm, jp, tm, tp = pairs[arch]
    own = tm.init_params(0, dtype=torch.float32)
    got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tp)}
    assert got == {p: tuple(t.shape) for p, t in tree_leaves_with_path(own)}
    tags = tmodel.layer_tags(tm.cfg)
    assert [tmodel._layer_kind(lp) for lp in tp["layers"]] == tags
    if arch == WHISPER:
        assert tags == ["attn:dense:0"] * 2 and not any(tm.cross_layers)
        assert len(tp["encoder"]["layers"]) == tm.cfg.n_enc_layers == 2
        assert set(tp["layers"][0]["ffn"]) == {"up", "down", "up_b",
                                               "down_b"}
        assert tp["conv_stem"]["w1"].shape == (3, 8, 64)
        assert tm.memory_inputs == ("audio", "enc_input")
    else:
        assert tags == ["attn:dense:1", "attn:dense:0"]
        assert float(tp["layers"][0]["cross_gate"]) == pytest.approx(GATE)
        assert float(own["layers"][0]["cross_gate"]) == 0.0
        assert tp["vision_proj"].shape == (32, 64)
        assert tm.memory_inputs == ("images",)
    bf = params_from_reference(tm.cfg, jax.tree_util.tree_map(np.asarray, jp),
                               dtype=torch.bfloat16)
    assert bf["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    if arch == VISION:
        assert bf["layers"][0]["cross_gate"].dtype == torch.float32
        assert own["layers"][0]["cross_gate"].dtype == torch.float32


def test_cache_layouts_are_the_references(pairs):
    """The vision stack's cross layer holds ``cross`` K/V (slots, 8, KV,
    hd) beside its self-attention cache, dense and paged, as the
    reference's; the paged cache needs the slot count; ``kv_leaf``,
    ``cell_leaves`` and the COW block copy never touch it."""
    jm, jp, tm, tp = pairs[VISION]
    nb = SLOTS * MAX_LEN // BS
    for tc, jc in ((tm.init_cache(SLOTS, MAX_LEN, dtype=torch.bfloat16),
                    jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.bfloat16)),
                   (tm.init_paged_cache(nb, BS, dtype=torch.bfloat16,
                                        slots=SLOTS),
                    jm.init_paged_cache(SLOTS, nb, BS,
                                        dtype=jnp.bfloat16))):
        unit = jc[0]
        for q in range(2):
            want = unit[f"pos{q}"]
            got = tc[q]
            assert set(got) == set(want["attn"]) | (
                {"cross"} if "cross" in want else set())
            for k, leaf in want.get("cross", {}).items():
                assert tuple(got["cross"][k].shape) == tuple(leaf.shape[1:])
                assert got["cross"][k].dtype == torch.bfloat16
        assert tm.kv_leaf(tc) is tc[0]["k"]
        assert tmodel.cell_leaves(tc[0]) == [tc[0]["k"], tc[0]["v"]]
    with pytest.raises(ValueError, match="slot count"):
        tm.init_paged_cache(nb, BS)
    tc[0]["cross"]["k"].fill_(3.0)
    tc[0]["k"][1].fill_(1.0)
    tm.copy_paged_blocks(tc, [1], [2])
    assert bool((tc[0]["k"][2] == 1).all())
    assert bool((tc[0]["cross"]["k"] == 3).all())


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
@pytest.mark.parametrize("fault", [None, ("qkv", 0), ("cross_qkv", 1)])
def test_memory_and_forward_match_reference(pairs, variant, fault):
    """``_memory`` (the encoder's output or the projected images, and its
    flag) and the forward's logits, flag and aux loss.  A ``qkv`` fault
    at layer 0 fires in whisper's encoder too (its layers are numbered
    from 0 like the decoder's); a ``cross_qkv`` fault aimed at layer 1
    (no cross layer) fires in ``vision.proj``, which has no layer index,
    and nowhere in whisper."""
    arch, name = variant
    jm, jp, tm, tp = pairs[arch]
    B = 1 if fault else 2
    toks = np.random.default_rng(3).integers(1, 256, size=(B, 13)).astype(
        np.int32)
    jb, tb = _batches(toks, _memory_inputs(tm.cfg, name, B))
    jctx, tctx = _ctxs(fault)
    jmem, jmf = _ref(jm, "_memory", jctx)(jp, jb)
    jo = _ref(jm, "forward", jctx)(jp, jb)
    with torch.no_grad():
        tmem, tmf = tm._memory(tp, tb, tctx, torch.device("cpu"))
        to = tm.forward(tp, tb, tctx, device="cpu")
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **TOL)
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss),
                               atol=1e-7)
    want_mem = fault is not None and (fault[0] == "qkv") == (arch == WHISPER)
    assert bool(tmf) == bool(jmf) == want_mem
    assert bool(to.flag) == bool(jo.flag) == (
        fault is not None and (fault[0] == "qkv" or arch == VISION))


def test_what_reaches_the_logits(pairs):
    """As in the reference: whisper's logits do not depend on its audio
    (no decoder layer reads the memory), the vision model's depend on its
    images through an open gate and not through a closed one."""
    toks = np.ones((1, 6), np.int32)
    for arch, name in ((WHISPER, "audio"), (VISION, "images")):
        jm, jp, tm, tp = pairs[arch]
        outs = []
        for seed in (0, 1):
            _, tb = _batches(toks, _memory_inputs(tm.cfg, name, 1, seed))
            with torch.no_grad():
                outs.append(tm.forward(tp, tb, LayerCtx(), device="cpu")
                            .logits)
        moved = (outs[0] - outs[1]).abs().max().item()
        assert (moved > 1e-3) == (arch == VISION), (arch, moved)
    closed = {**tp, "layers": [{**tp["layers"][0], "cross_gate":
                                torch.zeros(())}] + tp["layers"][1:]}
    outs = []
    for seed in (0, 1):
        _, tb = _batches(toks, _memory_inputs(tm.cfg, "images", 1, seed))
        with torch.no_grad():
            outs.append(tm.forward(closed, tb, LayerCtx(), device="cpu")
                        .logits)
    assert torch.equal(outs[0], outs[1])


def _cross_leaves(jm, jcache, tcache):
    """(name, reference leaf, port leaf) of every cross K/V."""
    out, i = [], 0
    for seg, segc in zip(jm.plan, jcache):
        for r in range(seg.repeats):
            for q in range(len(seg.unit)):
                for k, leaf in segc[f"pos{q}"].get("cross", {}).items():
                    out.append((f"{i}.{k}", np.asarray(leaf[r]),
                                tcache[i]["cross"][k].numpy()))
                i += 1
    return out


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_prefill_and_decode_match_reference(pairs, variant, kind):
    """A ragged admission of two prompts (9 and 16 tokens, each with its
    own memory) into slots 2 and 0 of 3, then 4 greedy decode steps of
    every slot: logits, tokens and flags, and the cross K/V the prefill
    wrote (unchanged through decode), equal the reference's."""
    arch, name = variant
    jm, jp, tm, tp = pairs[arch]
    rng = np.random.default_rng(11)
    lengths = np.array([9, 16], np.int32)
    slots = np.array([2, 0], np.int32)
    toks = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    jb, tb = _batches(toks, _memory_inputs(tm.cfg, name, 2, seed=4))
    steps = 4
    if kind == "paged":
        nb = SLOTS * MAX_LEN // BS
        pool = BlockPool(nb, BS, SLOTS, MAX_LEN // BS)
        for s in range(SLOTS):
            pool.alloc(s, (int(lengths[list(slots).index(s)])
                           if s in slots else 0) + steps + 1)
        jcache = jm.init_paged_cache(SLOTS, nb, BS, dtype=jnp.float32)
        tcache = tm.init_paged_cache(nb, BS, dtype=torch.float32,
                                     slots=SLOTS)
        pre_tab, dec_tab = pool.tables[slots], pool.tables
    else:
        jcache = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        tcache = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32)
        pre_tab = dec_tab = None
    jctx, tctx = _ctxs()
    jl, jcache, jf = _ref(jm, "prefill", jctx)(
        jp, jb, jcache, slots=jnp.asarray(slots),
        lengths=jnp.asarray(lengths),
        block_tables=None if pre_tab is None else jnp.asarray(pre_tab))
    with torch.no_grad():
        tl, tcache, tf = tm.prefill(
            tp, tb["tokens"], tcache, tctx, slots=torch.from_numpy(slots),
            lengths=torch.from_numpy(lengths),
            block_tables=None if pre_tab is None
            else torch.from_numpy(pre_tab),
            inputs={name: tb[name]})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not bool(jf) and not bool(tf)
    crossed = _cross_leaves(jm, jcache, tcache)
    assert bool(crossed) == (arch == VISION)
    for nm, j, t in crossed:
        np.testing.assert_allclose(t, j, err_msg=f"prefill {nm}", **TOL)
    before = [t.copy() for _, _, t in crossed]
    pos = np.zeros((SLOTS,), np.int32)
    pos[slots] = lengths
    tok = np.zeros((SLOTS, 1), np.int32)
    tok[slots, 0] = np.asarray(jl)[:, 0].argmax(-1)
    assert (tok[slots, 0] == tl[:, 0].argmax(-1).numpy()).all()
    for _ in range(steps):
        jl, jcache, jf = _ref(jm, "decode", jctx)(
            jp, jnp.asarray(tok), jcache, jnp.asarray(pos),
            block_tables=None if dec_tab is None else jnp.asarray(dec_tab))
        with torch.no_grad():
            tl, tcache, tf = tm.decode(
                tp, torch.from_numpy(tok).long(), tcache,
                torch.from_numpy(pos), tctx,
                block_tables=None if dec_tab is None
                else torch.from_numpy(dec_tab))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert not bool(jf) and not bool(tf)
        nxt = tl[:, 0].argmax(-1).numpy()
        assert (nxt == np.asarray(jl)[:, 0].argmax(-1)).all()
        tok = nxt[:, None].astype(np.int32)
        pos = pos + 1
    for b, (_, _, t) in zip(before, _cross_leaves(jm, jcache, tcache)):
        assert np.array_equal(b, t)


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_faulted_prefill_is_flagged_and_recomputes_clean(pairs, arch):
    """A one-row prefill with a fault at ``qkv`` in layer 0 (whisper:
    the encoder's and the decoder's) or at ``cross_qkv`` (vision: the
    projection and the cross layer's K/V) is flagged on both sides; the
    clean recompute into the same slot gives the clean run's logits and
    cross K/V bit for bit."""
    jm, jp, tm, tp = pairs[arch]
    name = "audio" if arch == WHISPER else "images"
    toks = np.random.default_rng(2).integers(1, 256, size=(1, 10)).astype(
        np.int32)
    jb, tb = _batches(toks, _memory_inputs(tm.cfg, name, 1, seed=9))
    fault = ("qkv", 0) if arch == WHISPER else ("cross_qkv", 0)
    slots = np.array([1], np.int32)
    outs = []
    for f in (fault, None, None):
        jctx, tctx = _ctxs(f)
        jc = jm.init_cache(SLOTS, MAX_LEN, dtype=jnp.float32)
        _, _, jf = _ref(jm, "prefill", jctx)(
            jp, jb, jc, slots=jnp.asarray(slots), lengths=jnp.asarray([10]))
        tc = tm.init_cache(SLOTS, MAX_LEN, dtype=torch.float32) \
            if not outs else outs[0][1]
        with torch.no_grad():
            tl, tc, tf = tm.prefill(tp, tb["tokens"], tc, tctx,
                                    slots=torch.from_numpy(slots),
                                    lengths=torch.tensor([10]),
                                    inputs={name: tb[name]})
        assert bool(tf) == bool(jf) == (f is not None)
        outs.append((tl.clone(), tc,
                     [t.clone() for lay in tc for t in
                      lay.get("cross", {}).values()]))
    assert not torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[1][0], outs[2][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[1][2], outs[2][2]))


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_train_step_loss_and_gradients_match_reference(pairs, variant):
    """One train step's loss (CE + z-loss) and the gradient of every
    leaf, the stem's, the encoder's, the projection's and the cross
    gate's included, with the memory in the batch."""
    arch, name = variant
    jm, jp, tm, tp = pairs[arch]
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 256, size=(2, 12)).astype(np.int32)
    labels = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    mem = _memory_inputs(tm.cfg, name, 2, seed=8)
    jb, tb = _batches(toks, mem)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(
        labels).long()
    jab = JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)
    tab = ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)
    (jl, _), jg = jax.value_and_grad(
        jloss_fn(jm, jab, JTrainConfig()), has_aux=True)(jp, jb)
    (tl, tmet), tg = value_and_grad(
        make_loss_fn(tm, tab, TrainConfig(), device="cpu"))(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert not bool(tmet["abft_flag"])
    want = params_from_reference(tm.cfg,
                                 jax.tree_util.tree_map(np.asarray, jg))
    got = dict(tree_leaves_with_path(tg))
    zero = set()
    for path, w in tree_leaves_with_path(want):
        g = got[path].numpy()
        scale = float(np.abs(w.numpy()).max())
        err = float(np.abs(g - w.numpy()).max())
        assert err <= 1e-4 * scale or err == scale == 0, (path, err, scale)
        if scale == 0:
            zero.add(path[0])
    # whisper's encoder and stem never reach the loss: zero gradients on
    # both sides (autograd leaves them unused)
    assert zero == ({"encoder", "conv_stem"} if arch == WHISPER else set())


def test_whisper_flash_matches_the_references_interpret_mode(pairs):
    """Flash attention on: K2 non-causal in the encoder (16 frames: one
    key block, no padding) and causal in the decoder (13 tokens, padded
    to 16), the reference's Pallas kernel in interpret mode, the port's
    plain version; a 1500-frame memory with flash on raises as the
    reference's wrapper asserts (1500 pads to 1536 at 128-key blocks)."""
    jm, jp, tm, tp = pairs[WHISPER]
    toks = np.random.default_rng(12).integers(1, 256, size=(2, 13)).astype(
        np.int32)
    jb, tb = _batches(toks, _memory_inputs(tm.cfg, "audio", 2, seed=13))
    jctx, tctx = _ctxs(flash=True)
    jo = jm.forward(jp, jb, jctx)
    with torch.no_grad():
        to = tm.forward(tp, tb, tctx, device="cpu")
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                                   **TOL)
        assert not bool(to.flag) and not bool(jo.flag)
        long = {"tokens": tb["tokens"][:1],
                "enc_input": torch.zeros(1, 1500, 64)}
        with pytest.raises(ValueError, match="non-causal padding"):
            tm.forward(tp, long, tctx, device="cpu")


def test_verify_on_whisper_is_the_references_and_refused_on_vision(pairs):
    """whisper verifies as the reference does, without the sinusoids its
    prefill and decode add (logits and flag, one window of 3 a row after
    a prefill); a cross stack raises, where the reference's verify would
    call ``cross_kv`` without a memory."""
    jm, jp, tm, tp = pairs[WHISPER]
    toks = np.random.default_rng(14).integers(1, 256, size=(2, 8)).astype(
        np.int32)
    jb, tb = _batches(toks, _memory_inputs(tm.cfg, "enc_input", 2))
    jctx, tctx = _ctxs()
    jc = jm.init_cache(2, MAX_LEN, dtype=jnp.float32)
    _, jc, _ = jm.prefill(jp, jb, jc, jctx)
    tc = tm.init_cache(2, MAX_LEN, dtype=torch.float32)
    win = np.random.default_rng(15).integers(1, 256, size=(2, 3)).astype(
        np.int32)
    pos, valid = np.array([8, 8], np.int32), np.array([3, 2], np.int32)
    jl, _, jf = jm.verify(jp, jnp.asarray(win), jc, jnp.asarray(pos), jctx,
                          jnp.asarray(valid))
    with torch.no_grad():
        tm.prefill(tp, tb["tokens"], tc, tctx,
                   inputs={"enc_input": tb["enc_input"]})
        tl, _, tf = tm.verify(tp, torch.from_numpy(win).long(), tc,
                              torch.from_numpy(pos), tctx,
                              torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not bool(tf) and not bool(jf)
    _, _, vm, vp = pairs[VISION]
    with pytest.raises(NotImplementedError, match="cross-attention"):
        vm.verify(vp, torch.ones(1, 2, dtype=torch.long),
                  vm.init_cache(1, 16, dtype=torch.float32),
                  torch.zeros(1, dtype=torch.int32), LayerCtx(),
                  torch.full((1,), 2))


@pytest.mark.parametrize("arch", [WHISPER, VISION])
def test_the_engines_refuse_what_passes_only_tokens(pairs, arch):
    """The reference's engine passes ``{"tokens": ...}`` alone, so its
    model's ``_memory`` raises ``KeyError`` on the missing audio or
    images; the port's engine refuses the model up front, naming its
    memory inputs, and ``Model.prefill`` without them raises
    ``KeyError`` as the reference's does."""
    jm, jp, tm, tp = pairs[arch]
    jeng = JEngine(jm, jp, slots=1, max_len=32,
                   abft=JABFT(use_pallas=False), dtype=jnp.float32)
    with pytest.raises(KeyError):
        jeng.run([JRequest(uid=0, prompt=np.arange(1, 5, dtype=np.int32),
                           max_new_tokens=2)])
    with pytest.raises(NotImplementedError) as exc:
        ServeEngine(tm, tp, slots=1, max_len=32, dtype=torch.float32,
                    device="cpu")
    for name in tm.memory_inputs:
        assert name in str(exc.value)
    assert "passes only tokens" in str(exc.value)
    with pytest.raises(KeyError):
        tm.prefill(tp, torch.ones(1, 4, dtype=torch.long),
                   tm.init_cache(1, 16, dtype=torch.float32), LayerCtx())
