"""The dense family against the reference: qwen3-14b (q/k norm),
stablelm-1.6b (LayerNorm, 25% partial rotary) and qwen1.5-32b (QKV
biases) at ``scaled_down`` (2 layers, f32), served, scored and trained.

The reference initializes biases and LayerNorm shifts to 0 and every gain
to 1, where a wrong bias or gain would not show; so the reference's tree
gets seeded nonzero biases, shifts and gains (N(0, 0.1) and 1 + N(0,
0.1)) before ``params_from_reference`` carries it across.

The reference runs as its own tests run it on the CPU: its block schemes
through the XLA emulation (``use_pallas=False``), K2 and K3 in interpret
mode.  The port runs the kernels' plain versions.  Tolerances (f32, sums
in another order): logits within 1e-4 absolute and relative; loss within
1e-5 relative; ``grad_norm`` within 1e-5 relative; params after one
AdamW step within 1e-5 absolute (lr / 30, as in
``tests/test_torch_train.py``).  Greedy streams, engine counters,
selection traces and flags must be equal.
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
from repro.data.pipeline import DataConfig as JData, SyntheticLM as JSynth
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro.models import layers as jlayers
from repro.serve.engine import (
    RecoveryPolicy as JRecovery,
    Request as JRequest,
    ServeEngine as JEngine,
)
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
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.models import layers
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, params_from_reference
from repro_torch.serve.engine import RecoveryPolicy, Request, ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

torch.set_num_threads(1)

ARCHS = ("qwen3-14b", "stablelm-1.6b", "qwen1.5-32b")
# the leaves the dense family adds, and which of them are gains
NEW_LEAVES = {"bq", "bk", "bv", "q_norm", "k_norm", "b"}
GAINS = {"q_norm", "k_norm", "w"}
B, L = 2, 24


def _perturb(jp, seed):
    """Seeded nonzero biases, shifts and gains in the reference's tree."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        key = path[-1].key
        if key in GAINS:
            return jnp.asarray(1 + 0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        if key in NEW_LEAVES:
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, jp)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jcfg = jscaled(jget(arch))
    jm = build_model(jcfg)
    jp = _perturb(jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32),
                  seed=len(arch))
    cfg = scaled_down(get_config(arch))
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    return arch, jm, jp, Model(cfg), tp


def _ctxs(flash, fault, use_pallas=False):
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=use_pallas,
                                       hardware=JTPU,
                                       flash_attention=flash),
                fault=JMF.at(1, "attn_out", JFault.value(0, 2, 1e4))
                if fault else None)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E,
                                                flash_attention=flash),
                    fault=ModelFault.at(1, "attn_out",
                                        FaultSpec.value(0, 2, 1e4))
                    if fault else None)
    return jctx, tctx


def test_the_family_is_served_and_the_rest_is_not():
    for arch in ("llama3.2-1b", "qwen2-moe-a2.7b") + ARCHS:
        Model(get_config(arch))
    for arch in ("deepseek-v3-671b", "jamba-v0.1-52b",
                 "mamba2-1.3b", "whisper-tiny", "llama-3.2-vision-11b"):
        with pytest.raises(NotImplementedError):
            Model(get_config(arch))


def test_new_leaves_cross_over_nonzero(fam):
    arch, jm, jp, tm, tp = fam
    cfg = tm.cfg
    own = tm.init_params(0, dtype=torch.float32)
    paths = {p for p, _ in tree_leaves_with_path(tp)}
    assert paths == {p for p, _ in tree_leaves_with_path(own)}
    new = {p for p in paths if p[-1] in NEW_LEAVES}
    want = {"qwen3-14b": {"q_norm", "k_norm"},
            "stablelm-1.6b": {"b"}, "qwen1.5-32b": {"bq", "bk", "bv"}}
    assert {p[-1] for p in new} == want[arch]
    for p, leaf in tree_leaves_with_path(tp):
        if p[-1] in NEW_LEAVES:
            assert float(leaf.abs().min()) > 0, p
            if p[-1] in GAINS:
                assert not torch.equal(leaf, torch.ones_like(leaf)), p
    # the port's own init: biases and shifts 0, gains 1, as the reference
    for p, leaf in tree_leaves_with_path(own):
        if p[-1] in GAINS:
            assert torch.equal(leaf, torch.ones_like(leaf)), p
        elif p[-1] in NEW_LEAVES:
            assert torch.equal(leaf, torch.zeros_like(leaf)), p
    assert cfg.name == arch


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "flash"])
def test_forward_logits_and_flag_match_reference(fam, flash, fault):
    arch, jm, jp, tm, tp = fam
    toks = np.random.default_rng(3).integers(1, 256, size=(B, L)).astype(
        np.int32)
    # a faulted run compares with the reference's Pallas K1 (interpret
    # mode), which corrupts flattened row ``row`` only, as the port does
    jctx, tctx = _ctxs(flash, fault, use_pallas=fault)
    jo = jm.forward(jp, {"tokens": jnp.asarray(toks)}, jctx)
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               atol=1e-4, rtol=1e-4)
    assert bool(to.flag) == bool(jo.flag) == fault


# name: (flash, cache, fault_at step)
SCENARIOS = {
    "dense": (False, "dense", None),
    "dense_fault": (False, "dense", 2),
    "paged_flash": (True, "paged", None),
    "paged_flash_fault": (True, "paged", 3),
}
COUNTERS = ("faults_detected", "retries", "hard_faults", "evictions",
            "rejections", "steps", "tokens")


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 256, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 24, size=5)]


def _serve_ref(jm, jp, name):
    flash, cache, fat = SCENARIOS[name]
    eng = JEngine(jm, jp, slots=2, max_len=64,
                  abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                         hardware=JTPU,
                                         flash_attention=flash),
                  dtype=jnp.float32, cache_kind=cache,
                  policy=JRecovery(max_retries=1))
    fault = JMF.at(0, "mlp_down", JFault.value(0, 1, 1e5))
    out = eng.run([JRequest(uid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(_prompts())],
                  fault_at=None if fat is None else (fat, fault))
    return out, {k: getattr(eng.stats, k) for k in COUNTERS}, \
        eng.stats.selection_trace


def _serve_port(tm, tp, name):
    flash, cache, fat = SCENARIOS[name]
    eng = ServeEngine(tm, tp, slots=2, max_len=64,
                      abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                  hardware=TPU_V5E,
                                                  flash_attention=flash),
                      dtype=torch.float32, device="cpu", cache_kind=cache,
                      policy=RecoveryPolicy(max_retries=1))
    fault = ModelFault.at(0, "mlp_down", FaultSpec.value(0, 1, 1e5))
    out = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(_prompts())],
                  fault_at=None if fat is None else (fat, fault))
    return out, {k: getattr(eng.stats, k) for k in COUNTERS}, \
        eng.stats.selection_trace


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_streams_and_flags_match_reference(fam, name):
    arch, jm, jp, tm, tp = fam
    ref, got = _serve_ref(jm, jp, name), _serve_port(tm, tp, name)
    assert got[0] == ref[0], "greedy streams differ"
    assert got[1] == ref[1], "engine counters differ"
    assert got[2] == ref[2], "selection traces differ"
    if SCENARIOS[name][2] is not None:
        assert got[1]["faults_detected"] >= 1 and got[1]["retries"] >= 1
        clean = _serve_port(tm, tp, name[:-len("_fault")])
        assert got[0] == clean[0]


def test_train_step_matches_reference(fam):
    arch, jm, jp, tm, tp = fam
    jab = JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)
    tab = ABFTConfig.from_policy(IntensityGuidedPolicy(), hardware=TPU_V5E)
    batch = JSynth(JData(global_batch=B, seq_len=16, vocab_size=256)).batch(0)
    jpar, _, jmet = jax.jit(jstep_fn(jm, jab, JTrainConfig()))(
        jp, jopt.init_opt_state(jp, jopt.OptConfig()),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tpar, _, tmet = make_train_step(tm, tab, TrainConfig(), device="cpu")(
        tp, topt.init_opt_state(tp, topt.OptConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    want = params_from_reference(tm.cfg,
                                 jax.tree_util.tree_map(np.asarray, jpar))
    for g, w in zip(tree_leaves(tpar), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_decay_covers_the_new_leaves_as_the_reference(fam):
    """The reference decays leaves of >= 2 dims of its scan-stacked tree
    (``train/optimizer.py``): every per-layer leaf, biases and q/k norm
    gains included; the final norm's gain and shift never."""
    arch, jm, jp, tm, tp = fam
    ref_ndim = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [getattr(p, "key", None) for p in path]
        if keys[0] == "segments":           # segments / i / pos0 / ...
            keys = ["layers"] + keys[3:]
        ref_ndim[tuple(keys)] = np.asarray(leaf).ndim
    mask = topt.decayed(tp)
    for path, on in tree_leaves_with_path(mask):
        key = tuple(p for p in path if not isinstance(p, int))
        assert on == (ref_ndim[key] >= 2), path
        if path[-1] in NEW_LEAVES:
            assert on == (path[0] == "layers"), path


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("rot", [4, 16, 64])
def test_partial_rope_matches_reference(rot):
    D, H = 64, 3
    rng = np.random.default_rng(rot)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, H, D)).astype(np.float32)
    jc, js, jrot = jlayers.rope_tables(jnp.asarray(pos), D, 1e4, rot / D)
    tc, ts, trot = layers.rope_tables(torch.from_numpy(pos), D, 1e4,
                                      rot / D)
    assert trot == jrot == rot
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jc, js, rot))
    got = layers.apply_rope(torch.from_numpy(x), tc, ts, rot).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the tail passes through bit for bit
    assert np.array_equal(got[..., rot:], x[..., rot:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(5)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.norm(jnp.asarray(x, jd), {"w": jnp.asarray(w, jd),
                                             "b": jnp.asarray(b, jd)},
                        "layernorm", 1e-5)
    got = layers.norm(torch.from_numpy(x).to(td),
                      {"w": torch.from_numpy(w).to(td),
                       "b": torch.from_numpy(b).to(td)}, "layernorm", 1e-5)
    # f32: sums in another order; bf16: one rounding of either side
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * 8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    rms = layers.norm(torch.from_numpy(x), {"w": torch.from_numpy(w)},
                      "rmsnorm", 1e-6)
    assert torch.equal(rms, layers.rms_norm(torch.from_numpy(x),
                                            torch.from_numpy(w), 1e-6))
