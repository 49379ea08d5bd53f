"""Sharded training of the MLA, Mamba2 and memory families on the CPU:
the port's train step over a ``(data=2, model=2)`` mesh of four gloo
ranks (``repro_torch.distributed.spawn``; one spawn runs every family,
workers in ``tests/test_torch_train_families_worker.py``) against the
reference's unsharded step on the same parameters and batches.

This file trains mamba2, whisper and vision;
``tests/test_torch_mesh_train_moe_families.py`` trains deepseek and
jamba through the same helpers in a spawn of its own.  The families,
scaled down (``scaled_down``; the reference's own
parameters through numpy, f32): deepseek-v3-671b (MLA, a dense and an
MoE layer, 8 experts expert-parallel, and the MTP head), mamba2-1.3b,
jamba-v0.1-52b at its first 5 layers (Mamba2 mixers with dense and MoE
FFNs and layer 4, an attention layer with an MoE FFN), whisper-tiny with an odd
vocabulary of 259 (the rules then replicate its embedding and head: the
replicated-vocab branch) trained from ``audio`` through its conv stem
and encoder, and llama-3.2-vision-11b (a cross layer and a plain one)
with every cross gate at 0.7, trained from ``images``.  Each rank takes
its two rows of each global batch of 4 x 16 (the memory inputs' rows
too) and two AdamW steps at lr 3e-4.  The MoE families run the
reference under ``ShardingHints(dp_size=2, moe_mode="ep")``, the port's
``make_hints`` at (2, 2), so both route each data rank's rows as one
dispatch group.

The reference's step is jitted once a family: ``make_train_step``'s
single-batch path (``jax.value_and_grad`` of the reference's
``make_loss_fn``, then its ``optimizer.update``) written out so the same
call also returns the gradients and the MTP head's NLL, read off the
same forward's ``mtp_logits`` with the loss's own arithmetic.  The
tolerances are ``tests/test_torch_mesh_train.py``'s: loss, aux loss,
MTP loss, total loss and ``grad_norm`` within 1e-5 relative, each
gathered gradient within 1e-4 of its leaf's largest magnitude, the
params after each step within 1e-5 absolute (jamba's 1e-4:
``PARAM_ATOL`` says why).

Rank invariants: every replicated leaf's gradient (``wq_a``, ``wkv_a``,
the latent norms, the MTP ``proj``, ``in_bc``, ``conv_bc_*``,
``vision_proj``, ``cross_gate``, the norms; a missing ``copy_to_model``
leaves it partial on each model rank) is bit-equal on all four ranks.
The vision state after step 2 (bf16 moments under ZeRO-1) is saved at
(2, 2) and restored onto (1, 2), bit-equal.  What stays refused raises
``NotImplementedError`` naming its item, and the engine still refuses
the memory stacks.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_train_families_worker as FW
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import build_model
from repro.models.layers import ShardingHints as JHints
from repro.train import optimizer as jopt
from repro.train.train_step import (
    TrainConfig as JTrainConfig,
    make_loss_fn as jloss_fn,
)
from repro_torch.configs import get_config, scaled_down
from repro_torch.distributed import spawn
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (
    map_with_path,
    opt_state_specs,
    param_specs,
    shard_slices,
)
from repro_torch.models.layers import ShardingHints
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)

# name: (arch, scaled_down overrides, MoE hints on the reference)
FAMILIES = {
    "deepseek": ("deepseek-v3-671b", {}, True),
    "mamba2": ("mamba2-1.3b", {}, False),
    "jamba": ("jamba-v0.1-52b", {"n_layers": 5}, True),
    "whisper": ("whisper-tiny", {"vocab_size": 259}, False),
    "vision": ("llama-3.2-vision-11b", {}, False),
}
SEEDS = {name: i for i, name in enumerate(FAMILIES)}
GATE = 0.7
# replicated leaves each family must hold equal on every rank (a sample:
# the test holds every replicated leaf)
REPLICATED = {
    "deepseek": ("layers/0/mixer/wq_a", "layers/0/mixer/wkv_a",
                 "layers/0/mixer/kv_a_norm", "layers/1/mixer/q_a_norm",
                 "mtp/proj", "mtp/layer/mixer/wkv_a", "layers/1/ffn/router"),
    "mamba2": ("layers/0/mixer/in_bc", "layers/0/mixer/conv_bc_w",
               "layers/1/mixer/conv_bc_b", "layers/1/mixer_norm/w"),
    "jamba": ("layers/0/mixer/in_bc", "layers/1/mixer/conv_bc_w",
              "layers/4/mixer_norm/w", "layers/0/ffn/router"),
    "whisper": ("embed", "lm_head", "encoder/layers/0/mixer_norm/b",
                "conv_stem/w1", "layers/0/ffn/down_b"),
    "vision": ("vision_proj", "layers/0/cross_gate",
               "layers/0/cross_norm/w", "final_norm/w"),
}
# the params' tolerance after each step where a family needs a looser one
# than 1e-5: jamba's ``out_proj`` holds gradient entries of ~1e-9 (1e-7
# of the leaf's largest, far inside the gradients' tolerance) whose sign
# turns with the order of the f32 sums, and AdamW's first steps move
# each entry by lr |g| / (|g| + eps), eps = 1e-8, so such an entry lands
# up to ~0.2 lr = 6e-5 apart
PARAM_ATOL = {"jamba": 1e-4}
# the (2, 2) geometry the parent assembles shards with
GEOM = Mesh(grid=np.arange(4).reshape(2, 2), axis_names=("data", "model"),
            devices=(torch.device("cpu"),) * 4)


def _configs(name):
    arch, kw, _ = FAMILIES[name]
    return jscaled(jget(arch), **kw), scaled_down(get_config(arch), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gates(tree):
    """Every cross gate of a numpy tree at ``GATE``, in place."""
    for seg in tree.get("segments", []):
        for pos in seg.values():
            if "cross_gate" in pos:
                pos["cross_gate"] = np.full_like(pos["cross_gate"], GATE)
    return tree


def _setup(names, tmp):
    """The reference's model and f32 params of each family (cross gates
    at ``GATE``), carried to the port, and one spawn of four ranks
    training them all (``FW.families_rank``), started on a thread."""
    pairs, cases = {}, {}
    for name in names:
        jcfg, cfg = _configs(name)
        jm = build_model(jcfg)
        jp = _gates(_np(jm.init_params(jax.random.PRNGKey(SEEDS[name]),
                                       dtype=jnp.float32)))
        tp = params_from_reference(cfg, jp)
        pairs[name] = (cfg, jm, jp, tp)
        cases[name] = (cfg, tp, 100 + SEEDS[name])
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(spawn.run, FW.families_rank, 4, cases,
                      str(tmp / "ckpt"), device="cpu")
    return pool, {"pairs": pairs, "fut": fut}


def _ref_step(jm, tcfg, hints):
    """The reference's unsharded step (``make_train_step``'s single-batch
    path), jitted: (params, state, metrics with ``mtp_loss`` where the
    model has an MTP head, gradients)."""
    jab = JABFT.from_policy(JGuided(), use_pallas=False, hardware=JTPU)

    def loss(p, b):
        seen = []

        class Spy:
            def forward(self, params, batch, ctx):
                seen.append(jm.forward(params, batch, ctx))
                return seen[-1]

        total, met = jloss_fn(Spy(), jab, tcfg, hints=hints)(p, b)
        out = seen[0]
        if out.mtp_logits is not None:
            labels = b["labels"]
            mask = (labels >= 0).astype(jnp.float32)
            l2 = jnp.roll(labels, -1, axis=1)
            m2 = mask * jnp.roll(mask, -1, axis=1)
            lp2 = jnp.take_along_axis(jax.nn.log_softmax(
                out.mtp_logits.astype(jnp.float32), -1), l2[..., None],
                -1)[..., 0]
            met = dict(met, mtp_loss=-jnp.sum(lp2 * m2)
                       / jnp.maximum(jnp.sum(mask), 1.0))
        return total, met

    def step(p, st, b):
        (total, met), g = jax.value_and_grad(loss, has_aux=True)(p, b)
        p2, st2, om = jopt.update(g, st, p, tcfg.opt)
        return p2, st2, dict(met, **om, total_loss=total), g

    return jax.jit(step)


def _port_flat(cfg, jtree) -> dict:
    return FW.flat(params_from_reference(cfg, _np(jtree)))


def _reference(pairs) -> dict:
    """Each family's reference steps on the same batches (while the
    ranks run): metrics and params after every step, the first step's
    gradients.  The params start on the mesh's sharding, as the step
    returns them, so the step compiles once."""
    out = {}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    for name, (cfg, jm, jp, _) in pairs.items():
        o = FW.opt_config(name)
        tcfg = JTrainConfig(opt=jopt.OptConfig(lr=o.lr,
                                               moment_dtype=o.moment_dtype))
        hints = (JHints(dp=("data",), dp_size=2, moe_mode="ep")
                 if FAMILIES[name][2] else None)
        rec = {"steps": []}
        with jax.set_mesh(mesh):
            step = _ref_step(jm, tcfg, hints)
            p = jax.device_put(jp, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))
            st = jopt.init_opt_state(p, tcfg.opt)
            for s, b in enumerate(FW.batches(cfg, 100 + SEEDS[name])):
                p, st, met, g = step(p, st, {k: jnp.asarray(v)
                                             for k, v in b.items()})
                if s == 0:
                    rec["grads"] = _port_flat(cfg, g)
                rec["steps"].append({
                    "metrics": {k: float(v) for k, v in met.items()},
                    "params": _port_flat(cfg, p)})
        out[name] = rec
    return out


def fixtures(names):
    """The module-scoped ``setup``, ``ref`` and ``ranks`` fixtures of a
    file that trains ``names``: one spawn, the reference beside it."""

    @pytest.fixture(scope="module")
    def setup(tmp_path_factory):
        pool, out = _setup(names, tmp_path_factory.mktemp("train_families"))
        yield out
        pool.shutdown(wait=True)

    @pytest.fixture(scope="module")
    def ref(setup):
        return _reference(setup["pairs"])

    @pytest.fixture(scope="module")
    def ranks(setup, ref):
        return setup["fut"].result()

    return setup, ref, ranks


# this file's families; the MoE families (deepseek, jamba) train in
# ``tests/test_torch_mesh_train_moe_families.py``, a spawn of its own
NAMES = ["mamba2", "whisper", "vision"]
setup, ref, ranks = fixtures(NAMES)


def _specs(cfg, opt=False) -> dict:
    shapes = Model(cfg).param_shapes()
    tree = (opt_state_specs(cfg, shapes, GEOM) if opt
            else param_specs(cfg, shapes, GEOM))
    out = {}
    map_with_path(lambda ps, sp: out.__setitem__(ps, sp), tree)
    return out


def _assemble(cfg, shards: list, specs: dict) -> dict:
    """Whole leaves from every rank's (coords, {path: shard}); ranks that
    hold the same part must hold the same bits."""
    full = {}
    map_with_path(lambda ps, t: full.__setitem__(ps, tuple(t.shape)),
                  Model(cfg).param_shapes())
    out = {}
    for coords, flat in shards:
        for k, a in flat.items():
            if k not in out:
                out[k] = np.full(full[k], np.nan, dtype=a.dtype)
            idx = shard_slices(specs[k], full[k], GEOM, coords)
            seen = out[k][idx]
            assert np.isnan(seen).all() or np.array_equal(seen, a), k
            out[k][idx] = a
    for k, v in out.items():
        assert not np.isnan(v).any(), k
    return out


def _fam(ranks, name):
    return [(r["coords"], r["families"][name]) for r in ranks]


def check_losses(ranks, ref, name):
    """loss (NLL), aux loss, MTP loss (deepseek), total loss and
    ``grad_norm`` of each step, on every rank, against the reference's;
    no flag rises."""
    want = ref[name]["steps"]
    keys = ["loss", "aux_loss", "total_loss", "grad_norm"]
    if name == "deepseek":
        keys.append("mtp_loss")
        assert want[0]["metrics"]["mtp_loss"] > 0
    for r in ranks:
        got = r["families"][name]["steps"]
        assert len(got) == len(want) == FW.STEPS
        for g, w in zip(got, want):
            assert not g["metrics"]["abft_flag"]
            for k in keys:
                np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                           rtol=1e-5, err_msg=k)


def check_params(setup, ranks, ref, name):
    """The params after each step, gathered, within ``PARAM_ATOL``."""
    cfg = setup["pairs"][name][0]
    specs = _specs(cfg)
    atol = PARAM_ATOL.get(name, 1e-5)
    for s in range(FW.STEPS):
        got = _assemble(cfg, [(c, f["steps"][s]["params"])
                              for c, f in _fam(ranks, name)], specs)
        want = ref[name]["steps"][s]["params"]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=f"step {s} {k}")


def check_grads(setup, ranks, ref, name):
    """The first batch's gradients, gathered, within 1e-4 of each leaf's
    largest magnitude."""
    cfg = setup["pairs"][name][0]
    got = _assemble(cfg, [(c, f["grads"]) for c, f in _fam(ranks, name)],
                    _specs(cfg))
    want = ref[name]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * max(
            np.abs(want[k]).max(), 1e-30), k


def check_replicated(ranks, name):
    """Each replicated leaf's gradient is bit-equal on the four ranks,
    and the leaves named in ``REPLICATED`` are among them, with a
    gradient that is not all zero where the loss reads them (whisper's
    decoder never reads its encoder)."""
    digests = [r["families"][name]["replicated"] for r in ranks]
    assert all(d == digests[0] for d in digests)
    grads = ranks[0]["families"][name]["grads"]
    for k in REPLICATED[name]:
        assert k in digests[0], k
        if not k.startswith(("encoder/", "conv_stem/")):
            assert np.abs(grads[k]).max() > 0, k


@pytest.mark.parametrize("name", NAMES)
def test_losses_and_grad_norms_match_reference(ranks, ref, name):
    check_losses(ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_params_after_each_step_match_reference(setup, ranks, ref, name):
    check_params(setup, ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_gathered_gradients_match_reference(setup, ranks, ref, name):
    check_grads(setup, ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_gradients_equal_on_every_rank(ranks, name):
    check_replicated(ranks, name)


def test_checkpoint_restores_onto_1x2(setup, ranks):
    """The vision state after step 2, bf16 moments under ZeRO-1, saved
    at (2, 2) and restored onto (1, 2): every param and moment bit-equal
    to the (2, 2) state assembled whole."""
    name = FW.CKPT_FAMILY
    cfg = setup["pairs"][name][0]
    fam = _fam(ranks, name)
    assert fam[0][1]["mu_dtype"] == "torch.bfloat16"
    want_p = _assemble(cfg, [(c, f["steps"][-1]["params"]) for c, f in fam],
                       _specs(cfg))
    want_mu = _assemble(cfg, [(c, f["mu"]) for c, f in fam],
                        _specs(cfg, opt=True))
    got = [r["restore"] for r in ranks[:2]]
    assert all(g["step"] == FW.STEPS for g in got)
    assert all(r["restore"] is None for r in ranks[2:])
    # at data = 1 every moment is its param's model shard
    got_p = _assemble(cfg, [(g["coords"], g["params"]) for g in got],
                      _specs(cfg))
    got_mu = _assemble(cfg, [(g["coords"], g["mu"]) for g in got],
                       _specs(cfg))
    for k in want_p:
        assert np.array_equal(got_p[k], want_p[k]), k
        assert np.array_equal(got_mu[k], want_mu[k]), k


def test_collectives_of_the_families(ranks):
    """Every kind of the train step's collectives ran (the whole-leaf
    save's gathers too), the same number on every rank; the loss is
    vocab-parallel, so no logits are gathered over ``model`` and each
    vocab-sharded head takes a row max there."""
    counts = ranks[0]["counts"]
    assert all(r["counts"] == counts for r in ranks)
    for kind in ("model_sum", "model_max", "model_grad", "data_sum",
                 "grad_sum", "zero_gather", "world", "flag", "checkpoint"):
        assert counts[kind] > 0, kind
    assert counts["model_gather"] == 0


# ------------------------------------------------------------ admission
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-tiny",
                                  "llama-3.2-vision-11b"])
def test_check_trainable_admits_the_families(arch):
    """At their published sizes and scaled down, over (2, 2)."""
    from repro_torch.train.train_step import check_trainable

    check_trainable(get_config(arch), GEOM)
    check_trainable(scaled_down(get_config(arch)), GEOM)


def _refused(case):
    """(config, hints, the message's pattern) of what stays refused."""
    if case == "mtp_depth_2":
        cfg = scaled_down(get_config("deepseek-v3-671b"))
        return dataclasses.replace(cfg, mtp_depth=2), None, "not ported"
    if case == "unpadded_q_heads":
        # a GQA stack's heads are padded (``layout_config``); a cross
        # layer's are not
        cfg = dataclasses.replace(
            scaled_down(get_config("llama-3.2-vision-11b")), n_heads=5,
            n_kv_heads=1)
        return cfg, None, "split a q head.*A.3b-ii"
    cfg = scaled_down(get_config("qwen2-moe-a2.7b"))
    return cfg, ShardingHints(dp_size=3), "dp_size=3"


@pytest.mark.parametrize("case", ["mtp_depth_2", "unpadded_q_heads",
                                  "dp_size_3"])
def test_sharded_training_refuses_what_stays_unported(case):
    """``mtp_depth = 2`` (the model itself, and the layout check), an
    unpadded split q head of a cross layer (ROADMAP A.3b-ii; a GQA
    stack's heads are padded) and a ``hints.dp_size`` that ``data`` does
    not divide raise ``NotImplementedError``."""
    from repro_torch.train.train_step import check_trainable, make_train_step

    cfg, hints, pattern = _refused(case)
    if case == "mtp_depth_2":
        with pytest.raises(NotImplementedError, match=pattern):
            Model(cfg)
        with pytest.raises(NotImplementedError, match="one MTP"):
            check_trainable(cfg, GEOM)
        return
    with pytest.raises(NotImplementedError, match=pattern):
        make_train_step(Model(cfg), FW.abft(), FW.TrainConfig(),
                        hints=hints, mesh=GEOM, device="cpu")


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_engine_still_refuses_memory_stacks(arch):
    """The engine serves stacks with a memory at no width, on a model
    axis and on a data axis alike, while training takes them."""
    from repro_torch.serve.executor import check_shardable

    cfg = scaled_down(get_config(arch))
    for shape in ((2, 2), (2, 1), (1, 2)):
        mesh = Mesh(grid=np.arange(4)[:shape[0] * shape[1]].reshape(shape),
                    axis_names=("data", "model"),
                    devices=(torch.device("cpu"),) * (shape[0] * shape[1]))
        with pytest.raises(NotImplementedError, match="at no width"):
            check_shardable(cfg, mesh)
