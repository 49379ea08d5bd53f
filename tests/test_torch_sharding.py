"""The port's sharding rules (``repro_torch.distributed``) against the
reference's (``repro.distributed``), leaf by leaf on all ten configs
(scaled down), under geometry-only meshes of shapes (1, 1), (1, 2),
(1, 3), (1, 4), (2, 4) and (16, 16): ``param_specs`` with FSDP on and
off, ``opt_state_specs``, ``cache_specs`` (dense and paged, both
``kv_fallback``s), ``batch_specs`` and ``logits_spec``.  The port keeps
one dict a layer where the reference stacks each segment, so the
reference's spec of a stacked leaf, its leading ``None`` dropped, is the
spec of every layer it stacks.  Then the reference's ``sanitize_spec``,
``build_mesh``, ``make_hints`` and ``launch/mesh`` cases
(``tests/test_sharding_specs.py``) on the port.  Host logic only."""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.distributed import sharding as jshd
from repro.models import build_model
from repro_torch.configs import ALL_ARCHS, get_config, scaled_down
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import build_mesh, make_hints
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import make_host_mesh, make_mesh_from_devices
from repro_torch.models.model import Model, _enc_plan, seg_plan

torch.set_num_threads(1)


class StubMesh:
    """Geometry-only mesh: the rules read ``shape`` and ``axis_names``."""

    def __init__(self, **shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


MESHES = [StubMesh(data=d, model=m)
          for d, m in ((1, 1), (1, 2), (1, 3), (1, 4), (2, 4), (16, 16))]
BATCH = 4


@functools.lru_cache(maxsize=None)
def _arch(arch):
    jm = build_model(jscaled(jget(arch)))
    cfg = scaled_down(get_config(arch))
    model = Model(cfg)
    with torch.device("cpu"):
        params = model.init_params(0, dtype=torch.bfloat16)
    shapes = {
        "params": jax.eval_shape(
            lambda k: jm.init_params(k, dtype=jnp.bfloat16),
            jax.random.PRNGKey(0)),
        "dense": jax.eval_shape(
            lambda: jm.init_cache(BATCH, 32, dtype=jnp.bfloat16)),
        "paged": jax.eval_shape(
            lambda: jm.init_paged_cache(BATCH, 16, 8, dtype=jnp.bfloat16)),
    }
    caches = {
        "dense": model.init_cache(BATCH, 32, dtype=torch.bfloat16),
        "paged": model.init_paged_cache(16, 8, dtype=torch.bfloat16,
                                        slots=BATCH),
    }
    return cfg, jm.cfg, params, caches, shapes


def _spec(s) -> tuple:
    return tuple(s)


def _unstack(s) -> tuple:
    """A stacked leaf's spec without its segment dim."""
    return tuple(s)[1:]


def _layers(plan, segments, leaf_fn, nest=False) -> list:
    """The reference's segment specs in the port's layout: a list of one
    dict a layer, segment by segment of ``plan`` (``nest``: a cache, whose
    ``attn`` subtree is the port's layer dict itself)."""
    def conv(tree):
        if isinstance(tree, JP):
            return leaf_fn(tree)
        return {k: conv(v) for k, v in tree.items()}

    out = []
    for seg, sp in zip(plan, segments):
        for _ in range(seg.repeats):
            for q in range(len(seg.unit)):
                lay = conv(sp[f"pos{q}"])
                if nest:
                    lay = {**lay.pop("attn", {}), **lay}
                out.append(lay)
    return out


def _port_layout(cfg, jspecs) -> dict:
    """A reference params spec tree in the port's layout."""
    out = {k: _tree(v) for k, v in jspecs.items()
           if k not in ("segments", "encoder")}
    out["layers"] = _layers(seg_plan(cfg), jspecs["segments"], _unstack)
    if "encoder" in jspecs:
        enc = jspecs["encoder"]
        out["encoder"] = {
            "layers": _layers(_enc_plan(cfg), enc["segments"], _unstack),
            "final_norm": _tree(enc["final_norm"])}
    return out


def _tree(t):
    if isinstance(t, JP):
        return _spec(t)
    return {k: _tree(v) for k, v in t.items()}


def _as_tuples(t):
    if isinstance(t, P):
        return tuple(t)
    if isinstance(t, dict):
        return {k: _as_tuples(v) for k, v in t.items()}
    return [_as_tuples(v) for v in t]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_state_specs_match_reference(arch):
    cfg, jcfg, params, _, shapes = _arch(arch)
    for mesh in MESHES:
        for fsdp in (False, True):
            want = _port_layout(cfg, jshd.param_specs(
                jcfg, shapes["params"], mesh, fsdp=fsdp))
            got = _as_tuples(shd.param_specs(cfg, params, mesh, fsdp=fsdp))
            assert got == want, (arch, mesh.shape, fsdp)
        want = _port_layout(cfg, jshd.opt_state_specs(
            jcfg, shapes["params"], mesh))
        assert _as_tuples(shd.opt_state_specs(cfg, params, mesh)) == want
        assert _as_tuples(shd.param_specs(cfg, params, mesh)) == \
            _port_layout(cfg, jshd.param_specs(jcfg, shapes["params"],
                                                mesh))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch):
    cfg, jcfg, _, caches, shapes = _arch(arch)
    for mesh in MESHES:
        for kind in ("dense", "paged"):
            for fb in ("headdim", "replicate"):
                want = _layers(seg_plan(cfg), jshd.cache_specs(
                    jcfg, shapes[kind], mesh, BATCH, kv_fallback=fb,
                    paged=kind == "paged"), _unstack, nest=True)
                got = _as_tuples(shd.cache_specs(
                    cfg, caches[kind], mesh, BATCH, kv_fallback=fb,
                    paged=kind == "paged"))
                assert got == want, (arch, mesh.shape, kind, fb)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_logits_specs_match_reference(arch):
    cfg, jcfg, _, _, _ = _arch(arch)
    for mesh in MESHES:
        assert {k: tuple(v) for k, v in shd.batch_specs(cfg, mesh).items()} \
            == {k: tuple(v) for k, v in jshd.batch_specs(jcfg, mesh).items()}
        for batch in (1, 4, 64):
            assert tuple(shd.logits_spec(mesh, batch)) == \
                tuple(jshd.logits_spec(mesh, batch))
        assert shd.batch_axes(mesh) == jshd.batch_axes(mesh)
        assert shd.expert_axes(cfg, mesh) == jshd.expert_axes(jcfg, mesh)


MESH4 = StubMesh(data=1, model=4)


@pytest.mark.parametrize("spec,shape,mesh,want", [
    (P(None, "model"), (8, 16), MESH4, P(None, "model")),
    (P(None, "model"), (8, 10), MESH4, P(None, None)),
    (P("model", None), (2, 64), MESH4, P(None, None)),
    (P("model", None, None), (4, 8), MESH4, P("model", None)),
    (P("model"), (4, 8, 16), MESH4, P("model")),
    (P(("data", "model"),), (16,), StubMesh(data=2, model=4),
     P(("data", "model"))),
    (P(("data", "model"),), (12,), StubMesh(data=2, model=4), P(None)),
])
def test_sanitize_spec_cases(spec, shape, mesh, want):
    got = shd.sanitize_spec(spec, shape, mesh)
    assert got == want
    assert tuple(got) == tuple(jshd.sanitize_spec(JP(*spec), shape, mesh))


def test_spec_normalizes_one_name_tuples():
    assert P(("model",), None) == P("model", None) == \
        tuple(JP(("model",), None))


@pytest.mark.parametrize("case", ["single", "model_lt_one", "too_few",
                                  "overfull", "launch_wrapper",
                                  "host_mesh"])
def test_build_mesh_cases(case):
    n = 1           # a lone CPU process is a world of one rank
    if case == "single":
        mesh = build_mesh(model=1)
        assert mesh.shape["model"] == 1
        assert set(mesh.axis_names) == {"data", "model"}
        assert mesh.coords() == {"data": 0, "model": 0}
    elif case == "model_lt_one":
        with pytest.raises(ValueError, match="model_parallel"):
            build_mesh(model=0)
    elif case == "too_few":
        with pytest.raises(RuntimeError, match="not enough devices"):
            build_mesh(model=n + 1)
    elif case == "overfull":
        with pytest.raises(RuntimeError, match="needs"):
            build_mesh(model=1, data=n + 1)
    elif case == "launch_wrapper":
        devs = [torch.device("cpu")]
        with pytest.raises(RuntimeError):
            make_mesh_from_devices(devs, model_parallel=len(devs) + 1)
        m = make_mesh_from_devices(devs * 4, model_parallel=2)
        assert m.shape == {"data": 2, "model": 2}
    else:
        assert make_host_mesh().shape == {"data": 1, "model": 1}


def test_make_hints_moe_mode():
    from repro.distributed.mesh import make_hints as jhints

    moe = scaled_down(get_config("qwen2-moe-a2.7b"), n_layers=2)
    assert moe.n_experts == 8
    assert make_hints(moe, MESH4).moe_mode == "ep"        # 8 % 4 == 0
    assert make_hints(moe, StubMesh(data=1, model=3)).moe_mode == "tp"
    dense = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    h = make_hints(dense, StubMesh(data=2, model=2))
    assert h.dp == ("data",) and h.dp_size == 2
    for cfg, jcfg in ((moe, jscaled(jget("qwen2-moe-a2.7b"), n_layers=2)),
                      (dense, jscaled(jget("llama3.2-1b"), n_layers=2))):
        for mesh in MESHES:
            a, b = make_hints(cfg, mesh), jhints(jcfg, mesh)
            assert (a.dp, a.dp_size, a.ep, a.tp, a.moe_mode) == \
                (b.dp, b.dp_size, b.ep, b.tp, b.moe_mode)


def test_shard_slices_cover_the_leaf():
    """Every position's shard has the local shape, and the shards laid
    side by side cover the leaf once a position of the axes the spec
    does not use."""
    mesh = StubMesh(data=2, model=4)
    t = torch.arange(16 * 8).reshape(16, 8)
    for spec, copies in ((P("model", None), 2), (P(None, "model"), 2),
                         (P(("data", "model"), None), 1),
                         (P("data", "model"), 1)):
        seen = torch.zeros_like(t)
        for d in range(2):
            for m in range(4):
                idx = shd.shard_slices(spec, t.shape, mesh,
                                       {"data": d, "model": m})
                assert tuple(t[idx].shape) == shd.shard_shape(
                    spec, t.shape, mesh)
                seen[idx] += 1
        assert torch.all(seen == copies), spec


def test_import_guard_walks_the_slice():
    """``tests/test_torch_imports.py``'s guarded walk (no ``jax``, no
    ``repro``) imports every module of the port, this slice's among
    them."""
    from test_torch_imports import _expected_modules

    assert {"repro_torch.distributed", "repro_torch.distributed.mesh",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.distributed.spawn",
            "repro_torch.launch.mesh"} <= _expected_modules()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_shards_own_their_storage(arch):
    """A rank's shard (``init_params(mesh=)``, ``shard_params``) holds no
    view of a whole leaf: a leading-dim slice would otherwise keep the
    whole leaf's storage alive beside the shard."""
    import numpy as np

    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.model import Model

    over = {"n_layers": 8} if arch.startswith("jamba") else {}
    model = Model(scaled_down(get_config(arch), **over))
    mesh = Mesh(grid=np.arange(2).reshape(1, 2), axis_names=("data", "model"),
                devices=(torch.device("cpu"),) * 2, rank=1)
    whole = model.init_params(0, dtype=torch.bfloat16)
    full = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in tree_leaves(whole)}
    for tree in (model.init_params(0, dtype=torch.bfloat16, mesh=mesh),
                 model.shard_params(whole, mesh)):
        for t in tree_leaves(tree):
            st = t.untyped_storage()
            assert st.nbytes() == t.numel() * t.element_size()
            if st.data_ptr() in full:     # a replicated leaf, kept whole
                assert st.nbytes() == full[st.data_ptr()]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen1.5-32b"])
def test_slice_drawn_shards_equal_the_whole_draw(monkeypatch, arch, dtype):
    """With ``DRAW_SLICE`` small enough that the expert stacks, the
    embedding and the FFNs are drawn in slices, each rank's
    ``init_params(mesh=)`` (a leading-dim shard copied out slice by slice,
    never the whole leaf) equals ``shard_params`` of the whole draw bit
    for bit, in storage of its own, at k = 2 and 4; qwen1.5-32b padded
    from 5 to 8 heads takes the pad-then-cut path of its q/k/v/o."""
    import dataclasses

    import numpy as np

    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models import model as model_mod

    monkeypatch.setattr(model_mod, "DRAW_SLICE", 1000)
    cfg = scaled_down(get_config(arch))
    if arch == "qwen1.5-32b":
        cfg = dataclasses.replace(cfg, n_heads=5, n_kv_heads=5,
                                  pad_heads_to=8, pad_kv_heads_to=8)
    model = model_mod.Model(cfg)
    whole = model.init_params(3, dtype=dtype)
    for k in (2, 4):
        for rank in range(k):
            mesh = Mesh(grid=np.arange(k).reshape(1, k),
                        axis_names=("data", "model"),
                        devices=(torch.device("cpu"),) * k, rank=rank)
            drawn = tree_leaves_with_path(model.init_params(
                3, dtype=dtype, mesh=mesh))
            cut = tree_leaves_with_path(model.shard_params(whole, mesh))
            assert [p for p, _ in drawn] == [p for p, _ in cut]
            for (path, a), (_, b) in zip(drawn, cut):
                assert a.dtype == b.dtype and torch.equal(a, b), (k, path)
                assert a.untyped_storage().nbytes() == \
                    a.numel() * a.element_size(), (k, path)
