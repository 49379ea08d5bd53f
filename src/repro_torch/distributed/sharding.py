"""Sharding rules: logical-parameter -> partition-spec mapping for a
``(data, model)`` mesh (port of ``repro.distributed.sharding``).

Axis roles, as in the reference:
  pod   — outer data parallelism across pods (multi-pod mesh only)
  data  — data parallelism; FSDP weight sharding for >=20B models; the
          second expert-parallel axis for deepseek's 256 experts
  model — tensor parallelism (heads / ffn / vocab) + expert parallelism

A spec is the port's own ``P``: a tuple of axis entries (None, an axis
name, or a tuple of names) mirroring JAX's ``PartitionSpec``, a
one-name tuple normalized to the name as JAX normalizes it.  Rules are
name-based over the port's param and cache trees (plain dicts and lists of
tensors), walked by path.  The port keeps one dict a layer where the
reference stacks each segment's layers (``params["layers"][i]`` against
``segments[s]["pos{q}"]``), so a layer leaf's spec is the reference's
without its leading stack ``None``; a cache leaf sits directly in its
layer's dict (``cache[i]["k"]``) where the reference nests it under
``attn``, and a cross layer's K/V under ``cross`` in both.

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so any object
with those two (the port's ``Mesh``, a geometry stub) will do.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.configs.base import ModelConfig

FSDP_THRESHOLD = 20e9   # params; above this, weights shard over 'data' too


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one entry a leading dim (trailing dims absent
    from it are replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""

    mesh: object
    spec: P


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _is_fsdp(cfg: ModelConfig) -> bool:
    from repro_torch.models.counting import count_params

    return count_params(cfg) >= FSDP_THRESHOLD


def expert_axes(cfg: ModelConfig, mesh) -> tuple:
    """Expert-parallel axis: experts shard over 'model'; large MoE configs
    additionally FSDP the expert D dim over 'data' via the fsdp flag."""
    return ("model",)


def axes_size(mesh, entry) -> int:
    """How many parts a spec entry (None, an axis, a tuple of axes) cuts
    a dim into on ``mesh``."""
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop sharding on any dim the mesh axes do not divide (an explicit
    layout needs exact divisibility); trim the spec to the leaf's rank."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry if i < len(shape) else None)
            continue
        if shape[i] % axes_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out[: len(shape)])


def _param_rule(path: str, ndim: int, cfg: ModelConfig, mesh,
                fsdp: bool) -> P:
    """Spec for one parameter leaf, by trailing path name (the reference's
    table, entry for entry)."""
    name = path.split("/")[-1]
    e_ax = expert_axes(cfg, mesh)
    # experts that don't divide the EP axes fall back to intra-expert TP
    ep_fits = cfg.n_experts % axes_size(mesh, e_ax) == 0 \
        if cfg.n_experts else True
    d = "data" if fsdp else None

    table = {
        # embeddings / head
        "embed": P("model", d),
        "lm_head": P(d, "model"),
        "vision_proj": P(None, None),
        # attention
        "wq": P(d, "model"), "wk": P(d, "model"), "wv": P(d, "model"),
        "wo": P("model", d),
        "bq": P("model"), "bk": P("model"), "bv": P("model"),
        "q_norm": P(None), "k_norm": P(None),
        # mla
        "wq_a": P(d, None), "wq_b": P(d, "model"),
        "wkv_a": P(d, None),
        "q_a_norm": P(None), "kv_a_norm": P(None),
        "w_uk": P("model", None, None), "w_uv": P("model", None, None),
        # mlp
        "up": P(d, "model"), "gate": P(d, "model"), "down": P("model", d),
        "up_b": P("model"), "down_b": P(None),
        # moe
        "router": P(None, None),
        "w_up": P(e_ax, d, None) if ep_fits else P(None, d, "model"),
        "w_gate": P(e_ax, d, None) if ep_fits else P(None, d, "model"),
        "w_down": P(e_ax, None, d) if ep_fits else P(None, "model", d),
        # mamba
        "in_z": P(d, "model"), "in_x": P(d, "model"),
        "in_bc": P(d, None), "in_dt": P(d, "model"),
        "conv_x_w": P(None, "model"), "conv_x_b": P("model"),
        "conv_bc_w": P(None, None), "conv_bc_b": P(None),
        "A_log": P("model"), "D": P("model"), "dt_bias": P("model"),
        "out_norm": P("model"), "out_proj": P("model", d),
        # misc
        "proj": P(None, None),        # mtp projection
        "cross_gate": P(),
    }
    if name in table:
        spec = table[name]
        if len(spec) > ndim:
            spec = P(*spec[:ndim])
        return spec
    # norms and anything unmatched: replicate
    return P(*([None] * ndim))


def map_with_path(fn, tree, path: tuple = ()):
    """``fn("a/0/b", leaf)`` over every leaf of a tree of dicts, lists and
    NamedTuples, the same structure back (``jax.tree_util.tree_map_with_path``'s walk
    with the reference's path strings)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields") and not isinstance(tree, NamedSharding):
        # a NamedTuple (the optimizer's state): its fields by name
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(cfg: ModelConfig, params, mesh, fsdp: bool | None = None):
    """Spec tree matching a params tree (leaves: anything with
    ``.shape``)."""
    fsdp = _is_fsdp(cfg) if fsdp is None else fsdp

    def one(ps, leaf):
        spec = _param_rule(ps, len(leaf.shape), cfg, mesh, fsdp)
        return sanitize_spec(spec, leaf.shape, mesh)

    return map_with_path(one, params)


def opt_state_specs(cfg: ModelConfig, params, mesh):
    """ZeRO-1: optimizer moments always carry the FSDP ('data')
    sharding."""
    return param_specs(cfg, params, mesh, fsdp=True)


def batch_specs(cfg: ModelConfig, mesh) -> dict:
    ba = batch_axes(mesh)
    specs = {"tokens": P(ba, None), "labels": P(ba, None)}
    if cfg.is_encoder_decoder:
        specs["enc_input"] = P(ba, None, None)
    if cfg.vision_dim:
        specs["images"] = P(ba, None, None)
    return specs


def cache_specs(cfg: ModelConfig, cache, mesh, batch: int,
                kv_fallback: str = "headdim", paged: bool = False):
    """KV/state cache specs (the reference's rules).  If the batch cannot
    cover the data axes, the cache's sequence dim shards over 'data'.
    ``kv_fallback`` picks the layout when kv_heads do not divide the model
    axis: 'headdim' shards head_dim, 'replicate' keeps the cache whole on
    every model rank.  ``paged``: attention k/v leaves are block pools
    ``(num_blocks, block_size, KV, hd)`` whose leading dims stay
    replicated (one logical block table for every rank); per-slot state
    (Mamba2 conv/ssm, MLA latent, a cross layer's K/V under ``cross``)
    keeps the dense rules."""
    ba = batch_axes(mesh)
    dsize = 1
    for a in ba:
        dsize *= mesh.shape[a]
    seq_shard = batch < dsize
    b_ax = None if seq_shard else ba
    s_ax = "data" if seq_shard else None

    def one(ps, leaf):
        parts = ps.split("/")
        name = parts[-1]
        pooled = paged and "cross" not in parts[:-1]
        nd = len(leaf.shape)
        if name in ("k", "v"):          # (B, S, KV, hd) | (NB, BS, KV, hd)
            kv = leaf.shape[-2]
            kb, ks = (None, None) if pooled else (b_ax, s_ax)
            if kv % mesh.shape["model"] == 0:
                core = P(kb, ks, "model", None)
            elif kv_fallback == "replicate":
                core = P(kb, ks, None, None)
            else:
                core = P(kb, ks, None, "model")
        elif name in ("c_kv", "k_pe", "latent"):  # (B|NB, S|BS, c)
            core = P(None, None, None) if pooled else P(b_ax, s_ax, None)
        elif name == "conv_x":          # (B, W-1, d_in) — per-slot
            core = P(b_ax, None, "model")
        elif name == "conv_bc":
            core = P(b_ax, None, None)
        elif name == "ssm":             # (B, H, P, N) — per-slot
            core = P(b_ax, "model", None, None)
        else:
            return P(*([None] * nd))
        if len(core) < nd:
            core = P(*([None] * (nd - len(core))), *core)
        return sanitize_spec(core, leaf.shape, mesh)

    return map_with_path(one, cache)


def logits_spec(mesh, batch: int) -> P:
    ba = batch_axes(mesh)
    dsize = 1
    for a in ba:
        dsize *= mesh.shape[a]
    if batch < dsize:
        return P(None, None, "model")
    return P(ba, None, "model")


def make_sharding(mesh, spec_tree):
    """Bind every spec of a tree to ``mesh``."""
    return map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


def shard_slices(spec, shape, mesh, coords: dict) -> tuple:
    """The index (a tuple of slices) of the shard of a ``shape`` leaf laid
    out by ``spec`` that the mesh position ``coords`` ({axis: index})
    holds.  A dim sharded over several axes splits in their order, the
    first the slowest, as JAX lays a multi-axis dim out."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
            parts *= mesh.shape[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_shape(spec, shape, mesh) -> tuple:
    """A leaf's local shape under ``spec``."""
    return tuple(n // axes_size(mesh, spec[i] if i < len(spec) else None)
                 for i, n in enumerate(shape))
