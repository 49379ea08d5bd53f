"""Optimizers (port of ``repro.train.optimizer``): AdamW (bf16-moment
option), SGD-momentum, global-norm clipping and int8 gradient compression
with error feedback.

State is an ``AdamWState`` of tensor trees mirroring the params tree.
Updates are functional, as in the reference: they return new tensors and
leave params and state as they were, so a step whose ABFT flag was raised
can be re-executed from the same state.

Weight decay applies to leaves of two or more dims *in the reference's
layout*, where the per-layer params are stacked along a leading repeats
axis (``jax.lax.scan``): every leaf under ``params["layers"]`` (and
whisper's ``params["encoder"]["layers"]``) counts one dim more, so the
per-layer norm gains are decayed there and here, and only the top-level
vectors (the final norms, the MTP head's layer, which the reference does
not stack) are not.

Over a ``(data, model)`` mesh (``Shards``, built by the train step) each
rank holds its params' model shard, gradients already summed over
``data``.  ``global_norm`` sums each leaf's squares once over the mesh:
over ``model`` where the leaf is split there, once where it is
replicated.  ``compress_int8``'s amax is the max over the logical
tensor, and the error-feedback state shards like its param.  ZeRO-1: a
rank keeps only its ``opt_state_specs`` shard of ``mu`` and ``nu`` (the
leaf's slice along the dim those specs put on ``data``), updates the
matching slice of the param and all-gathers the slices over ``data``
(``collectives.gather_zero``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)

F32 = torch.float32
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" for >=100B (memory)
    compress_grads: bool = False      # int8 + error feedback


@dataclasses.dataclass(frozen=True)
class Shards:
    """How a params tree lies over a ``(data, model)`` mesh, a tuple
    entry a leaf in tree order: ``first``, whether this rank counts the
    leaf's squares in the global norm (the first rank of each axis the
    leaf is replicated over); ``zero``, the dim ZeRO-1 splits its
    moments on over ``data`` (None: the moments are the whole local
    leaf); this rank's ``data_rank`` of ``data``; ``dp``, the data-axis
    group, and ``world``, every rank of the mesh (``collectives``)."""

    first: tuple
    zero: tuple
    data_rank: int = 0
    data: int = 1
    dp: object = None
    world: object = None

    def cut(self, i: int, t):
        """Leaf ``i``'s ZeRO-1 slice of ``t`` (``t`` where it has none)."""
        d = self.zero[i]
        if d is None:
            return t
        n = t.shape[d] // self.data
        return t.narrow(d, self.data_rank * n, n)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: object
    nu: object
    err: object      # error-feedback residuals (0-d zeros when compression off)


def _is_pair(x) -> bool:
    return type(x) is tuple


def _unzip(tree, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [tree_map(lambda t, i=i: t[i], tree, is_leaf=_is_pair)
            for i in range(n)]


def _stacked(path) -> bool:
    """Whether the reference stacks the leaf at ``path`` along a repeats
    axis: a decoder layer's, or (whisper) an encoder layer's."""
    return path[:1] == ("layers",) or path[:2] == ("encoder", "layers")


def decayed(params):
    """A bool tree: which leaves take weight decay (see the module note)."""
    return tree_unflatten(params, [
        p.dim() + (1 if _stacked(path) else 0) >= 2
        for path, p in tree_leaves_with_path(params)])


def init_opt_state(params, cfg: OptConfig,
                   shards: Shards | None = None) -> AdamWState:
    """Zero moments (``shards``: each of the rank's ZeRO-1 slice) and
    error-feedback residuals (each the shape of its local param)."""
    mdt = _MOMENT_DTYPES[cfg.moment_dtype]
    leaves = tree_leaves(params)
    dev = leaves[0].device

    def zeros(dtype, cut=False):
        return tree_unflatten(params, [
            torch.zeros((shards.cut(i, p) if cut and shards else p).shape,
                        dtype=dtype, device=p.device)
            for i, p in enumerate(leaves)])

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=zeros(mdt, cut=True),
        nu=zeros(mdt, cut=True),
        err=(zeros(torch.bfloat16) if cfg.compress_grads else tree_map(
            lambda p: torch.zeros((), dtype=F32, device=p.device), params)),
    )


def global_norm(tree, shards: Shards | None = None) -> torch.Tensor:
    """The gradients' global norm, f32; over a mesh each leaf's squares
    counted once (``Shards.first``) in one sum over every rank."""
    if shards is None or shards.world is None:
        total = 0
        for leaf in tree_leaves(tree):
            total = total + torch.sum(leaf.to(F32) ** 2)
        return torch.sqrt(total)
    from repro_torch.distributed.collectives import world_reduce

    sq = torch.stack([torch.sum(leaf.to(F32) ** 2) if first else
                      torch.zeros((), dtype=F32, device=leaf.device)
                      for leaf, first in zip(tree_leaves(tree),
                                             shards.first)])
    return torch.sqrt(torch.sum(world_reduce(sq, shards.world)))


def _clip_scale(grads, max_norm: float, shards: Shards | None = None):
    """(the factor global-norm clipping scales every gradient by, the
    global norm)."""
    norm = global_norm(grads, shards)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                       max=1.0), norm


def _clipped(g, scale):
    return (g.to(F32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float,
                        shards: Shards | None = None):
    scale, norm = _clip_scale(grads, max_norm, shards)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


# ------------------------------------------------------- gradient compression

def compress_int8(g: torch.Tensor, amax=None):
    """Symmetric per-tensor int8 quantization.  Returns (q, scale).
    ``amax``: the logical tensor's max magnitude where ``g`` is a shard
    of it (its own otherwise)."""
    gf = g.to(F32)
    if amax is None:
        amax = gf.abs().max()
    amax = torch.clamp(amax, min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.to(F32) * scale


def compress_with_feedback(g, err, amax=None):
    """Error-feedback compression: quantize (g + residual), carry the
    quantization error to the next step (``amax`` as
    ``compress_int8``'s, of g + residual)."""
    gf = g.to(F32) + err.to(F32)
    q, scale = compress_int8(gf, amax)
    deq = decompress_int8(q, scale)
    new_err = (gf - deq).to(err.dtype)
    return deq.to(g.dtype), new_err


def _compress(grads, err, shards: Shards | None):
    """``compress_with_feedback`` leaf by leaf; over a mesh each leaf's
    amax is the max over every rank's shard (one reduction)."""
    if shards is None or shards.world is None:
        return _unzip(tree_map(compress_with_feedback, grads, err), 2)
    from repro_torch.distributed.collectives import world_reduce

    gs, es = tree_leaves(grads), tree_leaves(err)
    amax = world_reduce(torch.stack([(g.to(F32) + e.to(F32)).abs().max()
                                     for g, e in zip(gs, es)]),
                        shards.world, op="max")
    pairs = [compress_with_feedback(g, e, amax[i])
             for i, (g, e) in enumerate(zip(gs, es))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(err, [p[1] for p in pairs]))


def _zero_update(upd, params, grads, moments, extra, shards):
    """``upd(p, g, *m, *x) -> (p', *m')`` leaf by leaf, on each leaf's
    ZeRO-1 slice of p and g where ``shards`` gives one, the updated
    slices then gathered over ``data``.  Returns (params', [moments'])."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms = [tree_leaves(m) for m in moments]
    xs = [tree_leaves(x) for x in extra]
    outs = []
    for i, (p, g) in enumerate(zip(ps, gs)):
        if shards is not None:
            p, g = shards.cut(i, p), shards.cut(i, g)
        outs.append(upd(p, g, *(m[i] for m in ms), *(x[i] for x in xs)))
    new_p = [o[0] for o in outs]
    new_m = [[o[j + 1] for o in outs] for j in range(len(moments))]
    del outs
    if shards is not None:
        from repro_torch.distributed.collectives import gather_zero

        cut = [i for i, d in enumerate(shards.zero) if d is not None]
        parts = [new_p[i] for i in cut]
        for i in cut:
            new_p[i] = None     # the gather frees each slice as it goes
        whole = gather_zero(parts, [shards.zero[i] for i in cut],
                            shards.dp)
        for i, t in zip(cut, whole):
            new_p[i] = t
    return (tree_unflatten(params, new_p),
            [tree_unflatten(m, ms) for m, ms in zip(moments, new_m)])


# ------------------------------------------------------- adamw

@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptConfig,
                 shards: Shards | None = None):
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    if cfg.compress_grads:
        grads, new_err = _compress(grads, state.err, shards)
    else:
        new_err = state.err
    # the clip runs leaf by leaf inside the update: a clipped copy of the
    # whole gradient tree never sits beside the gradients
    scale, gnorm = _clip_scale(grads, cfg.grad_clip, shards)
    step = state.step + 1
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    mdt = _MOMENT_DTYPES[cfg.moment_dtype]

    def upd(p, g, m, v, decay):
        # the reference's arithmetic, operation for operation:
        #   m' = b1 m + (1 - b1) g;  v' = b2 v + ((1 - b2) g) g
        #   delta = (m' / b1c) / (sqrt(v' / b2c) + eps) [+ wd p]
        #   p' = p - lr delta
        # in place on this call's own temporaries (inputs are never
        # written): the same roundings with a third of the allocations
        gf = _clipped(g, scale).to(F32)
        m_new = m.to(F32) * cfg.b1
        t = gf * (1 - cfg.b1)
        m_new += t
        v_new = v.to(F32) * cfg.b2
        torch.mul(gf, 1 - cfg.b2, out=t)
        t *= gf
        del gf
        v_new += t
        delta = m_new / b1c
        torch.div(v_new, b2c, out=t)
        t.sqrt_()
        t += cfg.eps
        delta /= t
        if decay:               # decoupled weight decay (module note)
            torch.mul(p.to(F32), cfg.weight_decay, out=t)
            delta += t
        delta *= cfg.lr
        torch.sub(p.to(F32), delta, out=t)
        return t.to(p.dtype), m_new.to(mdt), v_new.to(mdt)

    new_params, (new_mu, new_nu) = _zero_update(
        upd, params, grads, (state.mu, state.nu), (decayed(params),), shards)
    new_state = AdamWState(step=step, mu=new_mu, nu=new_nu, err=new_err)
    return new_params, new_state, {"grad_norm": gnorm}


@torch.no_grad()
def sgd_update(grads, state: AdamWState, params, cfg: OptConfig,
               shards: Shards | None = None):
    scale, gnorm = _clip_scale(grads, cfg.grad_clip, shards)
    step = state.step + 1

    def upd(p, g, m):
        m_new = cfg.b1 * m.to(F32) + _clipped(g, scale).to(F32)
        p_new = p.to(F32) - cfg.lr * m_new
        return p_new.to(p.dtype), m_new.to(m.dtype)

    new_params, (new_mu,) = _zero_update(upd, params, grads, (state.mu,),
                                         (), shards)
    return new_params, state._replace(step=step, mu=new_mu), {
        "grad_norm": gnorm}


def update(grads, state, params, cfg: OptConfig,
           shards: Shards | None = None):
    """One step of ``cfg.name``'s optimizer (``shards``: over a mesh, the
    module docstring)."""
    if cfg.name == "adamw":
        return adamw_update(grads, state, params, cfg, shards)
    if cfg.name == "sgd":
        return sgd_update(grads, state, params, cfg, shards)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def lr_schedule(step, base_lr: float, warmup: int = 100,
                total: int = 10000, min_ratio: float = 0.1):
    """Linear warmup + cosine decay (f32, as the reference)."""
    s = torch.as_tensor(step).to(F32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(s < warmup, warm, cos)
