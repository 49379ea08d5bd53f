"""Train-step construction (port of ``repro.train.train_step``): CE loss
with z-loss, aux loss and the MTP head's loss, microbatched gradient
accumulation in f32, the OR of the forward's ABFT flags, and the
optimizer update.

The step differentiates ``Model.forward`` with autograd.  Every
block-protected forward GEMM runs K1 (its plain version on the CPU);
their backward is plain ``torch.matmul``, unprotected, as the reference's
XLA backward of its emulation is.  The flag of the *forward* pass is in
the metrics; the trainer re-executes a flagged step.

Over a ``(data, model)`` or ``(pod, data, model)`` port mesh (``mesh=``,
built by ``distributed.mesh.build_mesh``; the reference's step runs under an
ambient ``with mesh:``), every rank runs this step on its shard of the
params (``Model.shard_params`` or ``init_params(mesh=)``) and its
optimizer state (``init_opt_state(shards=)``), the same global batch in
hand (``Placement``):

- data rank r takes rows [r B/d, (r + 1) B/d) of the batch, of each
  microbatch where there are several (the reference splits the global
  batch first), and a fault's logical row lands on the data rank that
  owns it (``LayerCtx.rows``);
- the loss's denominator, NLL, z-loss and metric sums are summed over
  ``data`` (``collectives.data_stats``) and the MoE aux loss takes the
  global batch's means (``LayerCtx.aux_over_data``), so ``loss``,
  ``total_loss`` and ``aux_loss`` are the unsharded step's on every
  rank; each rank differentiates its own share of the loss and the
  gradients are summed over ``data`` (f32, bucketed:
  ``collectives.sum_grads``) before the update;
- the flag is OR-ed over every rank of the mesh, so every rank takes the
  same retry decision; the update is ZeRO-1 (``optimizer.Shards``);
- under a ``model`` axis the loss is vocab-parallel (``_logp``): each
  rank keeps its vocab slice of the logits and the MTP head's, and only
  each row's max, sum of exponentials and label logit cross the axis.

With a ``pod`` axis the batch (the rows, the loss's sums, the aux
loss's means and the gradient sums of leaves ``data`` does not split)
spans ``pod`` x ``data``, while FSDP, ZeRO-1 and sequence shards stay on
``data`` and are replicated over ``pod``, as the reference's specs lay
them out; an FSDP leaf's gradient is then summed over ``pod``.  Heads
are padded where the rules would split one (``Model.for_mesh``).

Sharded training covers every layer kind the rules lay out
(``executor.check_layout``): GQA and MLA attention (MLA with its MTP
head, whose NLL joins the sums over ``data``), Mamba2 mixers, dense, MoE
or no FFNs, and stacks with a memory (whisper's encoder, the vision
model's cross layers), whose inputs (``audio``, ``enc_input``,
``images``) split over ``data`` by row with the tokens.  What stays
refused raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
)
from repro_torch.distributed.collectives import or_flag
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model
from repro_torch.serve.executor import resolve_device
from repro_torch.train import optimizer as opt_lib

F32 = torch.float32

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.OptConfig = opt_lib.OptConfig()
    aux_loss_coef: float = 0.01
    mtp_loss_coef: float = 0.3
    z_loss_coef: float = 1e-4
    microbatches: int = 1        # gradient accumulation steps


def check_trainable(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` trains sharded over
    ``mesh``: the layouts ``executor.check_layout`` admits, memory stacks
    included (the engine's refusal of them is the engine's alone)."""
    from repro_torch.serve.executor import check_layout

    check_layout(cfg, mesh)


def _axes(spec) -> set:
    out = set()
    for e in spec:
        out |= set(e) if isinstance(e, tuple) else ({e} if e else set())
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """This rank's place in sharded training: the ``mesh``, the ``model``
    the step runs (``Model.for_mesh``: heads padded where the rules
    would split one), its groups (``executor.AxisGroups``: ``tp`` over
    ``model``, ``dp`` over ``data``, ``bp`` over the batch, ``pod`` x
    ``data``, and ``pp`` over ``pod``) and ``world`` (every rank of the
    mesh), the ``hints``, the optimizer's ``shards`` (``optimizer.
    Shards``: ZeRO-1 over ``data``, replicated over ``pod``) and
    ``summed``, the leaves (tree order) whose gradients are summed over
    the batch (every leaf not split over ``data``); an FSDP leaf's
    gradient comes back from its gather's backward summed over ``data``
    and is then summed over ``pod`` (``pod_summed``)."""

    mesh: object
    model: Model
    tp: object
    dp: object
    bp: object
    pp: object
    world: object
    hints: object
    shards: opt_lib.Shards
    summed: tuple
    pod_summed: tuple

    @property
    def data(self) -> int:
        """The batch's width: ``pod`` x ``data``."""
        return self.bp.size if self.bp is not None else 1

    def rows(self, b: int) -> tuple:
        """(lo, n): this batch rank's rows of a batch of ``b`` rows."""
        if b % self.data:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"the batch's {self.data} ranks")
        n = b // self.data
        return self.mesh.batch_rank * n, n


def placement(model: Model, mesh, hints=None) -> Placement | None:
    """The ``Placement`` of this process on ``mesh`` (None: a mesh of one
    rank, the unsharded program).  ``hints=None`` means
    ``make_hints(cfg, mesh)``."""
    from repro_torch.distributed.collectives import grid_group
    from repro_torch.distributed.mesh import make_hints
    from repro_torch.distributed.sharding import (
        map_with_path,
        opt_state_specs,
        param_specs,
    )
    from repro_torch.serve.executor import axis_groups

    if mesh is None or mesh.grid.size == 1:
        return None
    model = model.for_mesh(mesh)
    cfg = model.cfg
    check_trainable(cfg, mesh)
    hints = hints if hints is not None else make_hints(cfg, mesh)
    d = int(mesh.shape.get("data", 1))
    b = d * int(mesh.shape.get("pod", 1))
    if hints.dp_size % b:
        raise NotImplementedError(
            f"hints.dp_size={hints.dp_size} over a batch of {b} ranks: "
            f"each batch rank must hold whole MoE dispatch groups of the "
            f"global batch")
    tp, dp, bp, pp = axis_groups(model, mesh)
    shapes = model.param_shapes()
    pspec, ospec = {}, {}
    map_with_path(lambda ps, sp: pspec.__setitem__(ps, sp),
                  param_specs(cfg, shapes, mesh))
    map_with_path(lambda ps, sp: ospec.__setitem__(ps, sp),
                  opt_state_specs(cfg, shapes, mesh))
    coords = mesh.coords()
    first, zero, summed, pod_summed = [], [], [], []
    for i, (path, _) in enumerate(tree_leaves_with_path(shapes)):
        key = "/".join(str(k) for k in path)
        p_ax, o_sp = _axes(pspec[key]), ospec[key]
        first.append(all(a in p_ax or coords.get(a, 0) == 0
                         for a in mesh.axis_names))
        if "data" not in p_ax:
            summed.append(i)
        elif pp is not None:
            pod_summed.append(i)
        zd = None
        if d > 1:
            for j, e in enumerate(o_sp):
                p_e = pspec[key][j] if j < len(pspec[key]) else None
                if e != p_e:
                    if e != "data" or p_e is not None or zd is not None:
                        raise ValueError(f"{key}: moments {o_sp} against "
                                         f"params {pspec[key]}")
                    zd = j
        zero.append(zd)
    shards = opt_lib.Shards(first=tuple(first), zero=tuple(zero),
                            data_rank=coords.get("data", 0), data=d, dp=dp,
                            world=grid_group(mesh))
    return Placement(mesh=mesh, model=model, tp=tp, dp=dp, bp=bp, pp=pp,
                     world=shards.world, hints=hints, shards=shards,
                     summed=tuple(summed), pod_summed=tuple(pod_summed))


def _device(mesh, device):
    """The step's device: the rank's own on a mesh (its type checked
    against ``device`` where the caller names one), else
    ``resolve_device(device)``."""
    if mesh is None:
        return resolve_device(device)
    dev = torch.device(mesh.device)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device!r}, but the mesh's rank runs on "
                         f"{dev}")
    return resolve_device(dev)


def _rows(batch: dict, pl: Placement | None) -> tuple:
    """(this rank's rows of ``batch``, ``LayerCtx.rows``)."""
    if pl is None or pl.data == 1:
        return batch, None
    b = torch.as_tensor(batch["tokens"]).shape[0]
    lo, n = pl.rows(b)
    return {k: torch.as_tensor(v)[lo:lo + n] for k, v in batch.items()}, \
        (lo, n)


def make_loss_fn(model: Model, abft: ABFTConfig, tcfg: TrainConfig,
                 hints=None, device=None, mesh=None,
                 pl: Placement | None = None) -> Callable:
    """loss_fn(params, batch, fault=None) -> (loss, metrics), on
    ``device`` (CUDA unless the caller passes ``"cpu"``).  The batch's
    memory inputs (``audio``, ``enc_input``, ``images``) reach
    ``Model.forward`` beside its tokens, as the reference's loss passes
    its batch whole.  With MTP logits
    the loss gains ``mtp_loss_coef`` x the MTP head's NLL of token t + 2
    (labels rolled one more step, the mask times its roll), over the main
    loss's denominator, as the reference's.  ``hints`` as the reference's
    (the MoE dispatch's ``dp_size`` groups).

    ``mesh`` (a port ``Mesh``; ``pl``, its ``Placement``, where the
    caller holds it): ``batch`` is the global batch and the loss this
    data rank's share of the global loss (the module docstring), to
    differentiate; ``metrics`` hold the global ``loss`` (NLL),
    ``aux_loss`` and ``total_loss``.  Under a ``model`` axis the loss is
    vocab-parallel (``_logp``): no rank gathers the logits whole."""
    if pl is None and mesh is not None:
        pl = placement(model, mesh, hints)
    if pl is not None:
        hints, model = pl.hints, pl.model
    dev = _device(mesh if pl is None else pl.mesh, device)
    bp = pl.bp if pl is not None else None
    groups = hints.dp_size // pl.data if pl is not None else None

    def loss_fn(params, batch, fault=None):
        local, rows = _rows(batch, pl)
        ctx = LayerCtx(abft=abft, fault=fault, hints=hints,
                       tp=pl.tp if pl else None, dp=pl.dp if pl else None,
                       bp=bp, rows=rows, moe_groups=groups,
                       aux_over_data=rows is not None,
                       vocab_parallel=pl is not None)
        out = model.forward(params, local, ctx, device=dev)
        labels = torch.as_tensor(local["labels"]).to(dev).long()
        tp = ctx.tp if model.vocab_sharded(ctx) else None
        logp, logz = _logp(out.logits, labels, tp)
        mask = (labels >= 0).to(F32)
        mtp = (_mtp_logp(out.mtp_logits, labels, mask, tp)
               if out.mtp_logits is not None else None)
        if bp is not None:
            return _data_loss(tcfg, out, logp, logz, mask, mtp, bp)
        denom = torch.clamp(mask.sum(), min=1.0)
        nll = -torch.sum(logp * mask) / denom
        loss = nll + tcfg.z_loss_coef * torch.sum((logz ** 2) * mask) / denom
        loss = loss + tcfg.aux_loss_coef * out.aux_loss
        metrics = {"loss": nll, "aux_loss": out.aux_loss,
                   "abft_flag": out.flag}
        if mtp is not None:
            loss = loss - tcfg.mtp_loss_coef * mtp / denom
            metrics["mtp_loss"] = -mtp / denom
        return loss, metrics

    return loss_fn


def _logp(logits, labels, tp=None) -> tuple:
    """(log p(label), log Z) of each row of f32 ``logits`` (..., V).
    ``tp``: the rows are this model rank's vocab slice (rank r's the r-th
    of ``tp.size``; ``Model.vocab_sharded``), and the loss is vocab-
    parallel, as the reference's GSPMD reduces it over its vocab-sharded
    logits: the row max (no gradient), the sum of exponentials and the
    label's logit (0 off the rank's slice), each reduced over ``model``,
    so no rank holds a whole row."""
    from repro_torch.distributed.collectives import (
        all_reduce_max,
        all_reduce_sum,
    )

    logits = logits.to(F32)
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels.clamp_min(0)[..., None])
        return lab[..., 0] - logz, logz
    n = logits.shape[-1]
    m = all_reduce_max(logits.amax(-1), tp)
    se = all_reduce_sum(torch.exp(logits - m[..., None]).sum(-1), tp)
    local = labels - tp.rank * n
    own = (local >= 0) & (local < n)
    lab = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    lab = all_reduce_sum(torch.where(own, lab, torch.zeros_like(lab)), tp)
    logz = m + torch.log(se)
    return lab - logz, logz


def _mtp_logp(mtp_logits, labels, mask, tp=None):
    """The MTP head's summed log-likelihood of token t + 2 (labels rolled
    one more step, the mask times its roll), as the reference's loss
    (``tp``: vocab-parallel, as ``_logp``)."""
    l2 = torch.roll(labels, -1, 1)
    m2 = mask * torch.roll(mask, -1, 1)
    if tp is not None:
        lp2 = _logp(mtp_logits, l2, tp)[0]
    else:
        lp2 = torch.gather(torch.log_softmax(mtp_logits.to(F32), -1),
                           -1, l2.clamp_min(0)[..., None])[..., 0]
    return torch.sum(lp2 * m2)


def _data_loss(tcfg, out, logp, logz, mask, mtp, dp) -> tuple:
    """A batch rank's share of the loss (``dp``: the batch group, ``pod``
    x ``data``): its rows' NLL, z-loss and (with an MTP head, ``mtp`` its
    rows' summed log-likelihood) MTP NLL sums over the global
    denominator, and the (global) aux loss over the batch ranks, so the
    shares sum to the unsharded loss; the metrics' ``loss``,
    ``mtp_loss`` and ``total_loss`` are the global values (one sum over
    the batch)."""
    from repro_torch.distributed.collectives import data_stats

    nll_s = -torch.sum(logp * mask)
    z_s = torch.sum((logz ** 2) * mask)
    sums = [mask.sum(), nll_s, z_s]
    if mtp is not None:
        sums.append(-mtp)
    st = data_stats(torch.stack(sums), dp)
    denom = torch.clamp(st[0], min=1.0)
    aux = tcfg.aux_loss_coef * out.aux_loss
    share = nll_s + tcfg.z_loss_coef * z_s
    if mtp is not None:
        share = share - tcfg.mtp_loss_coef * mtp
    loss = share / denom + aux / dp.size
    nll = st[1] / denom
    total = nll + tcfg.z_loss_coef * st[2] / denom + aux.detach()
    metrics = {"loss": nll, "aux_loss": out.aux_loss,
               "abft_flag": out.flag}
    if mtp is not None:
        metrics["mtp_loss"] = st[3] / denom
        total = total + tcfg.mtp_loss_coef * metrics["mtp_loss"]
    metrics["total_loss"] = total
    return loss, metrics


def value_and_grad(loss_fn: Callable) -> Callable:
    """(params, *args) -> ((loss, metrics), grads): autograd through
    ``loss_fn`` with respect to every leaf of the params tree (leaves are
    detached views: nothing is copied).  A leaf the loss never reads gets
    a zero gradient, as under ``jax.grad``: whisper's encoder and stem,
    whose output no decoder layer reads."""

    def run(params, *args):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, leaves), *args)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten(params, grads)

    return run


def _sum_over_data(grads, pl: Placement | None):
    """The gradients summed over the batch (``Placement.summed``; the
    FSDP leaves over ``pod``, ``Placement.pod_summed``)."""
    if pl is None or pl.bp is None:
        return grads
    from repro_torch.distributed.collectives import sum_grads

    leaves = tree_leaves(grads)
    for idx, g in ((pl.summed, pl.bp), (pl.pod_summed, pl.pp)):
        done = sum_grads([leaves[i] for i in idx], g)
        for i, t in zip(idx, done):
            leaves[i] = t
    return tree_unflatten(grads, leaves)


def make_grad_fn(model: Model, abft: ABFTConfig, tcfg: TrainConfig,
                 hints=None, device=None, mesh=None,
                 pl: Placement | None = None) -> Callable:
    """grad_fn(params, batch, fault) -> (loss, metrics, grads): the train
    step before its update.  ``loss`` is the total loss (the microbatches'
    mean), ``grads`` the whole batch's (the microbatches' mean in f32;
    on a mesh summed over ``data``), ``metrics["abft_flag"]`` the OR of
    every microbatch's flag and, on a mesh, of every rank's."""
    if pl is None and mesh is not None:
        pl = placement(model, mesh, hints)
    one = value_and_grad(make_loss_fn(model, abft, tcfg, hints=hints,
                                      device=device, mesh=mesh, pl=pl))
    world = pl.world if pl is not None else None

    def grad_fn(params, batch, fault):
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches

            def split(x, i):
                x = torch.as_tensor(x)
                b = x.shape[0]
                return x.reshape((mb, b // mb) + tuple(x.shape[1:]))[i]

            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device), params)
            loss_sum = 0.0
            flag = torch.zeros((), dtype=torch.bool)
            for i in range(mb):
                (loss, metrics), g = one(
                    params, {k: split(v, i) for k, v in batch.items()},
                    fault)
                grads = tree_map(lambda a, b: a + b.to(F32), grads, g)
                loss_sum = loss_sum + metrics.pop("total_loss", loss)
                flag = torch.logical_or(flag.to(loss.device),
                                        metrics["abft_flag"])
            grads = _sum_over_data(grads, pl)
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss_sum / mb
            metrics = {"loss": loss, "abft_flag": flag,
                       "aux_loss": torch.zeros((), dtype=F32,
                                               device=loss.device)}
        else:
            (loss, metrics), grads = one(params, batch, fault)
            loss = metrics.pop("total_loss", loss)
            grads = _sum_over_data(grads, pl)
        metrics["abft_flag"] = or_flag(metrics["abft_flag"], world)
        return loss, metrics, grads

    grad_fn.placement = pl
    return grad_fn


def make_train_step(model: Model, abft: ABFTConfig, tcfg: TrainConfig,
                    hints=None, device=None, mesh=None) -> Callable:
    """Returns step(params, opt_state, batch, fault=None) ->
    (params, opt_state, metrics).  Params and state are not modified.
    ``mesh``: the sharded step of the module docstring; ``batch`` is the
    global batch on every rank, ``params`` and ``opt_state`` the rank's
    shards (``init_opt_state(params, cfg, shards=step.placement.
    shards)``); the step's ``placement`` attribute holds its
    ``Placement`` (None unsharded)."""
    grad_fn = make_grad_fn(model, abft, tcfg, hints=hints, device=device,
                           mesh=mesh)
    pl = grad_fn.placement
    shards = pl.shards if pl is not None else None

    def step(params, opt_state, batch, fault=None):
        if fault is None:
            fault = ModelFault.none()
        loss, metrics, grads = grad_fn(params, batch, fault)
        new_params, new_opt, opt_metrics = opt_lib.update(
            grads, opt_state, params, tcfg.opt, shards)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return new_params, new_opt, metrics

    step.placement = pl
    return step
