"""Train-step construction (port of ``repro.train.train_step``): CE loss
with z-loss, aux loss and the MTP head's loss, microbatched gradient
accumulation in f32, the OR of the forward's ABFT flags, and the
optimizer update.

The step differentiates ``Model.forward`` with autograd.  Every
block-protected forward GEMM runs K1 (its plain version on the CPU);
their backward is plain ``torch.matmul``, unprotected, as the reference's
XLA backward of its emulation is.  The flag of the *forward* pass is in
the metrics; the trainer re-executes a flagged step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.protected import ABFTConfig
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
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


def make_loss_fn(model: Model, abft: ABFTConfig, tcfg: TrainConfig,
                 hints=None, device=None) -> Callable:
    """loss_fn(params, batch, fault=None) -> (loss, metrics), on
    ``device`` (CUDA unless the caller passes ``"cpu"``).  The batch's
    memory inputs (``audio``, ``enc_input``, ``images``) reach
    ``Model.forward`` beside its tokens, as the reference's loss passes
    its batch whole.  With MTP logits
    the loss gains ``mtp_loss_coef`` x the MTP head's NLL of token t + 2
    (labels rolled one more step, the mask times its roll), over the main
    loss's denominator, as the reference's.  Sharding hints are not
    ported."""
    if hints is not None:
        raise NotImplementedError("sharding hints are not ported")
    dev = resolve_device(device)

    def loss_fn(params, batch, fault=None):
        ctx = LayerCtx(abft=abft, fault=fault)
        out = model.forward(params, batch, ctx, device=dev)
        logits = out.logits.to(F32)
        labels = torch.as_tensor(batch["labels"]).to(dev).long()
        logz = torch.logsumexp(logits, dim=-1)
        logp = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None])[..., 0] - logz
        mask = (labels >= 0).to(F32)
        denom = torch.clamp(mask.sum(), min=1.0)
        nll = -torch.sum(logp * mask) / denom
        loss = nll + tcfg.z_loss_coef * torch.sum((logz ** 2) * mask) / denom
        loss = loss + tcfg.aux_loss_coef * out.aux_loss
        if out.mtp_logits is not None:
            l2 = torch.roll(labels, -1, 1)
            m2 = mask * torch.roll(mask, -1, 1)
            lp2 = torch.gather(torch.log_softmax(out.mtp_logits.to(F32), -1),
                               -1, l2.clamp_min(0)[..., None])[..., 0]
            loss = loss - tcfg.mtp_loss_coef * torch.sum(lp2 * m2) / denom
        metrics = {"loss": nll, "aux_loss": out.aux_loss,
                   "abft_flag": out.flag}
        return loss, metrics

    return loss_fn


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


def make_train_step(model: Model, abft: ABFTConfig, tcfg: TrainConfig,
                    hints=None, device=None) -> Callable:
    """Returns step(params, opt_state, batch, fault=None) ->
    (params, opt_state, metrics).  Params and state are not modified."""
    grad_fn = value_and_grad(make_loss_fn(model, abft, tcfg, hints=hints,
                                          device=device))

    def step(params, opt_state, batch, fault=None):
        if fault is None:
            fault = ModelFault.none()
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
                (loss, metrics), g = grad_fn(
                    params, {k: split(v, i) for k, v in batch.items()},
                    fault)
                grads = tree_map(lambda a, b: a + b.to(F32), grads, g)
                loss_sum = loss_sum + loss
                flag = torch.logical_or(flag.to(loss.device),
                                        metrics["abft_flag"])
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss_sum / mb
            metrics = {"loss": loss, "abft_flag": flag,
                       "aux_loss": torch.zeros((), dtype=F32,
                                               device=loss.device)}
        else:
            (loss, metrics), grads = grad_fn(params, batch, fault)
        new_params, new_opt, opt_metrics = opt_lib.update(
            grads, opt_state, params, tcfg.opt)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return new_params, new_opt, metrics

    return step
