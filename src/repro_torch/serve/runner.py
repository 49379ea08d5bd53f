"""Model-runner layer of the serving engine (port of
``repro.serve.runner``): the eager ``decode`` and ``prefill`` entry
points with the slot-masked greedy sampler.  Sampling with a temperature
is not ported."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model


class ModelRunner:
    """Prefill/decode entry points for one model + layer context."""

    def __init__(self, model: Model, ctx: LayerCtx):
        self.model = model
        self.ctx = ctx

    @torch.no_grad()
    def decode(self, p, tok, cache, pos, mask, tables, fault):
        """One decode step; returns (next token per slot, -1 where the
        slot is inactive; flag).  The cache is written in place."""
        logits, _, flag = self.model.decode(
            p, tok, cache, pos, dataclasses.replace(self.ctx, fault=fault),
            block_tables=tables)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        nxt = torch.where(mask, nxt, torch.full_like(nxt, -1))
        return nxt, flag

    @torch.no_grad()
    def prefill(self, p, toks, cache, slot_ids, lengths, tables, fault):
        """Prefill an admission batch into its cache rows; returns (first
        sampled token per row, flag)."""
        logits, _, flag = self.model.prefill(
            p, toks, cache, dataclasses.replace(self.ctx, fault=fault),
            slots=slot_ids, lengths=lengths, block_tables=tables)
        return torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32), flag
