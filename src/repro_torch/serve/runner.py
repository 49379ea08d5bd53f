"""Model-runner layer of the serving engine (port of
``repro.serve.runner``): the eager ``decode`` and ``prefill`` entry
points with the slot-masked sampler.

Sampling contract: greedy argmax (``temperature == 0``) draws nothing.
With ``temperature > 0`` each row draws from ``softmax(logits / T)``
restricted to its ``top_k`` largest logits (``top_k`` clamped to the
vocab; 0 means no cutoff), through the row's own ``torch.Generator``.
The engine hands one generator per slot and ``None`` for rows that must
not draw (inactive slots), and saves and restores the generators around
retries, so a slot's draws depend only on its own accepted steps and a
retry redraws the same token.  The reference's JAX keys give the same
contract; its draws differ (another generator), so the two agree in law
only.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model


class ModelRunner:
    """Prefill/decode entry points for one model + layer context."""

    def __init__(self, model: Model, ctx: LayerCtx, *,
                 temperature: float = 0.0, top_k: int = 0):
        self.model = model
        self.ctx = ctx
        self.temperature = float(temperature)
        self.top_k = int(top_k)

    def sample(self, logits, gens) -> torch.Tensor:
        """logits: (n, V) -> (n,) int32 token ids; ``gens[i] is None``
        gives -1 (the row draws nothing) when sampling."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        lg = logits.float() / self.temperature
        if self.top_k > 0:
            kth = torch.topk(lg, min(self.top_k, lg.shape[-1]),
                             dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
        probs = torch.softmax(lg, dim=-1)
        out = torch.full((lg.shape[0],), -1, dtype=torch.int32,
                         device=lg.device)
        for i, g in enumerate(gens):
            if g is not None:
                out[i] = torch.multinomial(probs[i], 1, generator=g)[0]
        return out

    @torch.no_grad()
    def decode(self, p, tok, cache, pos, mask, tables, fault, gens=None):
        """One decode step; returns (next token per slot, -1 where the
        slot is inactive; flag).  The cache is written in place."""
        logits, _, flag = self.model.decode(
            p, tok, cache, pos, dataclasses.replace(self.ctx, fault=fault),
            block_tables=tables)
        nxt = self.sample(logits[:, 0, :], gens)
        nxt = torch.where(mask, nxt, torch.full_like(nxt, -1))
        return nxt, flag

    @torch.no_grad()
    def prefill(self, p, toks, cache, slot_ids, lengths, tables, fault,
                gens=None):
        """Prefill an admission batch into its cache rows; returns (first
        sampled token per row, flag)."""
        logits, _, flag = self.model.prefill(
            p, toks, cache, dataclasses.replace(self.ctx, fault=fault),
            slots=slot_ids, lengths=lengths, block_tables=tables)
        return self.sample(logits[:, 0, :], gens), flag
