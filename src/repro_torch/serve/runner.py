"""Model-runner layer of the serving engine (port of
``repro.serve.runner``): the eager ``decode``, ``prefill``,
``prefill_prefix``, ``prefill_chunk`` and ``verify`` entry points with the
slot-masked sampler.  The prefill entry points run K1 with
``ABFTConfig.one_slice`` set (one K slice whatever M), so a prompt's rows
get the same bits prefilled whole, as a suffix or in chunks; ``verify``
runs it with ``ABFTConfig.decode_rows`` set to the slot count, so a
verify row gets the bits the decode step computes at its position.

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

Under sharding every entry point ORs its flag over the whole world
before it returns (``collectives.or_flag``), so the engine's
detect->retry decisions see one value on every rank, and the sampler
draws from the logits the head gathered whole.  Over the data axis
(``rows``, the executor's ``layout``) ``decode`` and ``verify`` split
their rows: data rank r runs its own slots [lo, lo + n) against its
cache shard (one MoE dispatch group: ``LayerCtx.moe_groups = 1``, and a
fault's logical row lands on its owner), then the logits rows are
gathered over ``data`` and every rank samples every slot, so the
generators stay identical.  The prefill entry points run the whole
batch on every data rank.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.collectives import gather_first, or_flag
from repro_torch.models.layers import LayerCtx
from repro_torch.models.model import Model


class ModelRunner:
    """Prefill/decode entry points for one model + layer context."""

    def __init__(self, model: Model, ctx: LayerCtx, *,
                 temperature: float = 0.0, top_k: int = 0, rows=None,
                 world=None):
        self.model = model
        self.ctx = ctx
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        # the rank's own slots of a split decode or verify (lo, n), and
        # the group every flag is ORed over
        self.rows = rows
        self.world = world if world is not None else ctx.tp

    def _split(self, ctx, *rows):
        """A split call's context (its rows, one MoE group) and its row
        inputs cut to the rank's slots; the inputs as given elsewhere."""
        if self.rows is None:
            return (ctx,) + rows
        lo, n = self.rows
        ctx = dataclasses.replace(ctx, rows=(lo, n), moe_groups=1)
        return (ctx,) + tuple(None if t is None else t[lo:lo + n]
                              for t in rows)

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
        slot is inactive; flag; the cache list the step commits).  The
        attention layers are written in place; a Mamba2 layer's next
        state comes back in new tensors (``Model.decode``)."""
        ctx, tok, pos, tables = self._split(
            dataclasses.replace(self.ctx, fault=fault), tok, pos, tables)
        logits, new_cache, flag = self.model.decode(p, tok, cache, pos, ctx,
                                                    block_tables=tables)
        logits = gather_first(logits, ctx.batch) if self.rows else logits
        nxt = self.sample(logits[:, 0, :], gens)
        nxt = torch.where(mask, nxt, torch.full_like(nxt, -1))
        return nxt, or_flag(flag, self.world), new_cache

    @torch.no_grad()
    def prefill(self, p, toks, cache, slot_ids, lengths, tables, fault,
                gens=None, prefix_lens=None):
        """Prefill an admission batch into its cache rows; returns (first
        sampled token per row, flag)."""
        ctx = dataclasses.replace(
            self.ctx, fault=fault,
            abft=dataclasses.replace(self.ctx.abft, one_slice=True))
        logits, _, flag = self.model.prefill(
            p, toks, cache, ctx, slots=slot_ids, lengths=lengths,
            block_tables=tables, prefix_lens=prefix_lens)
        return self.sample(logits[:, 0, :], gens), or_flag(flag, self.world)

    def prefill_prefix(self, p, toks, cache, slot_ids, lengths, tables,
                       prefix_lens, fault, gens=None):
        """Prefill only each row's unshared suffix, whose first token sits
        at logical position ``prefix_lens[a]`` (prefix sharing)."""
        return self.prefill(p, toks, cache, slot_ids, lengths, tables,
                            fault, gens, prefix_lens=prefix_lens)

    def prefill_chunk(self, p, toks, cache, slot_ids, lengths, tables,
                      starts, final, fault, gens=None):
        """One co-scheduled prefill chunk per row, starting at logical
        position ``starts[a]``.  Only rows whose chunk completes the prompt
        (``final``) emit a token (-1 elsewhere); the engine hands those
        rows' generators alone, so a prompt's draws do not depend on how
        it was chunked and padding rows never draw."""
        first, flag = self.prefill(p, toks, cache, slot_ids, lengths,
                                   tables, fault, gens, prefix_lens=starts)
        first = torch.where(final.to(first.device), first,
                            torch.full_like(first, -1))
        return first, flag

    @torch.no_grad()
    def verify(self, p, toks, cache, pos, valid, tables, fault):
        """Speculative verify: score T = K+1 positions a slot in one call.
        ``toks`` (B, T): each row's last committed token and its padded
        draft window; ``valid`` (B,): the usable window a row.  Returns
        (all T logits rows (B, T, V) f32, flag); acceptance and sampling
        run on the host (``serve/spec_decode.py``), so the call draws
        nothing and a retry redraws nothing.  Inactive rows (valid 0)
        write nothing; their logits are never read."""
        ctx, toks, pos, valid, tables = self._split(
            dataclasses.replace(self.ctx, fault=fault), toks, pos, valid,
            tables)
        ctx = dataclasses.replace(
            ctx, abft=dataclasses.replace(ctx.abft,
                                          decode_rows=toks.shape[0]))
        logits, _, flag = self.model.verify(p, toks, cache, pos, ctx, valid,
                                            block_tables=tables)
        logits = gather_first(logits, ctx.batch) if self.rows else logits
        return logits, or_flag(flag, self.world)
