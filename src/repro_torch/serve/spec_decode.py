"""Speculative decoding: draft proposers and acceptance rules (port of
``repro.serve.spec_decode``).

The serving engine speculates up to K tokens a slot a step, then scores
all K+1 positions in ONE ``verify`` call through the dense or paged
cache (``ModelRunner.verify`` -> ``Model.verify``).  This module holds
everything around that call:

* ``DraftProposer`` — the protocol the engine drives, and two
  implementations:

  - ``NGramProposer``: prompt-lookup drafting.  The longest trailing
    n-gram of ``prompt + generated`` is matched against its own history
    and the K tokens that followed the newest earlier occurrence are
    proposed.  Pure numpy, no model cost.
  - ``SelfDraftProposer``: greedy continuation through the first
    ``units`` layers of the SAME weights and the head, over a fixed
    trailing window (no draft cache, no second parameter set).

* Acceptance — ``greedy_accept`` (the longest prefix of drafts matching
  the targets, plus one bonus target) and ``rejection_sample``
  (speculative sampling against a point-mass draft: exact in law).

Greedy invariant.  Verify row j of a slot scores x_j at position pos+j
(x_0 the last committed token, x_{j+1} = drafts[j]); its argmax is the
token the unsped engine emits there PROVIDED x_1..x_j matched the
targets before them, which is the acceptance condition, so the streams
are equal token for token.  The port also makes verify row j's logits
the decode step's bit for bit on the card (``Model.verify``), so the
argmax cannot flip on a near-tie.  Draft quality moves throughput only;
proposers run unprotected (their flags are ignored) because the
ABFT-checked verify step is the integrity boundary.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models.layers import LayerCtx, norm
from repro_torch.models.model import Model

_EMPTY = np.zeros((0,), np.int32)


def _history(req) -> np.ndarray:
    return np.concatenate([np.asarray(req.prompt, np.int32),
                           np.asarray(req.generated, np.int32)])


@runtime_checkable
class DraftProposer(Protocol):
    """Anything the engine can ask for draft tokens.  ``propose`` may
    return FEWER than ``k`` tokens (zero included: the slot then verifies
    its last token alone), never more."""

    name: str

    def propose(self, req, k: int) -> np.ndarray:  # (<= k,) int32
        ...


# ------------------------------------------------------------- proposers

class NGramProposer:
    """Prompt-lookup drafting: longest-suffix n-gram match over the
    request's own history (prompt + generated), newest occurrence wins,
    proposing the K tokens that followed it."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError("need 1 <= min_n <= max_n")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, req, k: int) -> np.ndarray:
        if k <= 0:
            return _EMPTY
        hist = _history(req)
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(hist) <= n:
                continue
            tail = hist[-n:]
            windows = np.lib.stride_tricks.sliding_window_view(hist, n)
            # the trailing window IS the tail: excluded
            hits = np.nonzero((windows[:-1] == tail).all(axis=1))[0]
            if hits.size:
                # newest occurrence wins, but one with a full K-token
                # continuation is preferred: a periodic tail otherwise
                # matches itself near the end and proposes one token
                full = hits[hits + n + k <= len(hist)]
                i = int(full[-1] if full.size else hits[-1]) + n
                return hist[i:i + k].astype(np.int32)
        return _EMPTY


class SelfDraftProposer:
    """Self-draft by truncated depth: greedy K-step continuation through
    the first ``units`` layers of the serving weights and the head, over
    the trailing ``window`` tokens (left-padded with token 0 at position
    0 while the history is shorter, as the reference pads).  Stateless:
    each draft step re-reads the window.  Its GEMMs go through
    ``protected_matmul`` under the engine's level-0 ``LayerCtx`` (K1 on
    the card); their flags are ignored.  ``params_fn`` returns the
    engine's live parameters."""

    name = "self_draft"

    def __init__(self, model: Model, ctx: LayerCtx, params_fn, *,
                 units: int = 1, window: int = 8):
        self.model = model
        self.ctx = ctx
        self.window = int(window)
        self.units = max(1, int(units))
        self._params_fn = params_fn

    @torch.no_grad()
    def propose(self, req, k: int) -> np.ndarray:
        if k <= 0:
            return _EMPTY
        hist = _history(req)
        w = self.window
        toks = np.zeros((w,), np.int64)
        n = min(w, len(hist))
        toks[w - n:] = hist[-n:]
        start = len(hist) - w
        positions = np.maximum(np.arange(start, start + w), 0)
        params = self._params_fn()
        dev = params["embed"].device
        sub = {"layers": params["layers"][:self.units]}
        cfg = self.model.cfg
        t = torch.from_numpy(toks).to(dev)
        p = torch.from_numpy(positions).to(dev)
        out = []
        for _ in range(int(k)):
            x = params["embed"][t][None]                   # (1, W, D)
            h, _, _ = self.model.run_stack(x, sub, self.ctx, p[None],
                                           "full", None)
            h = norm(h, params["final_norm"], cfg.norm, cfg.norm_eps)
            logits, _ = self.model._head(params, h[:, -1:, :], self.ctx)
            nxt = torch.argmax(logits[0, -1])
            out.append(nxt)
            t = torch.cat([t[1:], nxt[None]])
            p = p + 1
        return torch.stack(out).cpu().numpy().astype(np.int32)


# ------------------------------------------------------------ acceptance

def greedy_accept(drafts: np.ndarray, targets: np.ndarray) -> list:
    """``targets[j]``: the argmax of verify row j (the token the unsped
    engine emits after x_0..x_j).  Accept the longest prefix where each
    draft equals the target before it, then emit one bonus target: a+1
    tokens for a accepted drafts."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(targets[a]):
        a += 1
    return [int(t) for t in targets[:a + 1]]


def target_probs(logits: np.ndarray, temperature: float,
                 top_k: int = 0) -> np.ndarray:
    """Rows of verify logits -> the engine's sampling distribution
    (temperature and optional top-k cutoff), f64 normalized."""
    lg = np.asarray(logits, np.float64) / max(float(temperature), 1e-8)
    if top_k > 0:
        k = min(int(top_k), lg.shape[-1])
        kth = np.sort(lg, axis=-1)[..., -k][..., None]
        lg = np.where(lg < kth, -np.inf, lg)
    lg -= lg.max(axis=-1, keepdims=True)
    p = np.exp(lg)
    return p / p.sum(axis=-1, keepdims=True)


def _uniform(gen) -> float:
    """One U[0, 1) draw from the slot's generator, in f64."""
    return float(torch.rand((), generator=gen, device=gen.device,
                            dtype=torch.float64))


def _choice(p: np.ndarray, u: float) -> int:
    """Inverse-CDF draw from the (unnormalized, non-negative) weights
    ``p`` with the uniform ``u``: an index of zero weight is never
    drawn."""
    c = np.cumsum(p)
    return int(min(np.searchsorted(c, u * c[-1], side="right"),
                   len(p) - 1))


def rejection_sample(drafts: np.ndarray, probs: np.ndarray, gen) -> list:
    """Speculative sampling against a point-mass draft: accept draft d at
    row j with probability p_j(d); on rejection emit a draw from p_j with
    d removed and renormalized (the residual of the rejection rule for a
    point-mass q) and stop; after a fully accepted window emit a bonus
    draw from the last row.  Exact in law: each emitted token follows its
    row's target distribution.  ``gen``: the slot's ``torch.Generator``;
    the engine calls this after the verify attempt is accepted, so a
    retry redraws nothing."""
    emitted = []
    for j in range(len(drafts)):
        d = int(drafts[j])
        pj = probs[j]
        if _uniform(gen) < float(pj[d]):
            emitted.append(d)
            continue
        resid = np.array(pj)
        resid[d] = 0.0
        if float(resid.sum()) <= 0.0:          # p was a point mass at d
            emitted.append(int(np.argmax(pj)))
        else:
            emitted.append(_choice(resid, _uniform(gen)))
        return emitted
    emitted.append(_choice(probs[len(drafts)], _uniform(gen)))
    return emitted


def make_proposer(spec, model: Model, ctx: LayerCtx, params_fn,
                  *, units: int = 1, window: int = 8) -> DraftProposer:
    """Engine-facing factory: a name ("ngram" | "self_draft") or an
    already-built proposer."""
    if isinstance(spec, str):
        name = spec.replace("-", "_")
        if name in ("ngram", "prompt_lookup"):
            return NGramProposer()
        if name == "self_draft":
            return SelfDraftProposer(model, ctx, params_fn,
                                     units=units, window=window)
        raise ValueError(f"unknown draft proposer {spec!r} "
                         "(want 'ngram' or 'self_draft')")
    if not hasattr(spec, "propose"):
        raise TypeError("spec_decode must be a proposer name or an "
                        "object with a .propose(req, k) method")
    return spec
