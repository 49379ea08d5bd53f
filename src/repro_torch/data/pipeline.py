"""Data pipeline: deterministic, shardable, resumable token streams (copy
of ``repro.data.pipeline``: numpy, so the batches are the reference's).

Production posture: each data-parallel replica reads only its shard of the
global batch (``host_slice``); the stream is keyed by (seed, step) so any
step can be regenerated exactly after a restart — data state lives in the
checkpoint as a single integer.  Backends:

* ``SyntheticLM`` — zipf-distributed token stream with a fixed-size
  "document" structure (realistic padding/mask patterns) for training and
  benchmarks without external datasets.
* ``MemmapCorpus`` — a binary token file memory-mapped per host; each host
  reads its slice only (no global shuffle buffer at scale — shuffling is
  index-based).
* ``prefetch`` — double-buffered host->device pipeline so input copy
  overlaps the previous step's compute.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    pad_id: int = -1
    mean_doc_len: int = 512


class SyntheticLM:
    """Deterministic synthetic LM stream: batch(step) is a pure function of
    (seed, step) — restart-safe by construction."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        # zipf-ish marginal over the vocab (realistic embedding access)
        z = rng.zipf(1.3, size=(per, cfg.seq_len + 1))
        toks = (z % (cfg.vocab_size - 2)) + 1
        # document boundaries: insert EOS(=0) with geometric spacing
        eos_mask = rng.random((per, cfg.seq_len + 1)) < (
            1.0 / cfg.mean_doc_len)
        toks = np.where(eos_mask, 0, toks).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
        }


class MemmapCorpus:
    """Token corpus in a flat binary file (np.int32), sharded by host."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_tokens = len(self.data)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        per = cfg.global_batch // n_hosts
        span = cfg.seq_len + 1
        n_seqs = self.n_tokens // span
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host_id]))
        idx = rng.integers(0, n_seqs, size=per)
        rows = np.stack([
            self.data[i * span: (i + 1) * span] for i in idx])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:].copy()}


class Prefetcher:
    """Double-buffered background prefetch (host->device copy overlap)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2,
                 host_id: int = 0, n_hosts: int = 1, put_fn=None):
        self.source = source
        self.put_fn = put_fn or (lambda x: x)
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._host = (host_id, n_hosts)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            b = self.source.batch(self._step, *self._host)
            self.q.put((self._step, self.put_fn(b)))
            self._step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue_mod.Empty:
            pass
