"""Start k ranks, run one function on each, return the per-rank results.

    results = run(fn, k, *args, device=None | "cpu" | "cuda")

Each rank is a process of the ``spawn`` start method (``fn`` and its
arguments must be importable and picklable by name), joined to the others
by ``torch.distributed`` through a ``FileStore`` in a temporary directory,
so concurrent runs (parallel pytest workers) never race for a TCP port.
Rank r runs on ``cuda:{r % cards}``, or on the CPU where the caller asks
for it (``device=None`` is CUDA, as ``executor.resolve_device``), with one
intra-op thread.  The ranks have ``TIMEOUT_S`` to finish.

The backend follows ``pick_backend``'s predicate: NCCL when every rank has
a GPU of its own, gloo otherwise (the CPU, or k ranks sharing one card,
where NCCL refuses two ranks on one device).  The choice is printed to
stderr.  On CUDA the parent builds the kernels (``library.build_all``)
before it starts the ranks, so k ``nvcc`` builds never race in
``kernels/build/``.

A rank that returns waits at a barrier for every rank to return, and
hands its result to the parent before it destroys its process groups.
A rank that raises, or dies, fails the run: the parent waits up to
``GRACE_S`` for the other ranks' outcomes (a peer of a failed rank fails
too, on the closed connection, and may report first), raises one
``RuntimeError`` with every failed rank's traceback, and terminates the
ranks still running (a rank blocked in a collective with a dead peer
would wait for the process group's timeout otherwise).  Every started
process is joined or killed before ``run`` returns.
"""

from __future__ import annotations

import datetime
import os
import queue
import sys
import tempfile
import time
import traceback

import torch

TIMEOUT_S = 600.0
GRACE_S = 10.0


def pick_backend(k: int, device_type: str) -> str:
    """NCCL when every one of the k ranks has a GPU of its own (CUDA ranks
    and at least k cards), gloo otherwise."""
    import torch.distributed as dist

    if device_type == "cuda" and torch.cuda.device_count() >= k \
            and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def _worker(rank, k, store_path, backend, device_type, fn, args, out):
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, k), rank=rank,
            world_size=k, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            res = fn(*args)
            # no rank tears its groups down while a peer is still in the
            # last collective
            dist.barrier()
        except BaseException:
            dist.destroy_process_group()
            raise
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        return
    # the result reaches the parent before the teardown
    out.put((rank, True, res))
    out.close()
    out.join_thread()
    dist.destroy_process_group()


def run(fn, k: int, *args, device=None) -> list:
    """Run ``fn(*args)`` on k ranks (see the module docstring); returns
    the k results in rank order."""
    import torch.multiprocessing as mp

    from repro_torch.serve.executor import resolve_device

    device_type = resolve_device(device).type
    if device_type == "cuda":
        from repro_torch.kernels import library

        library.build_all()
    backend = pick_backend(k, device_type)
    print(f"spawn: {k} ranks on {device_type}, backend {backend}",
          file=sys.stderr, flush=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, k, store, backend, device_type,
                                   fn, args, out))
                 for r in range(k)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        failed: dict = {}
        try:
            while len(results) + len(failed) < k:
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results and r not in failed]
                    if dead and not failed:
                        raise RuntimeError(
                            f"rank(s) {dead} died (exit codes "
                            f"{[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        if failed:
                            break
                        raise RuntimeError(
                            f"ranks timed out after {TIMEOUT_S:.0f} s; "
                            f"{sorted(results)} finished")
                    continue
                if ok:
                    results[rank] = res
                    continue
                if not failed:
                    deadline = time.monotonic() + GRACE_S
                failed[rank] = res
            if failed:
                silent = [r for r in range(k)
                          if r not in results and r not in failed]
                raise RuntimeError("\n".join(
                    [f"rank {r} failed:\n{tb}" for r, tb in
                     sorted(failed.items())]
                    + [f"rank {r}: no result (exit code "
                       f"{procs[r].exitcode})" for r in silent]))
        finally:
            for p in procs:
                if len(results) < k and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(k)]
