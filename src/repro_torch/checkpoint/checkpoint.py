"""Checksummed, atomic, async checkpointing with restart support (port of
``repro.checkpoint.checkpoint``).

* One ``.npy`` blob per leaf per step plus a JSON manifest with the leaf
  paths, shapes, dtypes and per-leaf CRC32 checksums.  numpy has no
  bfloat16: a bf16 leaf is written as its raw ``uint16`` bits and the
  manifest keeps the torch dtype.
* Writes go to a temporary directory, fsync'd, then atomically renamed: a
  crash mid-write never corrupts the latest checkpoint.
* ``save_async`` snapshots the tree to host memory and writes it in a
  background thread; ``wait()`` joins before the next save.
* ``restore`` validates the checksums and returns tensors on the caller's
  device: each leaf on that of its ``tree_like`` leaf.  Resharding onto a
  mesh waits for the port's sharding.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves_with_path, tree_map, tree_unflatten

_SEP = "\x1e"  # record separator: path key join


def _flatten(tree) -> dict:
    return {_SEP.join(str(p) for p in path): leaf
            for path, leaf in tree_leaves_with_path(tree)}


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _to_numpy(leaf):
    """(array, torch dtype name or None); bf16 as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), str(t.dtype)
    return t.numpy(), str(t.dtype)


def _from_numpy(arr: np.ndarray, torch_dtype: str | None):
    if torch_dtype == "torch.bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree) -> pathlib.Path:
        """Synchronous save with checksums + atomic rename."""
        flat = _flatten(tree)
        tmp = self.dir / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": int(step), "leaves": {}}
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            arr, tdtype = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            with open(tmp / fname, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "torch_dtype": tdtype,
                "crc32": _crc(arr),
            }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self.dir / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def save_async(self, step: int, tree) -> None:
        """Overlap checkpoint I/O with training: snapshot to host memory,
        write in a background thread."""
        self.wait()
        host_tree = tree_map(_host_copy, tree)
        self._thread = threading.Thread(
            target=self.save, args=(step, host_tree), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(self.dir.glob("step_*"))
        if not steps:
            return None
        return int(steps[-1].name.split("_")[1])

    def restore(self, tree_like, step: int | None = None, shardings=None,
                validate: bool = True):
        """Restore into the structure of ``tree_like``, each leaf on the
        device of its ``tree_like`` leaf.  Returns (tree, step)."""
        if shardings is not None:
            raise NotImplementedError("reshard-on-restore waits for the "
                                      "port's sharding")
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        for path, like in tree_leaves_with_path(tree_like):
            key = _SEP.join(str(p) for p in path)
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(d / meta["file"])
            if validate and _crc(arr) != meta["crc32"]:
                raise IOError(
                    f"checksum mismatch for {key!r} in step {step} "
                    "(corrupted checkpoint)")
            t = _from_numpy(arr, meta.get("torch_dtype"))
            leaves.append(t.to(like.device if isinstance(like, torch.Tensor)
                                else "cpu"))
        return tree_unflatten(tree_like, leaves), step
