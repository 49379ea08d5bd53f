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
  device: each leaf on that of its ``tree_like`` leaf.

Sharded state (``shardings=``, a tree of ``sharding.NamedSharding``
matching the tree, as ``sharding.make_sharding`` builds it; every rank
of the mesh calls): a save writes whole leaves in the same manifest
format, so the checkpoint restores unsharded in the port and in the
reference.  Each leaf the specs split is gathered whole onto the mesh's
rank 0 (one gather a leaf, through the host under gloo), which writes it
with the crc32 of the whole leaf; ``wait`` joins the writer and holds
every rank at a barrier, so no rank reads a checkpoint before it is
renamed into place.  A restore reads each whole leaf on every rank,
validates it whole and keeps the rank's ``shard_slices`` at the mesh the
shardings name, which may differ from the saving mesh (reshard-on-
restore: an elastic restart onto fewer ranks).
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


def _flat_shardings(tree, shardings) -> dict:
    """{key: NamedSharding} of ``shardings`` walked as ``tree``."""
    out = []
    tree_map(lambda leaf, sh: out.append(sh), tree, shardings)
    return dict(zip(_flatten(tree), out))


def _split(sh, shape) -> bool:
    """Whether ``sh`` splits a leaf of ``shape`` over any mesh axis."""
    return any(i < len(sh.spec) and sh.spec[i] is not None
               for i in range(len(shape)))


def _gather_whole(leaf, sh, world):
    """``leaf`` (this rank's shard under ``sh``) made whole on the mesh's
    rank 0, on the host (None on the other ranks): every rank's shard
    gathered there and laid at its ``shard_slices``."""
    from repro_torch.distributed.collectives import gather_to_root
    from repro_torch.distributed.sharding import axes_size, shard_slices

    mesh = sh.mesh
    parts = gather_to_root(leaf.detach().contiguous(), world)
    if parts is None:
        return None
    full = tuple(int(n) * axes_size(mesh, sh.spec[i] if i < len(sh.spec)
                                     else None)
                 for i, n in enumerate(leaf.shape))
    out = torch.empty(full, dtype=leaf.dtype)
    for r, part in enumerate(parts):
        pos = np.argwhere(mesh.grid == r)[0]
        coords = dict(zip(mesh.axis_names, (int(i) for i in pos)))
        out[shard_slices(sh.spec, full, mesh, coords)] = part.cpu()
    return out


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._world = None      # the mesh's ranks after a sharded save

    def _whole(self, tree, shardings):
        """The host tree of whole leaves on the mesh's rank 0 (None on
        the others) of a sharded ``tree``; ``tree`` as a host copy
        without ``shardings``."""
        if shardings is None:
            self._world = None
            return tree_map(_host_copy, tree)
        from repro_torch.distributed.collectives import grid_group

        flat_sh = _flat_shardings(tree, shardings)
        mesh = next(iter(flat_sh.values())).mesh
        world = grid_group(mesh)
        self._world = world
        root = mesh.rank == int(mesh.grid.reshape(-1)[0])
        leaves = []
        for key, leaf in _flatten(tree).items():
            sh = flat_sh[key]
            if world is not None and isinstance(leaf, torch.Tensor) \
                    and _split(sh, leaf.shape):
                leaves.append(_gather_whole(leaf, sh, world))
            else:
                leaves.append(_host_copy(leaf) if root else None)
        return tree_unflatten(tree, leaves) if root else None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, shardings=None) -> pathlib.Path | None:
        """Synchronous save with checksums + atomic rename.
        ``shardings``: a sharded save (module docstring), every rank of
        the mesh calling; the path on the writer, None elsewhere."""
        if shardings is not None:
            tree = self._whole(tree, shardings)
            path = None if tree is None else self.save(step, tree)
            self._barrier()
            return path
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

    def save_async(self, step: int, tree, shardings=None) -> None:
        """Overlap checkpoint I/O with training: snapshot to host memory
        (sharded: gather the whole leaves onto the writer, on every rank
        of the mesh), write in a background thread."""
        self.wait()
        host_tree = self._whole(tree, shardings)
        if host_tree is None:
            return
        self._thread = threading.Thread(
            target=self.save, args=(step, host_tree), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the writer; after a sharded save, every rank of its mesh
        waits for it (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _barrier(self) -> None:
        if self._world is not None:
            import torch.distributed as dist

            dist.barrier(group=self._world.group)

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
        device of its ``tree_like`` leaf.  ``shardings`` (a
        ``make_sharding`` tree matching ``tree_like``): each leaf cut to
        this rank's ``shard_slices`` at the shardings' mesh after its
        whole leaf is validated.  Returns (tree, step)."""
        from repro_torch.distributed.sharding import shard_slices

        flat_sh = (_flat_shardings(tree_like, shardings)
                   if shardings is not None else None)
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
            if flat_sh is not None:
                sh = flat_sh[key]
                mesh = sh.mesh
                t = t[shard_slices(sh.spec, t.shape, mesh, mesh.coords())]
            leaves.append(t.to(like.device if isinstance(like, torch.Tensor)
                                else "cpu", copy=flat_sh is not None))
        return tree_unflatten(tree_like, leaves), step
