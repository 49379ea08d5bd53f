"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface under
``kernels/build/`` (listed in ``.gitignore``), at the first CUDA use —
never at import, since a machine without ``nvcc`` must still import the
package.  A library is rebuilt when its source, or any shared header
``csrc/*.cuh``, is newer.  Wrappers call
the C entry points through ``ctypes`` with pointers and the current
stream as ``c_void_p`` and raise on a non-zero ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("abft_matmul", "flash_attention", "flash_decode")

_LIBS: dict = {}


class Kernel:
    """One hand-written kernel: its source and its launch count (a plain
    integer the wrapper bumps exactly where it launches the kernel)."""

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = source
        self.launches = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(name: str) -> bool:
    so = BUILD / f"lib{name}.so"
    if not so.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build_all(force: bool = False) -> dict:
    """Compile every source that is missing or stale, one ``nvcc`` each,
    in parallel.  Returns {name: seconds} of the builds that ran; each
    build's compiler output (registers, spills) lands in ``build/*.log``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    todo = [n for n in SOURCES if force or _stale(n)]
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        log = open(BUILD / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(BUILD / f"lib{name}.so.tmp"),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), log)
    took, failed = {}, []
    for name, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
        else:
            os.replace(BUILD / f"lib{name}.so.tmp", BUILD / f"lib{name}.so")
    if failed:
        logs = "\n".join((BUILD / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return took


def _declare(lib: ctypes.CDLL, name: str) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    if name == "abft_matmul":
        fn = lib.abft_matmul_launch
        fn.argtypes = [p] * 9 + [i, i, i, ll, ll, ll] + [i, ll, ll] \
            + [i] * 11 + [i] * 6 + [f, p]
        fn.restype = i
    elif name == "flash_attention":
        for fn in (lib.flash_attention_launch,
                   lib.flash_attention_tc_launch):
            fn.argtypes = [p] * 8 + [i] * 12 + [ll] * 9 + [f] + [i] * 6 \
                + [p]
            fn.restype = i
    else:
        fn = lib.flash_decode_launch
        fn.argtypes = [p] * 12 + [i] * 11 + [ll, f, i, p]
        fn.restype = i
        lib.flash_decode_smem_bytes.argtypes = [i] * 4
        lib.flash_decode_smem_bytes.restype = i
        lib.flash_decode_scratch_floats.argtypes = [i] * 6
        lib.flash_decode_scratch_floats.restype = ll
        lib.flash_decode_capture_id.argtypes = [p]
        lib.flash_decode_capture_id.restype = ctypes.c_ulonglong


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name!r} needs a CUDA device")
        if any(_stale(n) for n in SOURCES):
            build_all()
        lib = ctypes.CDLL(str(BUILD / f"lib{name}.so"))
        _declare(lib, name)
        _LIBS[name] = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"kernel {name} launch failed: cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
