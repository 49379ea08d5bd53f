"""K1: fused block-ABFT matmul, the CUDA kernel ``csrc/abft_matmul.cu``.

Replaces the TPU kernel ``repro.kernels.abft_matmul.abft_matmul_kernel``.
``abft_matmul_kernel`` checks its operands, allocates the outputs and the
split-K scratch with ``torch.empty``, launches on the current stream and
counts the launch in ``KERNEL.launches``.  Its plain version is
``kernels/ref.py::abft_matmul_ref``; the user-facing wrapper (block
clamping, fault translation, threshold and flag) is ``kernels/ops.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library

F32 = torch.float32
MODES = ("1s", "2s", "replica")
KERNEL = library.Kernel("abft_matmul",
                        "src/repro_torch/kernels/csrc/abft_matmul.cu")

TN, TK = 64, 32          # CUDA tile columns and stage depth (see the .cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132               # H100 SXM streaming multiprocessors


def rows_per_thread(bm: int) -> int:
    """CUDA tile height is 8 * rows_per_thread: 8 rows for decode-thin
    GEMMs, up to 64 rows for prefill."""
    return 1 if bm <= 8 else 4 if bm <= 32 else 8


def gemv_path(x, w, bn: int, mode: str) -> bool:
    """The decode fast path of pass 1 (a GEMV over 16-byte rows of W)
    takes M <= 8 rows, the one-sided partials (modes 1s/2s), a row-major
    W whose rows are 16-byte aligned, N % 8 == 0 and bn % 64 == 0."""
    esz = w.element_size()
    return (x.shape[0] <= 8 and mode != "replica" and w.stride(1) == 1
            and w.shape[1] % 8 == 0 and bn % TN == 0
            and (w.stride(0) * esz) % 16 == 0 and w.data_ptr() % 16 == 0)


def split_k(m: int, k: int, n: int, bm: int, bk: int, bn: int,
            mode: str, gemv: bool = False) -> tuple:
    """(slices, depth) of the K split: enough CUDA blocks for two waves
    over the SMs.  Tiled pass 1: slices at least 256 deep and — for the
    replica checksum, which flushes per logical k-block — aligned to
    ``bk``.  GEMV pass 1: one block per 64 columns, slices a multiple of
    its 32 k-rows per iteration, at most 16 of them."""
    if gemv:    # at most 16 slices: pass 2 sums them element by element
        tiles, unit, floor = -(-n // TN), 32, max(32, -(-k // 16))
    else:
        rm = rows_per_thread(bm)
        tiles = (-(-n // bn) * -(-bn // TN)) * (
            -(-m // bm) * -(-bm // (8 * rm)))
        unit = bk if mode == "replica" else TK
        floor = min(256, k)
    want = max(1, -(-2 * _SMS // tiles))

    def up(v: int) -> int:
        return -(-v // unit) * unit

    kc = max(up(-(-k // want)), up(floor))
    return -(-k // kc), kc


def abft_matmul_kernel(x, w, fault=(0, 0, 0, 0, 0, -1), delta: float = 0.0,
                       *, mode: str, bm: int, bk: int, bn: int, out_dtype):
    """x: (M, K) with unit column stride, w: (K, N) with any strides (the
    tied head passes ``embed.T``) -> (y, res, bnd) as ``abft_matmul_ref``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("abft_matmul_kernel takes CUDA tensors on one "
                         "device")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"operands must share f32 or bf16, got {x.dtype} "
                        f"and {w.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.stride(1) != 1 or min(w.stride()) < 0:
        raise ValueError("x needs a unit column stride, w non-negative "
                         "strides")
    m, k = x.shape
    n = w.shape[1]
    gm, gn = -(-m // bm), -(-n // bn)
    gemv = gemv_path(x, w, bn, mode)
    rm = 0 if gemv else rows_per_thread(bm)
    S, kc = split_k(m, k, n, bm, bk, bn, mode, gemv)
    gx = gn * -(-bn // TN)
    dev = x.device
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    rshape = (gm, gn) if mode == "2s" else (gm, gn, bm)
    res = torch.empty(rshape, dtype=F32, device=dev)
    bnd = torch.empty(rshape, dtype=F32, device=dev)
    part_acc = torch.empty((S, m, n), dtype=F32, device=dev)
    part_chk = torch.empty((S, m, gx), dtype=F32, device=dev)
    part_bnd = torch.empty((S, m, gx), dtype=F32, device=dev)
    bi, bj, r, c, enabled, bit = (int(v) for v in fault)
    P = library.ptr
    err = library.library("abft_matmul").abft_matmul_launch(
        P(x), P(w), P(y), P(res), P(bnd), P(part_acc), P(part_chk),
        P(part_bnd), m, k, n, x.stride(0), w.stride(0), w.stride(1),
        bm, bk, bn, S, kc, rm, MODES.index(mode), _DTYPES[x.dtype],
        _DTYPES[out_dtype], enabled, bi, bj, r, c, bit, float(delta),
        library.stream())
    library.check(err, KERNEL.name)
    KERNEL.launches += 1
    return y, res, bnd
