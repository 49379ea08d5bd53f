"""K1: fused block-ABFT matmul, the CUDA kernel ``csrc/abft_matmul.cu``.

Replaces the TPU kernel ``repro.kernels.abft_matmul.abft_matmul_kernel``.
``abft_matmul_kernel`` checks its operands, picks pass 1's route
(``route``: tensor cores for bf16, the GEMV for f32 decode, the SIMT
register-blocked GEMM for f32 above 8 rows, or CUDA-core tiles),
allocates the outputs and the scratch of its ``plan`` with
``torch.empty``, launches on the current stream and counts the launch in
``KERNEL.launches``.  Its plain version is
``kernels/ref.py::abft_matmul_ref``; the user-facing wrapper (block
clamping, fault translation, threshold and flag) is ``kernels/ops.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import library

F32 = torch.float32
MODES = ("1s", "2s", "replica")
KERNEL = library.Kernel("abft_matmul",
                        "src/repro_torch/kernels/csrc/abft_matmul.cu")

TN, TK = 64, 32          # CUDA-core tile columns and stage depth (.cu)
TC_TN, TC_TK = 128, 64   # tensor-core tile columns and stage depth
ST_K = 16                # SIMT stage depth
SIMT_TILE = (128, 128)   # SIMT tile rows and columns
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"tiled": 0, "gemv": 1, "tc": 2, "tc_kmajor": 3, "simt": 4}
_SMS = 132               # H100 SXM streaming multiprocessors


def rows_per_thread(bm: int) -> int:
    """CUDA-core tile height is 8 * rows_per_thread: 8 rows for
    decode-thin GEMMs, up to 64 rows for prefill."""
    return 1 if bm <= 8 else 4 if bm <= 32 else 8


def tc_rows(bm: int) -> int:
    """Tensor-core tile height: one consumer warpgroup (64 rows) for
    logical blocks of at most 64 rows, two (128 rows) above."""
    return 64 if bm <= 64 else 128


def _aligned(t: torch.Tensor, stride: int) -> bool:
    return (stride * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0


def gemv_path(x, w, bn: int, mode: str) -> bool:
    """The decode fast path of pass 1 (a GEMV over 16-byte rows of W)
    takes M <= 8 rows, the one-sided partials (modes 1s/2s), a row-major
    W whose rows are 16-byte aligned, N % 8 == 0 and bn % 64 == 0."""
    esz = w.element_size()
    return (x.shape[0] <= 8 and mode != "replica" and w.stride(1) == 1
            and w.shape[1] % 8 == 0 and bn % TN == 0
            and (w.stride(0) * esz) % 16 == 0 and w.data_ptr() % 16 == 0)


def _w_aligned(w) -> bool:
    """W row-major with 16-byte rows, or K-major (``embed.T``) with
    16-byte columns."""
    return ((w.stride(1) == 1 and _aligned(w, w.stride(0)))
            or (w.stride(0) == 1 and _aligned(w, w.stride(1))))


def simt_path(x, w, bn: int, mode: str, one_slice: bool = False) -> bool:
    """The SIMT pass 1 takes f32 operands, mode 1s or 2s, more than 8 rows
    (the GEMV keeps f32 decode) or any rows under ``one_slice``, rows of x
    16-byte aligned (unit column stride), W row-major or K-major with
    16-byte rows or columns, and bn % 4 == 0 (whole float4 column
    groups)."""
    return (x.dtype == torch.float32 and w.dtype == torch.float32
            and mode != "replica" and (x.shape[0] > 8 or one_slice)
            and bn % 4 == 0 and x.stride(1) == 1
            and _aligned(x, x.stride(0)) and _w_aligned(w))


def routes(x, w, bn: int, mode: str, one_slice: bool = False) -> tuple:
    """Every pass-1 route that can take these operands, the preferred
    one first.  ``one_slice`` (the serving prefill) leaves the GEMV out:
    its K split comes from (K, N) alone, so an f32 chunk of at most 8
    rows takes the one-slice SIMT pass 1 that whole prompts take and sums
    each row in their order:

    - ``tc`` / ``tc_kmajor``: the tensor-core pass 1 — bf16 operands,
      mode 1s or 2s, rows of x 16-byte aligned (unit column stride), and W
      either row-major (``tc``) or column-major (``tc_kmajor``: the tied
      head's ``embed.T``) with its rows, resp. columns, 16-byte aligned;
    - ``gemv``: ``gemv_path`` (decode, M <= 8, row-major W): f32 decode.
      bf16 decode prefers the tensor cores: on an H100 (700 W) they take
      the decode step's 112 row-major GEMMs at M=4 in 2.22 ms where the
      GEMV takes 3.36 (``chip_smoke.py``, ``k1_timing`` ``fork``);
    - ``simt``: ``simt_path`` (f32, M > 8, 1s/2s, aligned; W row-major or
      ``embed.T``): the register-blocked CUDA-core GEMM with the checksums
      from its shared-memory tiles (TF32 stays off);
    - ``tiled``: the CUDA-core pass 1, which takes anything — mode
      replica, and operands whose rows are not 16-byte aligned."""
    out = []
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and mode != "replica" and x.stride(1) == 1
            and _aligned(x, x.stride(0))):
        if w.stride(1) == 1 and _aligned(w, w.stride(0)):
            out.append("tc")
        elif w.stride(0) == 1 and _aligned(w, w.stride(1)):
            out.append("tc_kmajor")
    if not one_slice and gemv_path(x, w, bn, mode):
        out.append("gemv")
    if simt_path(x, w, bn, mode, one_slice):
        out.append("simt")
    return (*out, "tiled")


def route(x, w, bn: int, mode: str, one_slice: bool = False) -> str:
    """Which pass 1 runs, decided before the launch: the first of
    ``routes``."""
    return routes(x, w, bn, mode, one_slice)[0]


def tile(r: str, bm: int) -> tuple:
    """(rows, columns) of pass 1's CUDA-block tile on route ``r``: the
    geometry the scratch and the K split are sized by, passed to the
    launch, which rejects any other.  ``simt`` takes 128 x 128 inside a
    logical block; a smaller clamped block masks its rows and columns
    within that tile."""
    if r.startswith("tc"):
        return tc_rows(bm), TC_TN
    if r == "simt":
        return SIMT_TILE
    if r == "gemv":         # all M <= 8 rows in one tile
        return 8, TN
    return 8 * rows_per_thread(bm), TN


def split_k(m: int, k: int, n: int, bm: int, bk: int, bn: int,
            mode: str, gemv: bool = False, tc: bool = False,
            simt: bool = False, one_slice: bool = False) -> tuple:
    """(slices, depth) of the K split.  CUDA-core routes: enough CUDA
    blocks for two waves over the SMs; tiled slices at least 256 deep and
    — for the replica checksum, which flushes per logical k-block —
    aligned to ``bk``; GEMV slices a multiple of its 32 k-rows per
    iteration, at most 16 of them.  Tensor-core and SIMT routes: one
    slice (y and the row sums straight from the epilogue) unless the
    tiles fill under half the SMs; then ``SMs // tiles`` slices of whole
    stages (64 deep on the tensor cores, 16 on SIMT), at least 256
    deep.  ``one_slice`` (not the GEMV): a single slice of the whole
    depth at any M, so a row's f32 sum runs in one order whatever the
    height of the GEMM around it (tensor-core, SIMT and CUDA-core tiles
    accumulate each output in the same order whatever row they hold)."""
    if gemv:    # at most 16 slices: pass 2 sums them element by element
        tiles, unit, floor = -(-n // TN), 32, max(32, -(-k // 16))
        want = max(1, -(-2 * _SMS // tiles))
    else:
        tm, tn = tile("tc" if tc else "simt" if simt else "tiled", bm)
        tiles = -(-n // bn) * -(-bn // tn) * -(-m // bm) * -(-bm // tm)
        if tc or simt:
            unit, floor = (TC_TK if tc else ST_K), min(256, k)
            want = max(1, _SMS // tiles)
        else:
            unit, floor = (bk if mode == "replica" else TK), min(256, k)
            want = max(1, -(-2 * _SMS // tiles))

    def up(v: int) -> int:
        return -(-v // unit) * unit

    if one_slice and not gemv:
        return 1, up(k)
    kc = max(up(-(-k // want)), up(floor))
    return -(-k // kc), kc


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's pass-1 route, K split and scratch shapes."""

    route: str
    tile: tuple
    slices: int
    depth: int
    scratch: dict


def plan(x, w, *, mode: str, bm: int, bk: int, bn: int,
         force: str | None = None, one_slice: bool = False,
         split_rows: int | None = None) -> Plan:
    """The launch ``abft_matmul_kernel`` makes for these operands, on
    ``route``'s pass 1 or on ``force``, which must be one of ``routes``'s
    (to time one route against another).  Scratch: the per-slice partial
    accumulators (none on the single-slice tensor-core and SIMT routes,
    whose epilogue stores y), the per-(slice, row, column tile) partial
    checksums and bounds, and — tensor-core and SIMT routes only — the
    per-(row, column tile) partial row sums of the accumulator.
    ``one_slice``: ``split_k``'s.  ``split_rows``: the K split is the one
    a GEMM of that many rows takes on the same route (its clamped block
    and row tiles), whatever M — a speculative verify step's rows then
    sum in the decode step's order."""
    m, k = x.shape
    n = w.shape[1]
    can = routes(x, w, bn, mode, one_slice)
    if force is not None and force not in can:
        raise ValueError(f"route {force!r} cannot take these operands; "
                         f"these can: {can}")
    r = force or can[0]
    tc, simt = r.startswith("tc"), r == "simt"
    sm, sbm = m, bm
    if split_rows is not None:     # ops' block clamp at split_rows <= m
        sm = int(split_rows)
        sbm = min(bm, -(-sm // 8) * 8)
    S, kc = split_k(sm, k, n, sbm, bk, bn, mode, gemv=r == "gemv", tc=tc,
                    simt=simt, one_slice=one_slice)
    tm, tn = tile(r, bm)
    gx = -(-n // bn) * -(-bn // tn)
    wide = tc or simt       # the epilogue stores y and the row sums
    scratch = {"part_acc": (0,) if wide and S == 1 else (S, m, n),
               "part_chk": (S, m, gx), "part_bnd": (S, m, gx),
               "part_rs": (m, gx) if wide else (0,)}
    return Plan(r, (tm, tn), S, kc, scratch)


def abft_matmul_kernel(x, w, fault=(0, 0, 0, 0, 0, -1), delta: float = 0.0,
                       *, mode: str, bm: int, bk: int, bn: int, out_dtype,
                       force: str | None = None, one_slice: bool = False,
                       split_rows: int | None = None):
    """x: (M, K) with unit column stride, w: (K, N) with any strides (the
    tied head passes ``embed.T``) -> (y, res, bnd) as ``abft_matmul_ref``.
    The pass-1 route is ``plan``'s (``route``'s unless ``force``d);
    ``one_slice`` runs it as one K slice at any M (``split_k``);
    ``split_rows`` pins the K split to that row count's (``plan``)."""
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
    p = plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn, force=force,
             one_slice=one_slice, split_rows=split_rows)
    dev = x.device
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    rshape = (gm, gn) if mode == "2s" else (gm, gn, bm)
    res = torch.empty(rshape, dtype=F32, device=dev)
    bnd = torch.empty(rshape, dtype=F32, device=dev)
    part = {name: torch.empty(shape, dtype=F32, device=dev)
            for name, shape in p.scratch.items()}
    bi, bj, r, c, enabled, bit = (int(v) for v in fault)
    P = library.ptr
    err = library.library("abft_matmul").abft_matmul_launch(
        P(x), P(w), P(y), P(res), P(bnd), P(part["part_acc"]),
        P(part["part_chk"]), P(part["part_bnd"]), P(part["part_rs"]),
        m, k, n, x.stride(0), w.stride(0), w.stride(1), bm, bk, bn,
        p.slices, p.depth, _ROUTES[p.route], *p.tile,
        MODES.index(mode), _DTYPES[x.dtype], _DTYPES[out_dtype], enabled,
        bi, bj, r, c, bit, float(delta), library.stream())
    library.check(err, KERNEL.name)
    KERNEL.launches += 1
    return y, res, bnd
