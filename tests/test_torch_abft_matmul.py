"""K1 (fused ABFT matmul): the port's plain version, through its wrapper
``repro_torch.kernels.ops.abft_matmul``, against the reference wrapper
``repro.kernels.ops.abft_matmul`` running the Pallas kernel in interpret
mode.  Same numpy inputs (seeded) on both sides, f32.

Tolerances: y within 5e-4 (the k-chunked f32 sums run in another order,
as ``tests/test_kernels.py`` allows against its oracle); bounds within
1e-5 relative (sums of magnitudes, order only); thresholds likewise;
clean residuals are rounding noise, so they are compared against the
threshold (never above it on either side) rather than element-wise.

Mirrored caveat: the threshold is the reference kernel path's
``ATOL + tolerance_scale(K_padded) * bnd``, without the quantization terms
of the reference's ``use_pallas=False`` emulation
(``repro/core/protected.py`` vs ``repro/kernels/ops.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import FaultSpec as JFault
from repro.core.schemes import BlockShape as JBlocks
from repro.kernels import ops as jops
from repro_torch.core.faults import FaultSpec
from repro_torch.core.schemes import BlockShape
from repro_torch.kernels import ops
from repro_torch.kernels.abft_matmul import (
    abft_matmul_kernel,
    gemv_path,
    plan,
    route,
    routes,
    simt_path,
    split_k,
    tile,
)
from repro_torch.kernels.ref import abft_matmul_ref

torch.set_num_threads(1)

SHAPES = [(4, 64, 128), (1, 96, 40), (96, 200, 130), (130, 514, 258)]
MODES = ["1s", "2s", "replica"]
BLOCKS = (64, 64, 64)


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _both(x, w, mode, jf=None, tf=None, blocks=BLOCKS):
    yj, cj = jops.abft_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode,
                              blocks=JBlocks(*blocks), fault=jf,
                              out_dtype=jnp.float32)
    yt, ct = ops.abft_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             mode=mode, blocks=BlockShape(*blocks),
                             fault=tf, out_dtype=torch.float32)
    return (np.asarray(yj), cj), (yt.numpy(), ct)


def _ratio_argmax(chk, to_np):
    r = to_np(chk.residual) / to_np(chk.threshold)
    return np.unravel_index(int(np.nanargmax(r)), r.shape)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_reference_kernel(shape, mode):
    x, w = _inputs(1, *shape)
    (yj, cj), (yt, ct) = _both(x, w, mode)
    np.testing.assert_allclose(yt, yj, rtol=5e-4, atol=5e-4)
    assert ct.residual.shape == cj.residual.shape
    np.testing.assert_allclose(ct.threshold.numpy(),
                               np.asarray(cj.threshold), rtol=1e-5)
    assert not bool(cj.flag) and not bool(ct.flag)
    assert (ct.residual.numpy() <= ct.threshold.numpy()).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["value", "bitflip"])
@pytest.mark.parametrize("shape", [(4, 64, 128), (96, 200, 130)])
def test_faults_flag_at_the_same_block_and_row(shape, kind, mode):
    m, k, n = shape
    x, w = _inputs(2, m, k, n)
    row, col = m - 1, n // 2 + 3
    if kind == "value":
        jf, tf = JFault.value(row, col, 1e3), FaultSpec.value(row, col, 1e3)
    else:
        jf, tf = (JFault.bitflip(row, col, 30),
                  FaultSpec.bitflip(row, col, 30))
    (yj, cj), (yt, ct) = _both(x, w, mode, jf, tf)
    assert bool(cj.flag) and bool(ct.flag)
    at_j = _ratio_argmax(cj, np.asarray)
    at_t = _ratio_argmax(ct, lambda t: t.numpy())
    assert at_j == at_t
    bm = min(64, -(-m // 8) * 8)
    bn = min(64, -(-n // 8) * 8)
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    assert tuple(int(a) for a in at_t) == want
    # the faulted output element itself is corrupted identically
    np.testing.assert_allclose(yt[row, col], yj[row, col], rtol=1e-5)


def test_default_blocks_clamp_for_thin_gemms():
    x, w = _inputs(3, 4, 2048, 512)
    yt, ct = ops.abft_matmul(torch.from_numpy(x), torch.from_numpy(w))
    yj, cj = jops.abft_matmul(jnp.asarray(x), jnp.asarray(w))
    assert ct.residual.shape == cj.residual.shape == (1, 2, 8)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=5e-4,
                               atol=5e-4)


def test_strided_head_view_matches_contiguous():
    """The tied head reads ``embed.T`` through its strides."""
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((136, 64)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    a = abft_matmul_ref(x, emb.t(), mode="1s", bm=8, bk=64, bn=136,
                        out_dtype=torch.float32)
    b = abft_matmul_ref(x, emb.t().contiguous(), mode="1s", bm=8, bk=64,
                        bn=136, out_dtype=torch.float32)
    for u, v in zip(a, b):     # same values; einsum may reorder sums
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_never_falls_back_for_cpu_tensors():
    x, w = _inputs(5, 4, 64, 64)
    with pytest.raises(ValueError):
        abft_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w),
                           mode="1s", bm=8, bk=64, bn=64,
                           out_dtype=torch.float32)


def test_split_k_covers_k_and_aligns_replica():
    for m, k, n in [(4, 2048, 2048), (4, 8192, 2048), (512, 2048, 128256),
                    (4, 200, 512)]:
        for mode in MODES:
            bk = min(512, -(-k // 8) * 8)
            for gemv in (False, mode != "replica" and m <= 8):
                S, kc = split_k(m, k, n, min(256, -(-m // 8) * 8), bk,
                                min(256, -(-n // 8) * 8), mode, gemv)
                assert (S - 1) * kc < k <= S * kc
                if mode == "replica":
                    assert kc % bk == 0
                if gemv:     # whole 32-row iterations of the GEMV pass
                    assert kc % 32 == 0


def test_gemv_path_terms():
    x = torch.zeros(4, 64)
    w = torch.zeros(64, 128)
    assert gemv_path(x, w, 128, "1s") and gemv_path(x, w, 64, "2s")
    assert not gemv_path(x, w, 128, "replica")
    assert not gemv_path(torch.zeros(9, 64), w, 128, "1s")
    assert not gemv_path(x, torch.zeros(128, 64).t(), 128, "1s")
    assert not gemv_path(x, w, 40, "1s")


BF16 = torch.bfloat16


def _op(m, k, n, dtype=BF16, head=False):
    """Operands of the shapes only (values unused): W row-major, or the
    tied head's ``embed.T`` view."""
    x = torch.empty(m, k, dtype=dtype)
    w = torch.empty(n, k, dtype=dtype).t() if head else \
        torch.empty(k, n, dtype=dtype)
    return x, w


def _blocks(m, k, n):
    return dict(bm=min(256, -(-m // 8) * 8), bk=min(512, -(-k // 8) * 8),
                bn=min(256, -(-n // 8) * 8))


@pytest.mark.parametrize("case,want", [
    (dict(m=4, k=2048, n=512, mode="1s"), "tc"),             # decode
    (dict(m=4, k=2048, n=512, mode="2s", dtype=torch.float32), "gemv"),
    (dict(m=512, k=2048, n=2048, mode="1s"), "tc"),          # prefill
    (dict(m=2048, k=8192, n=2048, mode="2s"), "tc"),         # forward down
    (dict(m=16, k=2048, n=512, mode="1s"), "tc"),            # M > 8
    (dict(m=4, k=2048, n=1000, mode="1s", head=True), "tc_kmajor"),
    (dict(m=512, k=2048, n=1000, mode="1s", head=True), "tc_kmajor"),
    (dict(m=512, k=2048, n=2048, mode="1s", dtype=torch.float32), "simt"),
    (dict(m=512, k=2048, n=2048, mode="2s", dtype=torch.float32), "simt"),
    (dict(m=9, k=2048, n=512, mode="1s", dtype=torch.float32), "simt"),
    (dict(m=8, k=2048, n=512, mode="1s", dtype=torch.float32), "gemv"),
    (dict(m=512, k=2048, n=1000, mode="2s", dtype=torch.float32,
          head=True), "simt"),                               # f32 tied head
    (dict(m=4, k=2048, n=1000, mode="1s", dtype=torch.float32,
          head=True), "tiled"),                              # M <= 8, K-major
    (dict(m=512, k=2048, n=2048, mode="replica", dtype=torch.float32),
     "tiled"),
    (dict(m=512, k=2048, n=2048, mode="replica"), "tiled"),
    (dict(m=4, k=2048, n=512, mode="replica"), "tiled"),
    (dict(m=130, k=514, n=258, mode="1s"), "tiled"),         # rows of 1028 B
])
def test_route_picks_pass_one_from_documented_terms(case, want):
    case = dict(case)
    mode, dtype = case.pop("mode"), case.pop("dtype", BF16)
    head = case.pop("head", False)
    x, w = _op(case["m"], case["k"], case["n"], dtype, head)
    assert route(x, w, _blocks(**case)["bn"], mode) == want


def test_route_sends_unaligned_bf16_rows_to_the_cuda_core_pass():
    x = torch.empty(40, 2049, dtype=BF16)[:, 1:]      # base 2 B off 16
    w = torch.empty(2048, 512, dtype=BF16)
    assert x.stride(1) == 1 and x.data_ptr() % 16 != 0
    assert route(x, w, 256, "1s") == "tiled"
    assert route(torch.empty(40, 2048, dtype=BF16), w, 256, "1s") == "tc"
    wu = torch.empty(2048, 513, dtype=BF16)[:, :512]   # rows of 1026 B
    assert route(torch.empty(40, 2048, dtype=BF16), wu, 256, "1s") == \
        "tiled"


@pytest.mark.parametrize("m,k,n,head,slices", [
    (2048, 2048, 2048, False, 1),    # q/o at the forward: 256 tiles
    (2048, 8192, 2048, False, 1),    # down
    (2048, 2048, 512, False, 2),     # k/v: 64 tiles fill half the SMs
    (512, 2048, 2048, False, 2),     # q/o at a 512-token prefill
    (512, 2048, 512, False, 8),      # k/v at 512: 16 tiles
    (512, 2048, 8192, False, 1),     # up/gate
    (512, 2048, 128256, True, 1),    # the tied head
    (4, 2048, 128256, True, 1),      # the tied head at decode
])
def test_tensor_core_split_and_scratch_shapes(m, k, n, head, slices):
    x, w = _op(m, k, n, head=head)
    b = _blocks(m, k, n)
    p = plan(x, w, mode="1s", **b)
    assert p.route == ("tc_kmajor" if head else "tc")
    assert p.slices == slices
    assert (p.slices - 1) * p.depth < k <= p.slices * p.depth
    assert p.depth % 64 == 0                 # whole 64-deep stages
    gx = -(-n // b["bn"]) * -(-b["bn"] // 128)
    assert p.scratch["part_chk"] == p.scratch["part_bnd"] == (slices, m, gx)
    assert p.scratch["part_rs"] == (m, gx)
    # one slice: the epilogue stores y; more: partial accumulators
    assert p.scratch["part_acc"] == ((0,) if slices == 1
                                     else (slices, m, n))


def test_cuda_core_routes_keep_their_scratch():
    x, w = _op(4, 2048, 512, dtype=torch.float32)
    p = plan(x, w, mode="1s", **_blocks(4, 2048, 512))
    assert p.route == "gemv" and p.scratch["part_rs"] == (0,)
    assert p.scratch["part_acc"] == (p.slices, 4, 512)
    assert p.scratch["part_chk"] == (p.slices, 4, 8)          # 64-col tiles
    x, w = _op(512, 2048, 2048, dtype=torch.float32)
    p = plan(x, w, mode="1s", **_blocks(512, 2048, 2048))
    assert p.route == "simt" and p.scratch["part_chk"][2] == 16
    p = plan(x, w, mode="replica", **_blocks(512, 2048, 2048))
    assert p.route == "tiled" and p.scratch["part_chk"][2] == 32
    assert p.scratch["part_rs"] == (0,)


@pytest.mark.parametrize("case,want", [
    (dict(m=4, k=2048, n=512), ("tc", "gemv", "tiled")),       # decode
    (dict(m=4, k=2048, n=512, dtype=torch.float32), ("gemv", "tiled")),
    (dict(m=4, k=2048, n=1000, head=True), ("tc_kmajor", "tiled")),
    (dict(m=512, k=2048, n=2048), ("tc", "tiled")),
    (dict(m=512, k=2048, n=2048, mode="replica"), ("tiled",)),
    (dict(m=512, k=2048, n=2048, dtype=torch.float32), ("simt", "tiled")),
    (dict(m=4, k=2048, n=512, mode="2s", dtype=torch.float32),
     ("gemv", "tiled")),
])
def test_routes_lists_every_route_that_can_take_the_operands(case, want):
    case = dict(case)
    mode, dtype = case.pop("mode", "1s"), case.pop("dtype", BF16)
    x, w = _op(case["m"], case["k"], case["n"], dtype, case.pop("head",
                                                                False))
    assert routes(x, w, _blocks(**case)["bn"], mode) == want


@pytest.mark.parametrize("r,bm,want", [
    ("tc", 8, (64, 128)), ("tc", 64, (64, 128)), ("tc", 256, (128, 128)),
    ("tc_kmajor", 40, (64, 128)), ("gemv", 8, (8, 64)),
    ("tiled", 8, (8, 64)), ("tiled", 32, (32, 64)), ("tiled", 256, (64, 64)),
    ("simt", 256, (128, 128)), ("simt", 64, (128, 128)),
    ("simt", 40, (128, 128)), ("simt", 72, (128, 128)),
])
def test_tile_is_the_geometry_the_launch_gets(r, bm, want):
    assert tile(r, bm) == want


@pytest.mark.parametrize("m,n", [(512, 2048), (512, 64), (40, 40),
                                 (64, 136)])
def test_simt_clamped_blocks_keep_the_one_tile(m, n):
    """A block clamped to a few rows or columns runs in the 128 x 128
    tile (masked), and the plan sizes its scratch by that tile."""
    x, w = _op(m, 256, n, dtype=F32)
    p = plan(x, w, mode="1s", **_blocks(m, 256, n))
    assert p.route == "simt" and p.tile == (128, 128)
    b = _blocks(m, 256, n)
    assert p.scratch["part_rs"] == (m, -(-n // b["bn"]) * -(-b["bn"] // 128))


def test_forced_route_sizes_its_own_scratch_and_split():
    x, w = _op(4, 2048, 2048)
    b = _blocks(4, 2048, 2048)
    p = plan(x, w, mode="1s", **b)
    assert p.route == "tc" and p.tile == (64, 128)
    assert p.slices == 8 and p.depth == 256       # 16 tiles of 132 SMs
    assert p.scratch["part_rs"] == (4, 16)
    assert p.scratch["part_acc"] == (8, 4, 2048)
    p = plan(x, w, mode="1s", **b, force="gemv")
    assert p.route == "gemv" and p.tile == (8, 64)
    assert p.scratch["part_rs"] == (0,) and p.scratch["part_chk"][2] == 32
    assert plan(x, w, mode="1s", **b, force="tiled").route == "tiled"


@pytest.mark.parametrize("force", ["tc", "tc_kmajor", "gemv", "bogus"])
def test_forced_route_that_cannot_take_the_operands_raises(force):
    x, w = _op(512, 2048, 2048, dtype=torch.float32)
    with pytest.raises(ValueError):
        plan(x, w, mode="1s", **_blocks(512, 2048, 2048), force=force)


F32 = torch.float32


def test_route_sends_unaligned_f32_rows_to_the_tiled_pass():
    """simt needs 16-byte rows of x and of W (or of embed.T's columns)."""
    w = torch.empty(2048, 512)
    x = torch.empty(40, 2049)[:, 1:]                  # base 4 B off 16
    assert route(x, w, 256, "1s") == "tiled"
    assert route(torch.empty(40, 2048), w, 256, "1s") == "simt"
    wu = torch.empty(2048, 513)[:, :512]              # rows of 2052 B
    assert route(torch.empty(40, 2048), wu, 256, "1s") == "tiled"
    xu = torch.empty(130, 514)                        # rows of 2056 B
    assert route(xu, torch.empty(514, 256), 256, "1s") == "tiled"
    assert not simt_path(torch.empty(40, 2048), w, 250, "1s")   # bn % 4


@pytest.mark.parametrize("m,k,n,head,slices,tm", [
    (512, 2048, 2048, False, 2, 128),    # q/o: 64 tiles fill under half
    (512, 2048, 512, False, 8, 128),     # k/v: 16 tiles
    (512, 2048, 8192, False, 1, 128),    # up/gate: 256 tiles
    (512, 8192, 2048, False, 2, 128),    # down
    (512, 2048, 128256, True, 1, 128),   # the tied head (embed.T)
    (2048, 2048, 2048, False, 1, 128),   # 256 tiles
    (40, 1024, 768, False, 4, 128),      # a clamped 40-row block
    (333, 2048, 1000, True, 4, 128),     # ragged rows, K-major W
])
def test_simt_split_and_scratch_shapes(m, k, n, head, slices, tm):
    x, w = _op(m, k, n, dtype=F32, head=head)
    b = _blocks(m, k, n)
    p = plan(x, w, mode="1s", **b)
    assert p.route == "simt" and p.tile == (tm, 128)
    assert p.slices == slices
    assert (p.slices - 1) * p.depth < k <= p.slices * p.depth
    assert p.depth % 16 == 0                 # whole 16-deep stages
    gx = -(-n // b["bn"]) * -(-b["bn"] // 128)
    assert p.scratch["part_chk"] == p.scratch["part_bnd"] == (slices, m, gx)
    assert p.scratch["part_rs"] == (m, gx)
    assert p.scratch["part_acc"] == ((0,) if slices == 1
                                     else (slices, m, n))


def test_simt_forced_on_bf16_or_replica_raises():
    x, w = _op(512, 2048, 2048)
    with pytest.raises(ValueError):
        plan(x, w, mode="1s", **_blocks(512, 2048, 2048), force="simt")
    x, w = _op(512, 2048, 2048, dtype=F32)
    with pytest.raises(ValueError):
        plan(x, w, mode="replica", **_blocks(512, 2048, 2048), force="simt")
    p = plan(x, w, mode="1s", **_blocks(512, 2048, 2048), force="tiled")
    assert p.route == "tiled" and p.tile == (64, 64)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("mode", ["1s", "2s"])
def test_one_slice_leaves_the_gemv_out_for_thin_f32_chunks(m, mode):
    """A prefill chunk of at most 8 f32 rows under ``one_slice`` takes the
    one-slice SIMT pass 1 that a whole prompt (M > 8) takes, not the GEMV
    (whose split comes from (K, N) alone): every row sums in the whole
    prompt's order.  Without ``one_slice`` (decode) the GEMV stays."""
    k, n = 2048, 512
    x, w = _op(m, k, n, dtype=torch.float32)
    b = _blocks(m, k, n)
    p = plan(x, w, mode=mode, **b, one_slice=True)
    assert p.route == "simt" and p.slices == 1 and p.depth >= k
    assert "gemv" not in routes(x, w, b["bn"], mode, one_slice=True)
    whole = plan(*_op(512, k, n, dtype=torch.float32), mode=mode,
                 **_blocks(512, k, n), one_slice=True)
    assert (whole.route, whole.slices, whole.depth) == \
        (p.route, p.slices, p.depth)
    assert plan(x, w, mode=mode, **b).route == "gemv"
    # bf16 keeps the tensor cores either way
    xb, wb = _op(m, k, n)
    assert plan(xb, wb, mode=mode, **b, one_slice=True).route == "tc"


@pytest.mark.parametrize("slots", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("k,n,head", [(2048, 2048, False),
                                      (2048, 512, False),
                                      (8192, 2048, False),
                                      (2048, 128256, True)])
def test_split_rows_pins_the_verify_split_to_decode(slots, dtype, k, n,
                                                    head):
    """``split_rows=slots``: a verify GEMM of slots x (K+1) rows, K = 1..8,
    gets the K split of the decode GEMM of ``slots`` rows on the same
    route, whatever its own row tiles (from 129 rows the unpinned split
    halves)."""
    xd, w = _op(slots, k, n, dtype=dtype, head=head)
    dec = plan(xd, w, mode="1s", **_blocks(slots, k, n))
    for K in range(1, 9):
        m = slots * (K + 1)
        x, w = _op(m, k, n, dtype=dtype, head=head)
        p = plan(x, w, mode="1s", **_blocks(m, k, n), split_rows=slots)
        if p.route != dec.route:
            # f32 at <= 8 slots: the GEMV (or the head's tiles) cannot take
            # the verify rows; ops runs those one step at a time
            assert dtype == torch.float32 and slots <= 8
            continue
        assert (p.slices, p.depth) == (dec.slices, dec.depth), (m, K)
        assert p.scratch["part_chk"][:2] == (p.slices, m)
    x, w = _op(16 * 9, 2048, 2048)
    assert plan(x, w, mode="1s", **_blocks(144, 2048, 2048)).slices == 4
    assert plan(x, w, mode="1s", **_blocks(144, 2048, 2048),
                split_rows=16).slices == 8
