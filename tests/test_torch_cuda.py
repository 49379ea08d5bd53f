"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without a card.  The file imports no JAX (the GPU machine has
none), so it runs there as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: y in f32 within 1e-4 x max|y| (f32 sums over K in another
order); y in bf16 within 2^-7 x max|y| (one bf16 rounding of either
side); bounds within 1e-5 relative (sums of magnitudes, order only);
decode and full-sequence attention within 1e-5 (f32) or 2^-7 (bf16) of
max|out|.  Clean residuals are rounding noise and are held against the
threshold only.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.protected import ABFTConfig
from repro_torch.core.schemes import BlockShape
from repro_torch.kernels import abft_matmul as am
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_ops, ops
from repro_torch.kernels.ref import abft_matmul_ref
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

MODES = ("1s", "2s", "replica")
DTYPES = (torch.float32, torch.bfloat16)
# (M, K, N): the decode GEMV pass (M <= 8), the tiled pass, ragged edges
K1_SHAPES = [(4, 2048, 512), (8, 512, 256), (40, 2048, 512),
             (130, 514, 258), (3, 200, 136)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _blocks(m, k, n, blocks=BlockShape()):
    return tuple(min(b, -(-d // 8) * 8)
                 for b, d in ((blocks.bm, m), (blocks.bk, k), (blocks.bn, n)))


def _k1_inputs(dev, m, k, n, dtype, seed, transposed=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    wshape = (n, k) if transposed else (k, n)
    w = torch.from_numpy(0.05 * rng.standard_normal(wshape).astype(
        np.float32))
    x, w = x.to(dev, dtype), w.to(dev, dtype)
    return x, (w.t() if transposed else w)


def _y_tol(y_ref, dtype):
    scale = y_ref.float().abs().max().item()
    return (1e-4 if dtype == torch.float32 else 2 ** -7) * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_kernel_matches_plain_version(dev, shape, mode, dtype):
    m, k, n = shape
    x, w = _k1_inputs(dev, m, k, n, dtype, seed=1)
    bm, bk, bn = _blocks(m, k, n)
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=dtype)
    before = am.KERNEL.launches
    y, res, bnd = am.abft_matmul_kernel(x, w, **kw)
    assert am.KERNEL.launches == before + 1
    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert res.shape == resp.shape and bnd.shape == bndp.shape
    err = (y.float() - yp.float()).abs().max().item()
    assert err <= _y_tol(yp, dtype)
    torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    _, chk = ops.abft_matmul(x, w, mode=mode, out_dtype=dtype)
    assert not bool(chk.flag)


@pytest.mark.parametrize("m", [4, 40])
def test_k1_reads_the_tied_head_through_its_strides(dev, m):
    """W = embed.T (a transposed view, never copied), f32 output."""
    x, w = _k1_inputs(dev, m, 256, 1000, torch.bfloat16, seed=2,
                      transposed=True)
    assert w.stride() == (1, 256)
    for mode in MODES:
        kw = dict(mode=mode, bm=_blocks(m, 256, 1000)[0], bk=256, bn=256,
                  out_dtype=torch.float32)
        y, _, bnd = am.abft_matmul_kernel(x, w, **kw)
        yp, _, bndp = abft_matmul_ref(x, w, **kw)
        torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", [4, 40])
def test_k1_flags_faults_at_their_block_and_row(dev, m, mode):
    x, w = _k1_inputs(dev, m, 1024, 768, torch.float32, seed=3)
    row, col = m - 1, 768 // 2 + 3
    bm, _, bn = _blocks(m, 1024, 768)
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    clean, _ = ops.abft_matmul(x, w, mode=mode)
    # an exponent flip that scales the element up by >= 2^32 (a flip that
    # shrinks it to ~0 can hide under a two-sided block threshold)
    bit = 30 if clean[row, col].abs().item() < 2 else 29
    for fault in (FaultSpec.value(row, col, 1e4),
                  FaultSpec.bitflip(row, col, bit)):
        y, chk = ops.abft_matmul(x, w, mode=mode, fault=fault)
        assert bool(chk.flag)
        ratio = (chk.residual / chk.threshold).nan_to_num(float("inf"))
        at = np.unravel_index(int(ratio.argmax().item()), ratio.shape)
        assert tuple(int(a) for a in at) == want
        diff = (y != clean).nonzero().tolist()
        assert diff == [[row, col]]       # only the faulted element


@pytest.mark.parametrize("m", [4, 40])
def test_k1_is_bit_for_bit_deterministic(dev, m):
    """No floating-point atomics: a retry reproduces its attempt exactly."""
    x, w = _k1_inputs(dev, m, 8192, 2048, torch.bfloat16, seed=4)
    runs = [ops.abft_matmul(x, w) for _ in range(3)]
    for y, chk in runs[1:]:
        assert torch.equal(y, runs[0][0])
        assert torch.equal(chk.residual, runs[0][1].residual)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w = _k1_inputs(dev, 4, 64, 64, torch.float32, seed=5)
    kw = dict(mode="1s", bm=8, bk=64, bn=64, out_dtype=torch.float32)
    with pytest.raises(TypeError):
        am.abft_matmul_kernel(x, w.to(torch.bfloat16), **kw)
    strided = torch.empty(4, 128, device=dev)[:, ::2]   # column stride 2
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(strided, w, **kw)
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(x.cpu(), w, **kw)


def _k3_case(dev, dtype, seed=0, B=4, KV=8, G=4, D=64, BS=16, S=256):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    W = S // BS
    NB = B * W + 5
    q = torch.randn(B, 1, KV * G, D, generator=gen)
    kp = 3 * torch.randn(NB, BS, KV, D, generator=gen)
    vp = 3 * torch.randn(NB, BS, KV, D, generator=gen)
    kd = 3 * torch.randn(B, S, KV, D, generator=gen)
    vd = 3 * torch.randn(B, S, KV, D, generator=gen)
    table = torch.randperm(NB, generator=gen)[:B * W].reshape(B, W)
    table = table.to(torch.int32)
    table[0, 1:] = NB                                # sentinel tail
    lengths = torch.tensor([1, 17, 100, 255], dtype=torch.int32)
    to = lambda t: t.to(dev, dtype)               # noqa: E731
    return (to(q), to(kp), to(vp), to(kd), to(vd), table.to(dev),
            lengths.to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_k3_kernel_matches_plain_version(dev, kind, dtype):
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, dtype)
    args = (kp, vp, table, 16) if kind == "paged" else (kd, vd, None, 128)
    before = fa.KERNEL.launches
    got = fa.flash_decode_kernel(q, *args[:3], lengths, block=args[3])
    assert fa.KERNEL.launches == before + 1
    ref = fa.flash_decode_ref(q, *args[:3], lengths, block=args[3])
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    scale = ref[0].float().abs().max().item()
    assert (got[0].float() - ref[0].float()).abs().max().item() <= \
        tol * scale
    for g, r in ((got[2], ref[2]), (got[4], ref[4])):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-30)
    if kind == "paged":
        _, chk = flash_ops.flash_decode_paged(q, kp, vp, table, lengths)
    else:
        _, chk = flash_ops.flash_decode(q, kd, vd, lengths)
    assert not bool(chk.flag)


def test_k3_ignores_data_past_each_length(dev):
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, torch.float32)
    a = fa.flash_decode_kernel(q, kd, vd, None, lengths, block=128)
    pos = torch.arange(kd.shape[1], device=dev)
    past = (pos[None, :] >= lengths[:, None])[:, :, None, None]
    kd2 = torch.where(past, torch.full_like(kd, 1e3), kd)
    vd2 = torch.where(past, torch.full_like(vd, -1e3), vd)
    b = fa.flash_decode_kernel(q, kd2, vd2, None, lengths, block=128)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_small_engine_streams_on_the_card_equal_the_cpu(dev):
    """Scaled-down f32 llama3.2-1b: the engine on the card (K1, K3) and on
    the CPU (their plain versions) give the same greedy streams, and the
    card run launched both kernels."""
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(3, dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 40, size=5)]
    streams = {}
    for d in ("cpu", dev):
        for kind in ("dense", "paged"):
            eng = ServeEngine(model, params, slots=2, max_len=64,
                              dtype=torch.float32, device=d,
                              cache_kind=kind,
                              abft=ABFTConfig(flash_attention=True))
            k1, k3 = am.KERNEL.launches, fa.KERNEL.launches
            streams[(str(d), kind)] = eng.run(
                [Request(uid=i, prompt=p, max_new_tokens=8)
                 for i, p in enumerate(prompts)])
            if str(d) != "cpu":
                assert am.KERNEL.launches > k1 and fa.KERNEL.launches > k3
    assert len({str(s) for s in streams.values()}) == 1


# ------------------------------------------------------------------ K2

K2_CASES = [(1, True), (7, True), (130, True), (333, True), (256, False)]


def _k2_case(dev, dtype, L, seed=0, B=2, H=8, KV=2, D=64):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, L, H, D, generator=gen)
    k = torch.randn(B, L, KV, D, generator=gen)
    v = 3 * torch.randn(B, L, KV, D, generator=gen)
    return tuple(t.to(dev, dtype) for t in (q, k, v))


def _k2_kw(L, causal, b=128):
    bq = min(b, -(-L // 8) * 8)
    return dict(bq=bq, bk=bq, causal=causal, lq_pad=-(-L // bq) * bq,
                lk_pad=-(-L // bq) * bq)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,causal", K2_CASES)
def test_k2_kernel_matches_plain_version(dev, L, causal, dtype):
    """o within 1e-5 (f32) or 2^-7 (bf16) of max|o|; both bounds within
    1e-5 relative; clean residuals are noise and raise no flag."""
    q, k, v = _k2_case(dev, dtype, L)
    kw = _k2_kw(L, causal)
    before = fa.FULL_KERNEL.launches
    got = fa.flash_attention_kernel(q, k, v, **kw)
    assert fa.FULL_KERNEL.launches == before + 1
    ref = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    scale = ref[0].float().abs().max().item()
    assert (got[0].float() - ref[0].float()).abs().max().item() <= \
        tol * scale
    for g, r in ((got[2], ref[2]), (got[4], ref[4])):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-30)
    _, chk = flash_ops.flash_attention(q, k, v, causal=causal)
    assert not bool(chk.flag)


def test_k2_reads_strided_qkv_in_place(dev):
    """q/k/v as views of one fused projection (non-contiguous strides)."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    B, L, H, KV, D = 2, 100, 8, 2, 64
    fused = torch.randn(B, L, (H + 2 * KV) * D, generator=gen).to(dev)
    q = fused[..., :H * D].view(B, L, H, D)
    k = fused[..., H * D:(H + KV) * D].view(B, L, KV, D)
    v = fused[..., (H + KV) * D:].view(B, L, KV, D)
    assert not q.is_contiguous()
    kw = _k2_kw(L, True)
    got = fa.flash_attention_kernel(q, k, v, **kw)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), **kw)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[4], ref[4], rtol=1e-5, atol=1e-30)


def test_k2_flags_a_fault_at_its_row_in_every_head(dev):
    from repro_torch.kernels.flash_attention import f32_bits

    q, k, v = _k2_case(dev, torch.float32, 300)
    row, col = 170, 9                     # q block 1 of 3
    _, chk = flash_ops.flash_attention(
        q, k, v, causal=True, fault=FaultSpec.value(row, col, 1e4))
    assert bool(chk.flag)
    fi = (row // 128, 0, row % 128, col, 1, f32_bits(1e4))
    out, _, _, rp, _ = fa.flash_attention_kernel(q, k, v, fi,
                                                 **_k2_kw(300, True))
    at = rp.reshape(rp.shape[0], rp.shape[1], -1).argmax(-1)
    assert bool((at == row).all())
    clean = fa.flash_attention_kernel(q, k, v, **_k2_kw(300, True))[0]
    diff = (out != clean).nonzero()
    assert bool((diff[:, 1] == row).all()) and bool((diff[:, 3] == col).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_is_bit_for_bit_deterministic(dev, dtype):
    q, k, v = _k2_case(dev, dtype, 1024, seed=4)
    kw = _k2_kw(1024, True)
    runs = [fa.flash_attention_kernel(q, k, v, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


def test_k2_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v = _k2_case(dev, torch.float32, 64)
    kw = _k2_kw(64, True)
    with pytest.raises(TypeError):
        fa.flash_attention_kernel(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError):
        fa.flash_attention_kernel(q.cpu(), k, v, **kw)
    with pytest.raises(ValueError):               # head dim over 128
        big = torch.zeros(2, 64, 8, 192, device=dev)
        fa.flash_attention_kernel(big, big[:, :, :2], big[:, :, :2], **kw)
    with pytest.raises(ValueError):               # column stride 2
        s = torch.zeros(2, 64, 8, 128, device=dev)[..., ::2]
        fa.flash_attention_kernel(s, k, v, **kw)
    with pytest.raises(ValueError):               # non-causal padding
        flash_ops.flash_attention(q[:, :60], k[:, :60], v[:, :60],
                                  causal=False)
    q.requires_grad_()
    with pytest.raises(NotImplementedError):
        flash_ops.flash_attention(q, k, v)


def test_small_train_step_on_the_card_equals_the_cpu(dev):
    """Scaled-down f32 llama3.2-1b, one AdamW step from the same params
    and batch on the card (K1) and on the CPU (its plain version): loss
    within 1e-5 relative and params within 1e-5 absolute (lr / 30: the
    gradients agree to f32 rounding, and AdamW's normalization turns
    that into up to ~1% of lr where |g| is near eps)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.serve.executor import tree_to
    from repro_torch.train import OptConfig, TrainConfig, init_opt_state
    from repro_torch.train import make_train_step

    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(5, dtype=torch.float32)
    batch = SyntheticLM(DataConfig(global_batch=2, seq_len=64,
                                   vocab_size=cfg.vocab_size)).batch(0)
    out = {}
    for d in ("cpu", dev):
        p = tree_to(params, d)
        step = make_train_step(model, ABFTConfig(), TrainConfig(
            opt=OptConfig()), device=d)
        k1 = am.KERNEL.launches
        newp, _, met = step(p, init_opt_state(p, OptConfig()),
                            {k: torch.from_numpy(v).to(d)
                             for k, v in batch.items()})
        if str(d) != "cpu":
            assert am.KERNEL.launches > k1
        assert not bool(met["abft_flag"])
        out[str(d)] = (float(met["loss"]),
                       [t.cpu() for t in tree_leaves(newp)])
    (lc, pc), (lg, pg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(pg, pc):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# ------------------------------------------- tensor-core routes (K1, K2)

BF16 = torch.bfloat16
# (M, K, N, W layout): one slice (the epilogue stores y) and split K
K1_TC_CASES = [(16, 2048, 512, "row"), (40, 2048, 512, "row"),
               (333, 2048, 512, "row"), (512, 2048, 2048, "row"),
               (2048, 512, 2048, "row"), (40, 256, 1000, "kmajor"),
               (333, 512, 1000, "kmajor"), (512, 2048, 4096, "kmajor"),
               (2048, 512, 1000, "kmajor")]


def _tc_case(dev, m, k, n, layout, seed):
    x, w = _k1_inputs(dev, m, k, n, BF16, seed=seed,
                      transposed=layout == "kmajor")
    out = torch.float32 if layout == "kmajor" else BF16   # the tied head
    return x, w, out


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("case", K1_TC_CASES)
def test_k1_tensor_core_route_matches_plain_version(dev, case, mode):
    """y within 2^-7 (bf16) or 1e-4 (f32) of max|y|, bounds within 1e-5
    relative, the reference's residual shapes, no clean flag."""
    m, k, n, layout = case
    x, w, out = _tc_case(dev, m, k, n, layout, seed=6)
    bm, bk, bn = _blocks(m, k, n)
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=out)
    plan = am.plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn)
    assert plan.route == ("tc_kmajor" if layout == "kmajor" else "tc")
    y, res, bnd = am.abft_matmul_kernel(x, w, **kw)
    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert res.shape == resp.shape and bnd.shape == bndp.shape
    err = (y.float() - yp.float()).abs().max().item()
    assert err <= _y_tol(yp, out)
    torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    _, chk = ops.abft_matmul(x, w, mode=mode, out_dtype=out)
    assert not bool(chk.flag)
    assert (chk.residual / chk.threshold).max().item() < 1


def test_k1_tensor_core_route_splits_k_only_for_few_tiles(dev):
    x, w, _ = _tc_case(dev, 512, 2048, 2048, "row", seed=7)
    assert am.plan(x, w, mode="1s", **dict(zip(
        ("bm", "bk", "bn"), _blocks(512, 2048, 2048)))).slices == 2
    x, w, _ = _tc_case(dev, 2048, 512, 2048, "row", seed=7)
    assert am.plan(x, w, mode="1s", **dict(zip(
        ("bm", "bk", "bn"), _blocks(2048, 512, 2048)))).slices == 1


@pytest.mark.parametrize("m", [512, 2048])
def test_k1_tensor_core_route_raises_no_flag_on_down(dev, m):
    """The deepest GEMM (mlp down, K = 8192): tensor-core f32 accumulation
    stays under the reference's threshold."""
    x, w = _k1_inputs(dev, m, 8192, 2048, BF16, seed=8)
    for mode in ("1s", "2s"):
        _, chk = ops.abft_matmul(x, w, mode=mode)
        assert not bool(chk.flag)
        assert (chk.residual / chk.threshold).max().item() < 1


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("case", [(333, 2048, 512, "row"),
                                  (512, 2048, 2048, "row"),
                                  (40, 256, 1000, "kmajor")])
def test_k1_tensor_core_route_flags_faults_at_their_block_and_row(
        dev, case, mode):
    m, k, n, layout = case
    x, w, out = _tc_case(dev, m, k, n, layout, seed=9)
    row, col = m - 1, n // 2 + 3
    bm, _, bn = _blocks(m, k, n)
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    clean, _ = ops.abft_matmul(x, w, mode=mode, out_dtype=out)
    bit = 30 if clean[row, col].float().abs().item() < 2 else 29
    for fault in (FaultSpec.value(row, col, 1e4),
                  FaultSpec.bitflip(row, col, bit)):
        y, chk = ops.abft_matmul(x, w, mode=mode, out_dtype=out,
                                 fault=fault)
        assert bool(chk.flag)
        ratio = (chk.residual / chk.threshold).nan_to_num(float("inf"))
        at = np.unravel_index(int(ratio.argmax().item()), ratio.shape)
        assert tuple(int(a) for a in at) == want
        diff = (y != clean).nonzero().tolist()
        assert diff == [[row, col]]       # only the faulted element


@pytest.mark.parametrize("mode", ["1s", "2s"])
def test_k1_tensor_core_route_fault_in_the_zero_padding(dev, mode):
    """A fault on a row past M (the logical block's zero padding) enters
    the residual there, as in the plain version."""
    x, w, out = _tc_case(dev, 333, 512, 512, "row", seed=10)
    bm, bk, bn = _blocks(333, 512, 512)
    fault = (1, 1, 400 - 256, 7, 1, -1)          # row 400 of 512 padded
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=out)
    _, res, _ = am.abft_matmul_kernel(x, w, fault, 1e4, **kw)
    _, resp, _ = abft_matmul_ref(x, w, fault, 1e4, **kw)
    assert res.argmax().item() == resp.argmax().item()
    torch.testing.assert_close(res.max(), resp.max(), rtol=1e-4, atol=0)


@pytest.mark.parametrize("case", [(512, 2048, 2048, "row"),
                                  (2048, 512, 2048, "row"),
                                  (333, 512, 1000, "kmajor")])
def test_k1_tensor_core_route_is_bit_for_bit_deterministic(dev, case):
    x, w, out = _tc_case(dev, *case, seed=11)
    bm, bk, bn = _blocks(*case[:3])
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out)
    runs = [am.abft_matmul_kernel(x, w, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("n", [512, 2048, 8192])
def test_k1_tensor_core_route_at_decode_matches_plain_version(dev, n, mode):
    """bf16 decode (M=4, row-major W) takes the tensor-core pass 1; the
    GEMV pass 1, forced on the same operands as chip_smoke.py times it,
    agrees with the plain version too."""
    x, w = _k1_inputs(dev, 4, 2048, n, BF16, seed=17)
    bm, bk, bn = _blocks(4, 2048, n)
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=BF16)
    assert am.plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn).route == "tc"
    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
    for force in (None, "gemv"):
        y, res, bnd = am.abft_matmul_kernel(x, w, **kw, force=force)
        assert res.shape == resp.shape
        assert (y.float() - yp.float()).abs().max().item() <= \
            _y_tol(yp, BF16)
        torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    _, chk = ops.abft_matmul(x, w, mode=mode)
    assert not bool(chk.flag)


def test_k1_launch_rejects_a_tile_its_scratch_was_not_sized_for(
        dev, monkeypatch):
    x, w = _k1_inputs(dev, 40, 512, 512, BF16, seed=18)
    bm, bk, bn = _blocks(40, 512, 512)
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=BF16)
    for r, bad in (("tc", (32, am.TC_TN)), ("tiled", (64, am.TC_TN))):
        with monkeypatch.context() as mp:
            mp.setattr(am, "tile", lambda r_, bm_, bad=bad: bad)
            with pytest.raises(RuntimeError):
                am.abft_matmul_kernel(x, w, **kw, force=r)
    am.abft_matmul_kernel(x, w, **kw)          # the right tile launches


K2_TC_CASES = [(1, True), (7, True), (128, True), (333, True),
               (1024, True), (256, False)]


@pytest.mark.parametrize("L,causal", K2_TC_CASES)
def test_k2_tensor_core_kernel_matches_plain_version(dev, L, causal):
    """bf16 on the tensor-core kernel: o element by element within
    2^-7 |o_ref| + 1e-5 max|o| (one bf16 rounding of either side), both
    bounds within 1e-5 relative, clean residuals under the thresholds."""
    from repro_torch.core.checksums import ATOL, tolerance_scale

    q, k, v = _k2_case(dev, BF16, L, seed=12)
    kw = _k2_kw(L, causal)
    assert fa.tc_path(q, k, v, kw["bk"])
    got = fa.flash_attention_kernel(q, k, v, **kw)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    o = ref[0].float()
    tol = 2 ** -7 * o.abs() + 1e-5 * o.abs().max()
    assert bool(((got[0].float() - o).abs() <= tol).all())
    for g, r in ((got[2], ref[2]), (got[4], ref[4])):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-30)
    D = q.shape[-1]
    assert bool((got[1] <= ATOL + tolerance_scale(D) * got[2]).all())
    assert bool((got[3] <= ATOL + tolerance_scale(L) * got[4]).all())


def test_k2_tensor_core_kernel_reads_strided_qkv_in_place(dev):
    gen = torch.Generator(device="cpu").manual_seed(13)
    B, L, H, KV, D = 2, 100, 8, 2, 64
    fused = torch.randn(B, L, (H + 2 * KV) * D, generator=gen).to(dev, BF16)
    q = fused[..., :H * D].view(B, L, H, D)
    k = fused[..., H * D:(H + KV) * D].view(B, L, KV, D)
    v = fused[..., (H + KV) * D:].view(B, L, KV, D)
    kw = _k2_kw(L, True)
    assert not q.is_contiguous() and fa.tc_path(q, k, v, kw["bk"])
    got = fa.flash_attention_kernel(q, k, v, **kw)
    ref = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                 v.contiguous(), **kw)
    o = ref[0].float()
    assert (got[0].float() - o).abs().max().item() <= \
        2 ** -7 * o.abs().max().item()
    torch.testing.assert_close(got[4], ref[4], rtol=1e-5, atol=1e-30)


def test_k2_unaligned_bf16_takes_the_cuda_core_kernel(dev):
    q, k, v = _k2_case(dev, BF16, 64, seed=14)
    flat = torch.empty(q.numel() + 1, dtype=BF16, device=dev)
    qs = flat[1:].view(q.shape)                   # base 2 B off 16
    qs.copy_(q)
    kw = _k2_kw(64, True)
    assert not fa.tc_path(qs, k, v, kw["bk"])
    got = fa.flash_attention_kernel(qs, k, v, **kw)
    ref = fa.flash_attention_ref(q, k, v, **kw)
    assert (got[0].float() - ref[0].float()).abs().max().item() <= \
        2 ** -7 * ref[0].float().abs().max().item()


def test_k2_tensor_core_kernel_flags_a_fault_at_its_row_in_every_head(dev):
    from repro_torch.kernels.flash_attention import f32_bits

    q, k, v = _k2_case(dev, BF16, 300, seed=15)
    kw = _k2_kw(300, True)
    assert fa.tc_path(q, k, v, kw["bk"])
    row, col = 170, 9                     # q block 1 of 3
    _, chk = flash_ops.flash_attention(
        q, k, v, causal=True, fault=FaultSpec.value(row, col, 1e4))
    assert bool(chk.flag)
    fi = (row // 128, 0, row % 128, col, 1, f32_bits(1e4))
    out, _, _, rp, _ = fa.flash_attention_kernel(q, k, v, fi, **kw)
    at = rp.reshape(rp.shape[0], rp.shape[1], -1).argmax(-1)
    assert bool((at == row).all())
    rref = fa.flash_attention_ref(q, k, v, fi, **kw)[3]
    torch.testing.assert_close(rp[:, :, 1, row % 128],
                               rref[:, :, 1, row % 128], rtol=1e-4, atol=0)
    clean = fa.flash_attention_kernel(q, k, v, **kw)[0]
    diff = (out != clean).nonzero()
    assert bool((diff[:, 1] == row).all()) and bool((diff[:, 3] == col).all())


def test_k2_tensor_core_kernel_is_bit_for_bit_deterministic(dev):
    q, k, v = _k2_case(dev, BF16, 1024, seed=16, H=32, KV=8)
    kw = _k2_kw(1024, True)
    assert fa.tc_path(q, k, v, kw["bk"])
    runs = [fa.flash_attention_kernel(q, k, v, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


# ------------------------------------------- SIMT route (K1 f32) and split K3

F32 = torch.float32
# (M, K, N, W layout): the f32 train step's six GEMM shapes at 4 x 128
# tokens (q/o, k/v, up/gate, down, the tied head) and ragged edges
K1_SIMT_CASES = [(512, 2048, 2048, "row"), (512, 2048, 512, "row"),
                 (512, 2048, 8192, "row"), (512, 8192, 2048, "row"),
                 (512, 2048, 128256, "kmajor"), (40, 1024, 768, "row"),
                 (333, 2048, 512, "row"), (333, 512, 1000, "kmajor"),
                 (2048, 512, 1000, "kmajor")]


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("case", K1_SIMT_CASES)
def test_k1_simt_route_matches_plain_version(dev, case, mode):
    """f32 on the SIMT pass 1: y within 1e-4 x max|y| (f32 sums over K in
    another order), bounds within 1e-5 relative, the reference's residual
    shapes, no clean flag."""
    m, k, n, layout = case
    x, w = _k1_inputs(dev, m, k, n, F32, seed=21,
                      transposed=layout == "kmajor")
    bm, bk, bn = _blocks(m, k, n)
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=F32)
    assert am.plan(x, w, mode=mode, bm=bm, bk=bk, bn=bn).route == "simt"
    y, res, bnd = am.abft_matmul_kernel(x, w, **kw)
    yp, resp, bndp = abft_matmul_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert res.shape == resp.shape and bnd.shape == bndp.shape
    assert (y - yp).abs().max().item() <= _y_tol(yp, F32)
    torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    _, chk = ops.abft_matmul(x, w, mode=mode, out_dtype=F32)
    assert not bool(chk.flag)
    assert (chk.residual / chk.threshold).max().item() < 1


@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("case", [(333, 2048, 512, "row"),
                                  (512, 2048, 2048, "row"),
                                  (512, 2048, 8192, "row"),
                                  (333, 512, 1000, "kmajor")])
def test_k1_simt_route_flags_faults_at_their_block_and_row(dev, case, mode):
    """One K slice (the epilogue applies the fault) and split K (the slice
    reduce applies it): flagged at the fault's block and row, and only the
    faulted element of y changes."""
    m, k, n, layout = case
    x, w = _k1_inputs(dev, m, k, n, F32, seed=22,
                      transposed=layout == "kmajor")
    row, col = m - 1, n // 2 + 3
    bm, _, bn = _blocks(m, k, n)
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    clean, _ = ops.abft_matmul(x, w, mode=mode)
    bit = 30 if clean[row, col].abs().item() < 2 else 29
    for fault in (FaultSpec.value(row, col, 1e4),
                  FaultSpec.bitflip(row, col, bit)):
        y, chk = ops.abft_matmul(x, w, mode=mode, fault=fault)
        assert bool(chk.flag)
        ratio = (chk.residual / chk.threshold).nan_to_num(float("inf"))
        at = np.unravel_index(int(ratio.argmax().item()), ratio.shape)
        assert tuple(int(a) for a in at) == want
        diff = (y != clean).nonzero().tolist()
        assert diff == [[row, col]]


@pytest.mark.parametrize("case", [(512, 2048, 2048, "row"),
                                  (512, 2048, 8192, "row"),
                                  (333, 512, 1000, "kmajor")])
def test_k1_simt_route_is_bit_for_bit_deterministic(dev, case):
    m, k, n, layout = case
    x, w = _k1_inputs(dev, m, k, n, F32, seed=23,
                      transposed=layout == "kmajor")
    bm, bk, bn = _blocks(m, k, n)
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=F32)
    runs = [am.abft_matmul_kernel(x, w, **kw) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


def test_k1_simt_launch_rejects_a_tile_its_scratch_was_not_sized_for(
        dev, monkeypatch):
    x, w = _k1_inputs(dev, 40, 512, 512, F32, seed=24)
    bm, bk, bn = _blocks(40, 512, 512)
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=F32)
    for bad in ((32, 128), (64, 96), (64, 128), (256, 128)):
        with monkeypatch.context() as mp:
            mp.setattr(am, "tile", lambda r_, bm_, bad=bad: bad)
            with pytest.raises(RuntimeError):
                am.abft_matmul_kernel(x, w, **kw, force="simt")
    am.abft_matmul_kernel(x, w, **kw, force="simt")   # the right tile


def test_k1_simt_and_tiled_agree_on_the_same_operands(dev):
    """The fork chip_smoke.py times: the SIMT and the tiled pass 1 on one
    GEMM give y within 1e-4 x max|y| and the same residual shape."""
    x, w = _k1_inputs(dev, 512, 2048, 2048, F32, seed=25)
    bm, bk, bn = _blocks(512, 2048, 2048)
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=F32)
    a = am.abft_matmul_kernel(x, w, **kw, force="simt")
    b = am.abft_matmul_kernel(x, w, **kw, force="tiled")
    assert a[1].shape == b[1].shape
    assert (a[0] - b[0]).abs().max().item() <= _y_tol(b[0], F32)
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_k3_every_split_count_matches_plain_version(dev, kind, dtype):
    """Every forced split count 1..W against the plain split walk and the
    sequential walk: outputs within 1e-5 (f32) or 2^-7 (bf16) x max|o|,
    bounds within 1e-4 relative, no clean flag; garbage past each length
    (a permuted table with a sentinel tail) changes nothing."""
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, dtype)
    args = (kp, vp, table, 16) if kind == "paged" else (kd, vd, None, 32)
    T = args[3]
    W = table.shape[1] if kind == "paged" else -(-kd.shape[1] // T)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    seq = fa.flash_decode_ref(q, *args[:3], lengths, block=T)
    for splits in range(1, W + 1):
        got = fa.flash_decode_kernel(q, *args[:3], lengths, block=T,
                                     splits=splits)
        ref = fa.flash_decode_split_ref(q, *args[:3], lengths, block=T,
                                        splits=splits)
        torch.cuda.synchronize()
        for r in (ref, seq):
            scale = r[0].float().abs().max().item()
            assert (got[0].float() - r[0].float()).abs().max().item() <= \
                tol * scale, splits
            for g, rr in ((got[2], r[2]), (got[4], r[4])):
                torch.testing.assert_close(g, rr, rtol=1e-4, atol=1e-30)
        from repro_torch.core.checksums import ATOL, tolerance_scale
        D = q.shape[-1]
        assert bool((got[1] <= ATOL + tolerance_scale(D) * got[2]).all())
        assert bool((got[3] <= ATOL + tolerance_scale(W * T) * got[4]).all())


def test_k3_split_ignores_data_past_each_length(dev):
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, torch.bfloat16)
    pos = torch.arange(kd.shape[1], device=dev)
    past = (pos[None, :] >= lengths[:, None])[:, :, None, None]
    kd2 = torch.where(past, torch.full_like(kd, 1e3), kd)
    vd2 = torch.where(past, torch.full_like(vd, -1e3), vd)
    for splits in (1, 2, 5, 8):
        a = fa.flash_decode_kernel(q, kd, vd, None, lengths, block=32,
                                   splits=splits)
        b = fa.flash_decode_kernel(q, kd2, vd2, None, lengths, block=32,
                                   splits=splits)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_k3_split_is_bit_for_bit_deterministic(dev, kind):
    """The merge runs in split order whichever CTA is elected: repeats
    (the decode_splits default, and a forced count) are bit-identical."""
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, torch.bfloat16)
    args = (kp, vp, table, 16) if kind == "paged" else (kd, vd, None, 128)
    for splits in (None, 2):
        runs = [fa.flash_decode_kernel(q, *args[:3], lengths, block=args[3],
                                       splits=splits) for _ in range(4)]
        for r in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


def test_k3_rejects_a_split_count_the_table_cannot_take(dev):
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, F32)
    for bad in (0, table.shape[1] + 1):
        with pytest.raises(ValueError):
            fa.flash_decode_kernel(q, kp, vp, table, lengths, block=16,
                                   splits=bad)
    for d in (6, 160):          # rows of 24 and 640 bytes (f32)
        with pytest.raises(ValueError):
            qd = torch.zeros(*q.shape[:3], d, dtype=F32, device=dev)
            kv = torch.zeros(*kd.shape[:3], d, dtype=F32, device=dev)
            fa.flash_decode_kernel(qd, kv, kv, None, lengths, block=128)


# (G, d, dtype): G = 3 and 6 round up to an instantiated head group, 16
# takes two CTAs a kv head; d = 80 and 96 (bf16) pad 10 and 12 units to
# 16, d = 80 (f32) 20 to 32
K3_SHAPES = [(3, 64, BF16), (6, 96, BF16), (16, 64, BF16), (4, 80, BF16),
             (3, 80, F32), (2, 128, F32)]


@pytest.mark.parametrize("G,D,dtype", K3_SHAPES)
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_k3_takes_any_head_group_and_row_width(dev, kind, G, D, dtype):
    """Head groups that are no instantiation and rows that are no power of
    two of 16-byte units, against the sequential plain version at several
    split counts: outputs within 1e-5 (f32) or 2^-7 (bf16) x max|o|,
    bounds within 1e-4 relative."""
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, dtype, seed=31, KV=2,
                                                 G=G, D=D)
    args = (kp, vp, table, 16) if kind == "paged" else (kd, vd, None, 32)
    T = args[3]
    W = table.shape[1] if kind == "paged" else -(-kd.shape[1] // T)
    tol = 1e-5 if dtype == F32 else 2 ** -7
    seq = fa.flash_decode_ref(q, *args[:3], lengths, block=T)
    for splits in sorted({1, 3, W, fa.decode_splits(4, 2, W, T, G)}):
        got = fa.flash_decode_kernel(q, *args[:3], lengths, block=T,
                                     splits=splits)
        torch.cuda.synchronize()
        assert got[0].shape == seq[0].shape and got[1].shape == seq[1].shape
        scale = seq[0].float().abs().max().item()
        assert (got[0].float() - seq[0].float()).abs().max().item() <= \
            tol * scale, splits
        for g, r in ((got[2], seq[2]), (got[4], seq[4])):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-30)


def test_k3_launches_on_two_streams_at_once_agree_with_one(dev):
    """Each stream draws split tickets from a buffer of its own: K3 launched
    on two streams at once gives, bit for bit, what it gives on one."""
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, BF16, seed=32)
    want = fa.flash_decode_kernel(q, kp, vp, table, lengths, block=16,
                                  splits=8)
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = [[], []]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(16):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(fa.flash_decode_kernel(
                    q, kp, vp, table, lengths, block=16, splits=8))
    torch.cuda.synchronize()
    for runs in outs:
        for r in runs:
            assert all(torch.equal(a, b) for a, b in zip(r, want))


def test_k3_captured_in_a_graph_replays_its_eager_result(dev):
    """Launches captured in a graph keep tickets of their own (two
    launches share the graph's buffer): replays, with eager launches on
    the capture stream between them (one of which grows that stream's
    buffer), equal the eager launches bit for bit."""
    q, kp, vp, kd, vd, table, lengths = _k3_case(dev, BF16, seed=33)
    want = fa.flash_decode_kernel(q, kd, vd, None, lengths, block=32,
                                  splits=4)
    want2 = fa.flash_decode_kernel(q, kp, vp, table, lengths, block=16,
                                   splits=8)
    gen = torch.Generator(device="cpu").manual_seed(34)
    qb = torch.randn(8, 1, 40, 64, generator=gen).to(dev, BF16)
    kb = torch.randn(8, 64, 40, 64, generator=gen).to(dev, BF16)
    lb = torch.full((8,), 64, dtype=torch.int32, device=dev)
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=st):
        got = fa.flash_decode_kernel(q, kd, vd, None, lengths, block=32,
                                     splits=4)
        got2 = fa.flash_decode_kernel(q, kp, vp, table, lengths, block=16,
                                      splits=8)
    for i in range(4):
        with torch.cuda.stream(st):
            if i == 1:       # 320 tickets: the stream's buffer grows
                fa.flash_decode_kernel(qb, kb, kb, None, lb, block=32,
                                       splits=2)
            fa.flash_decode_kernel(q, kd, vd, None, lengths, block=32,
                                   splits=4)
            graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(got2, want2))


# ------------------------------------------------------------ campaigns

def _campaign_engine(dev, dtype, cache, **kw):
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(3, dtype=dtype)
    return ServeEngine(model, params, slots=2, max_len=64, dtype=dtype,
                       device=dev, cache_kind=cache,
                       abft=ABFTConfig(flash_attention=True), **kw)


def _campaign_reqs(n=5, new_tokens=8):
    rng = np.random.default_rng(5)
    return [Request(uid=i, prompt=rng.integers(1, 256, size=int(L)).astype(
        np.int32), max_new_tokens=new_tokens)
        for i, L in enumerate(rng.integers(3, 40, size=n))]


def _fault_model(**kw):
    from repro_torch.core.faults import FaultModel

    base = dict(transient_rate=0.3, seed=1, layers=2, dtype=torch.float32,
                magnitude=1e4)
    base.update(kw)
    return FaultModel(**base)


# bf16 takes K1's tensor-core routes (tc; the tied head tc_kmajor), f32
# the GEMV at decode and simt at admission
CAMPAIGN_ROUTES = [(torch.bfloat16, "dense"), (torch.bfloat16, "paged"),
                   (torch.float32, "dense"), (torch.float32, "paged")]


@pytest.mark.parametrize("dtype,cache", CAMPAIGN_ROUTES)
def test_protected_campaign_on_the_card_corrects_every_fault(dev, dtype,
                                                             cache):
    clean = _campaign_engine(dev, dtype, cache).run(_campaign_reqs())
    eng = _campaign_engine(dev, dtype, cache, fault_model=_fault_model())
    k1 = am.KERNEL.launches
    got = eng.run(_campaign_reqs())
    st = eng.stats
    assert am.KERNEL.launches > k1
    assert st.faults_injected > 0 and st.sdc_faults == 0
    assert st.faults_injected == (st.faults_corrected
                                  + st.faults_uncorrected
                                  + st.masked_faults)
    assert got == clean


@pytest.mark.parametrize("dtype,cache", CAMPAIGN_ROUTES)
def test_shadow_runs_on_the_card_leave_no_trace(dev, dtype, cache):
    """Sub-threshold value faults go undetected, so every one is shadow-
    classified through K1: after every step the cache equals, bit for
    bit, that of a twin engine that never runs a shadow."""
    kw = dict(magnitude=1e-5, transient_rate=0.5)
    a = _campaign_engine(dev, dtype, cache, fault_model=_fault_model(**kw))
    b = _campaign_engine(dev, dtype, cache, fault_model=_fault_model(**kw),
                         classify_injections=False)
    pa, pb = _campaign_reqs(), _campaign_reqs()
    k1 = am.KERNEL.launches
    while pa or a.active:
        if pa and a.free_slots():
            a.admit(pa)
            b.admit(pb)
        assert a.step() == b.step()
        for la, lb in zip(a.cache, b.cache):
            assert torch.equal(la["k"], lb["k"])
            assert torch.equal(la["v"], lb["v"])
    assert am.KERNEL.launches > k1
    st = a.stats
    assert st.faults_detected == 0 and st.faults_injected > 0
    assert st.masked_faults + st.sdc_faults == st.faults_injected
    assert {e["outcome"] for e in b.stats.injection_log} == {"undetected"}


def test_sticky_fault_on_the_card_becomes_a_hard_fault(dev):
    from repro_torch.serve.engine import RecoveryPolicy

    eng = _campaign_engine(
        dev, torch.bfloat16, "dense", policy=RecoveryPolicy(max_retries=1),
        fault_model=_fault_model(transient_rate=0.0, permanent_rate=1.0,
                                 permanent_duration=2, sites=("mlp_down",)))
    reqs = _campaign_reqs()
    eng.run(reqs)
    st = eng.stats
    assert st.hard_faults >= 1 and st.faults_uncorrected >= 1
    assert st.evictions >= 1
    assert {r.error for r in reqs if r.error} == {"hard_fault:decode"}
    eng.fault_model = None                  # the engine serves on
    out = eng.run(_campaign_reqs(n=2))
    assert all(len(s) == 8 for s in out.values())


def test_sampling_retry_on_the_card_redraws_the_same_token(dev):
    from repro_torch.models.layers import ModelFault

    kw = dict(temperature=0.8, top_k=20, seed=5)
    clean = _campaign_engine(dev, torch.bfloat16, "paged", **kw)
    out_clean = clean.run(_campaign_reqs())
    eng = _campaign_engine(dev, torch.bfloat16, "paged", **kw)
    fault = ModelFault.at(1, "qkv", FaultSpec.value(0, 3, 1e4))
    out = eng.run(_campaign_reqs(), fault_at=(2, fault))
    assert eng.stats.retries == 1 and out == out_clean
    assert all(torch.equal(x.get_state(), y.get_state())
               for x, y in zip(clean.generators, eng.generators))


@pytest.mark.parametrize("dtype,cache", CAMPAIGN_ROUTES)
def test_bitflip_campaign_on_the_card_holds_the_invariants(dev, dtype,
                                                           cache):
    """f32 exponent-bit flips land in K1's f32 accumulator on each route
    (``fault_value``): every injection is accounted for, the campaign
    replays from its seed, and every detection is corrected."""
    runs = []
    for _ in range(2):
        fm = _fault_model(magnitude=None, transient_rate=0.4)
        eng = _campaign_engine(dev, dtype, cache, fault_model=fm)
        out = eng.run(_campaign_reqs())
        runs.append((out, fm.schedule, eng.stats.injection_log))
        st = eng.stats
        assert st.faults_injected == len(st.injection_log) > 0
        assert st.faults_injected == (st.faults_corrected
                                      + st.faults_uncorrected
                                      + st.sdc_faults + st.masked_faults)
        assert st.faults_uncorrected == 0 and st.hard_faults == 0
        assert all(23 <= e["bit"] < 31 for e in st.injection_log)
    assert runs[0] == runs[1]
