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


# ------------------------------------------------------- the dense family

# small members of the dense family with their real head dims: qwen3-14b
# (q/k norm, G = 5, D = 128), stablelm-1.6b (LayerNorm, MHA, D = 64 with
# 16 rotated dims), qwen1.5-32b (QKV biases, MHA, D = 128)
FAMILY = {"qwen3-14b": dict(n_heads=10, n_kv_heads=2, head_dim=128),
          "stablelm-1.6b": dict(n_heads=4, n_kv_heads=4, head_dim=64),
          "qwen1.5-32b": dict(n_heads=4, n_kv_heads=4, head_dim=128)}


def _family(arch, dtype, seed=0):
    """A scaled-down family member with seeded nonzero biases, LayerNorm
    shifts and gains (1 + N(0, 0.1); biases N(0, 0.1)), on the CPU."""
    from repro_torch.core.tree import tree_leaves_with_path

    cfg = scaled_down(get_config(arch), **FAMILY[arch])
    model = Model(cfg)
    params = model.init_params(seed, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)
    for path, leaf in tree_leaves_with_path(params):
        if path[-1] in ("w", "q_norm", "k_norm"):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen))
        elif path[-1] in ("b", "bq", "bk", "bv"):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen))
    from repro_torch.core.tree import tree_map

    return model, tree_map(lambda t: t.to(dtype), params)


def _to(params, dev):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.to(dev), params)


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_family_engine_on_the_card_equals_the_cpu(dev, arch):
    """f32 serving, flash on, dense and paged: the card (K1 with the
    biases after it, K3 over the q/k-normed, partially rotated cache) and
    the CPU (their plain versions) give the same greedy streams."""
    model, params = _family(arch, torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 40, size=5)]
    streams = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        for kind in ("dense", "paged"):
            eng = ServeEngine(model, p, slots=2, max_len=64,
                              dtype=torch.float32, device=d,
                              cache_kind=kind,
                              abft=ABFTConfig(flash_attention=True))
            k1, k3 = am.KERNEL.launches, fa.KERNEL.launches
            streams[(str(d), kind)] = eng.run(
                [Request(uid=i, prompt=q, max_new_tokens=8)
                 for i, q in enumerate(prompts)])
            assert eng.stats.faults_detected == 0
            if str(d) != "cpu":
                assert am.KERNEL.launches > k1 and fa.KERNEL.launches > k3
    assert len({str(s) for s in streams.values()}) == 1


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_family_forward_on_the_card_matches_the_cpu(dev, arch):
    """f32 ``Model.forward`` with K2 (CUDA-core route) on the card
    against the CPU's plain versions: logits within 1e-4 absolute and
    relative (f32 sums in another order), no flag, one K2 launch a
    layer."""
    from repro_torch.models.layers import LayerCtx

    model, params = _family(arch, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, 256, size=(2, 48)))
    ctx = LayerCtx(abft=ABFTConfig(flash_attention=True))
    with torch.no_grad():
        want = model.forward(params, {"tokens": toks}, ctx, device="cpu")
        k2 = fa.FULL_KERNEL.launches
        got = model.forward(_to(params, dev), {"tokens": toks}, ctx,
                            device=dev)
    assert fa.FULL_KERNEL.launches == k2 + model.cfg.n_layers
    assert not bool(got.flag) and not bool(want.flag)
    torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", sorted(FAMILY))
def test_family_bf16_forward_on_the_card_tracks_f32(dev, arch):
    """bf16 ``Model.forward`` on the card (K1 and K2 on the tensor cores)
    against the same bf16 weights run in f32 on the CPU: logits within
    1/16 of max|logits| (bf16 activations through two layers, each op
    rounding to 2^-9 relative, amplified by the norms), no flag, and the
    chunked path on the card within the same distance."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    model, params = _family(arch, torch.bfloat16)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, 256, size=(2, 160)))
    with torch.no_grad():
        ref = model.forward(tree_map(lambda t: t.float(), params),
                            {"tokens": toks}, LayerCtx(), device="cpu")
        pd = _to(params, dev)
        scale = ref.logits.abs().max().item()
        for flash in (True, False):
            got = model.forward(pd, {"tokens": toks}, LayerCtx(
                abft=ABFTConfig(flash_attention=flash)), device=dev)
            assert not bool(got.flag)
            err = (got.logits.cpu() - ref.logits).abs().max().item()
            assert err <= scale / 16, (flash, err, scale)


# ------------------------------------------------- sharing and chunking

@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_row_invariant_rows_equal_whatever_m(dev, dtype):
    """With ``one_slice`` pass 1 is one K slice at every M, and a row's
    output is bit-identical in a thin GEMM (a prompt chunk) and in a tall
    one (the whole prompt): tensor cores (bf16) and SIMT (f32)."""
    x, w = _k1_inputs(dev, 1536, 2048, 2048, dtype, seed=11)
    kw = dict(mode="1s", out_dtype=dtype, one_slice=True)
    for m in (16, 256, 1536):
        bm, bk, bn = _blocks(m, 2048, 2048)
        assert am.plan(x[:m], w, mode="1s", bm=bm, bk=bk, bn=bn,
                       one_slice=True).slices == 1
    whole, _ = ops.abft_matmul(x, w, **kw)
    parts = [ops.abft_matmul(x[a:a + n], w, **kw)[0]
             for a, n in ((0, 16), (16, 256), (272, 1264))]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), whole)


def test_chunked_and_shared_streams_on_the_card_equal_unchunked(dev):
    """Scaled-down bf16 llama3.2-1b with K1 and K3 on the card: prefix
    sharing, chunked prefill (dense and paged, an odd budget, ``auto``)
    and both together give the plain paged engine's greedy streams
    exactly (bit-identical KV: one-slice K1, row-wise
    attention), and every run launched both kernels."""
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(3, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(5)
    sys_p = rng.integers(1, 256, size=40)
    prompts = [np.concatenate([sys_p, rng.integers(1, 256, size=int(n))])
               for n in (5, 17, 30)]
    prompts += [prompts[1].copy(), rng.integers(1, 256, size=90)]
    runs = {"plain": dict(cache_kind="paged"),
            "share": dict(cache_kind="paged", prefix_sharing=True),
            "chunk_dense": dict(chunk_tokens=24),
            "chunk_odd": dict(cache_kind="paged", chunk_tokens=13),
            "chunk_auto": dict(cache_kind="paged", chunk_tokens="auto"),
            "both": dict(cache_kind="paged", prefix_sharing=True,
                         chunk_tokens=16)}
    streams = {}
    for name, kw in runs.items():
        eng = ServeEngine(model, params, slots=2, max_len=160,
                          dtype=torch.bfloat16, device=dev, block_size=8,
                          abft=ABFTConfig(flash_attention=True), **kw)
        k1, k3 = am.KERNEL.launches, fa.KERNEL.launches
        streams[name] = eng.run([Request(uid=i, prompt=p, max_new_tokens=8)
                                 for i, p in enumerate(prompts)])
        assert am.KERNEL.launches > k1 and fa.KERNEL.launches > k3
        assert eng.stats.faults_detected == 0
        if eng.pool is not None:
            eng.pool.check_invariants()
    for name in runs:
        assert streams[name] == streams["plain"], name


def test_k1_one_slice_f32_chunks_of_at_most_8_rows_equal_whole(dev):
    """An f32 prefill chunk of 1, 4 or 8 rows under ``one_slice`` takes the
    one-slice SIMT pass 1 (not the GEMV) and gets, bit for bit, the rows
    of the whole prompt's GEMM."""
    x, w = _k1_inputs(dev, 512, 2048, 2048, torch.float32, seed=12)
    kw = dict(mode="1s", out_dtype=torch.float32, one_slice=True)
    whole, _ = ops.abft_matmul(x, w, **kw)
    for a, n in ((0, 1), (5, 4), (100, 8), (504, 8)):
        bm, bk, bn = _blocks(n, 2048, 2048)
        assert am.plan(x[a:a + n], w, mode="1s", bm=bm, bk=bk, bn=bn,
                       one_slice=True).route == "simt"
        part, _ = ops.abft_matmul(x[a:a + n], w, **kw)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[a:a + n]), (a, n)


# ------------------------------------------------- speculative verify

# llama3.2-1b's GEMMs (K, N, tied head)
VERIFY_GEMMS = [(2048, 2048, False), (2048, 512, False), (2048, 8192, False),
                (8192, 2048, False), (2048, 128256, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("slots", [1, 4, 8, 16])
def test_k1_verify_rows_equal_decode_rows(dev, slots, dtype):
    """A verify GEMM of slots x (K+1) rows (``decode_rows=slots``), K = 1
    to 8, gives row (b, t) bit for bit the decode GEMM's row b fed step
    t alone, at llama3.2-1b's shapes: bf16 on the tensor cores with the
    decode split pinned; f32 through the decode route step by step where
    the rows cannot take it (the GEMV, the head's tiles)."""
    for i, (k, n, head) in enumerate(VERIFY_GEMMS):
        _, w = _k1_inputs(dev, 1, k, n, dtype, seed=40 + i, transposed=head)
        for K in range(1, 9):
            T = K + 1
            g = torch.Generator(device=dev).manual_seed(100 * K + i)
            x = torch.randn(slots, T, k, generator=g, device=dev).to(dtype)
            out_dtype = torch.float32 if head else dtype
            ver, chk = ops.abft_matmul(x, w, out_dtype=out_dtype,
                                       decode_rows=slots)
            assert not bool(chk.flag)
            for t in range(T):
                dec, _ = ops.abft_matmul(x[:, t:t + 1].contiguous(), w,
                                         out_dtype=out_dtype)
                assert torch.equal(ver[:, t], dec[:, 0]), (k, n, K, t)


@pytest.mark.parametrize("slots", [1, 4, 8, 16])
def test_verify_norms_equal_decode_norms(dev, slots):
    """The verify path's norms over slots x T rows, T = 2 to 9, give each
    step the decode step's bits: ``rms_norm`` and ``layer_norm`` over
    d_model one step at a time (``per_step``), and qwen3-14b's q/k norms
    (40 and 8 heads of 128) batched, as ``attention._qkv`` runs them."""
    from repro_torch.models.layers import layer_norm, per_step, rms_norm

    g = torch.Generator(device=dev).manual_seed(slots)
    w = torch.randn(2048, generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn(2048, generator=g, device=dev).to(torch.bfloat16)
    wq = torch.randn(128, generator=g, device=dev).to(torch.bfloat16)
    for T in range(2, 10):
        x = torch.randn(slots, T, 2048, generator=g,
                        device=dev).to(torch.bfloat16)
        q = torch.randn(slots, T, 40, 128, generator=g,
                        device=dev).to(torch.bfloat16)
        k = torch.randn(slots, T, 8, 128, generator=g,
                        device=dev).to(torch.bfloat16)
        for fn, t_in, args, stepwise in ((rms_norm, x, (w, 1e-5), True),
                                         (layer_norm, x, (w, b, 1e-5), True),
                                         (rms_norm, q, (wq, 1e-6), False),
                                         (rms_norm, k, (wq, 1e-6), False)):
            got = per_step(fn, t_in, *args) if stepwise else fn(t_in, *args)
            for t in range(T):
                dec = fn(t_in[:, t:t + 1].contiguous(), *args)
                assert torch.equal(got[:, t:t + 1], dec), (fn, T, t)


def test_batched_d_model_norm_sums_differ_from_decode(dev):
    """Why the verify step runs its d_model norms one step at a time: at 4
    slots a batched row reduction over 4 x 9 rows of 2048 sums rows in
    another order than decode's over 4 rows (the library's thread block
    for a row reduction depends on the row count below 16 rows), so the
    f32 mean of squares differs in some row.  If this starts to fail, the
    library reduces a row alike at both counts and ``per_step`` can go."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, 9, 2048, generator=g, device=dev).to(torch.bfloat16)

    def mean_sq(a):              # ``rms_norm``'s reduction
        af = a.float()
        return (af * af).mean(dim=-1)

    dec = torch.cat([mean_sq(x[:, t:t + 1].contiguous()) for t in range(9)],
                    1)
    assert not torch.equal(mean_sq(x), dec)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_attention_rows_equal_decode_attention(dev, kind):
    """``verify_attention`` row t equals ``decode_attention`` at length
    ``pos + 1 + t`` bit for bit, at llama3.2-1b's heads (H 32, KV 8, D
    64) over a 1024-deep bf16 cache, dense or gathered from pools."""
    from repro_torch.models.layers import decode_attention, verify_attention
    from repro_torch.serve.paged_cache import paged_gather

    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H, KV, D = 4, 1024, 32, 8, 64
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    if kind == "paged":
        perm = torch.randperm(B * S // 16, generator=g, device=dev)
        pk = torch.empty_like(k.reshape(-1, 16, KV, D))
        pv = torch.empty_like(pk)
        pk[perm] = k.reshape(-1, 16, KV, D)
        pv[perm] = v.reshape(-1, 16, KV, D)
        tables = perm.reshape(B, S // 16).int()
        k, v = paged_gather(pk, tables), paged_gather(pv, tables)
    pos = torch.tensor([0, 37, 511, 1014], dtype=torch.int32, device=dev)
    for T in (1, 5, 9):
        q = torch.randn(B, T, H, D, generator=g,
                        device=dev).to(torch.bfloat16)
        got = verify_attention(q, k, v, pos + 1)
        for t in range(T):
            dec = decode_attention(q[:, t:t + 1].contiguous(), k, v,
                                   pos + 1 + t)
            assert torch.equal(got[:, t:t + 1], dec), (T, t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spec_streams_on_the_card_equal_unsped(dev, dtype):
    """Scaled-down llama3.2-1b with K1 on the card, flash off: ngram at
    K = 4 and ``"auto"`` (dense and paged) and self-draft give the unsped
    engine's greedy streams exactly, K1 launched on every run, no clean
    flag (f32 runs the verify GEMMs step by step through the GEMV)."""
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(5, dtype=dtype, device=dev)
    rng = np.random.default_rng(8)
    prompts = []
    for n in (6, 11, 9):
        span = rng.integers(1, 256, size=n)
        prompts.append(np.concatenate(
            [rng.integers(1, 256, size=20), span,
             rng.integers(1, 256, size=5), span]).astype(np.int32))
    prompts.append(rng.integers(1, 256, size=30).astype(np.int32))
    runs = {"plain": {}, "plain_paged": dict(cache_kind="paged"),
            "k4": dict(spec_decode="ngram", draft_len=4),
            "k4_paged": dict(spec_decode="ngram", draft_len=4,
                             cache_kind="paged"),
            "auto": dict(spec_decode="ngram", draft_len="auto"),
            "self": dict(spec_decode="self_draft", draft_len=3,
                         draft_units=1, draft_window=16)}
    streams, accepted = {}, 0
    for name, kw in runs.items():
        eng = ServeEngine(model, params, slots=2, max_len=160, dtype=dtype,
                          device=dev, block_size=8, **kw)
        k1 = am.KERNEL.launches
        streams[name] = eng.run([Request(uid=i, prompt=p, max_new_tokens=16)
                                 for i, p in enumerate(prompts)])
        assert am.KERNEL.launches > k1
        assert eng.stats.faults_detected == 0
        accepted += eng.stats.draft_accepted
        if eng.pool is not None:
            eng.pool.check_invariants()
    for name in runs:
        assert streams[name] == streams["plain"], name
    assert accepted > 0


@pytest.mark.parametrize("scheme", ["global", "none"])
def test_spec_streams_on_the_card_equal_unsped_plain_schemes(dev, scheme):
    """Scaled-down bf16 llama3.2-1b under a plain scheme (``global``,
    ``none``: ``torch.matmul``, no K1), flash off: ngram at K = 4 (dense
    and paged) gives the unsped engine's greedy streams exactly (the
    verify step runs the plain product step by step at the decode
    shape), and K1 never launches."""
    from repro_torch.core.policy import FixedPolicy
    from repro_torch.core.schemes import Scheme

    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    model = Model(cfg)
    params = model.init_params(5, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(9)
    prompts = []
    for n in (6, 11, 9, 7):
        span = rng.integers(1, 256, size=n)
        prompts.append(np.concatenate(
            [rng.integers(1, 256, size=20), span,
             rng.integers(1, 256, size=5), span]).astype(np.int32))
    abft = ABFTConfig.from_policy(FixedPolicy(Scheme(scheme)))
    runs = {"plain": {}, "k4": dict(spec_decode="ngram", draft_len=4),
            "k4_paged": dict(spec_decode="ngram", draft_len=4,
                             cache_kind="paged")}
    streams, accepted = {}, 0
    k1 = am.KERNEL.launches
    for name, kw in runs.items():
        eng = ServeEngine(model, params, slots=4, max_len=160,
                          dtype=torch.bfloat16, device=dev, block_size=8,
                          abft=abft, **kw)
        streams[name] = eng.run([Request(uid=i, prompt=p, max_new_tokens=16)
                                 for i, p in enumerate(prompts)])
        assert eng.stats.faults_detected == 0
        accepted += eng.stats.draft_accepted
        if eng.pool is not None:
            eng.pool.check_invariants()
    assert am.KERNEL.launches == k1
    for name in runs:
        assert streams[name] == streams["plain"], name
    assert accepted > 0


# ------------------------------------------------------ K1 over experts

# (E, C, K, N): decode capacity, an admission's, a ragged one; the
# scaled-down expert GEMMs (K = 32: a ragged TMA box); unaligned rows
K1_MOE_SHAPES = [(6, 4, 2048, 1408), (6, 88, 1408, 2048),
                 (5, 13, 256, 384), (8, 2, 32, 64), (8, 8, 64, 32),
                 (4, 5, 40, 24)]


def _moe_inputs(dev, E, C, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((E, K, N))).astype(
        np.float32))
    return x.to(dev, dtype), w.to(dev, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", K1_MOE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_batched_over_experts_matches_plain_version(dev, shape, mode,
                                                       dtype):
    """One launch for all experts, each expert's y, residual and bound as
    the batched plain version's."""
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    E, C, K, N = shape
    x, w = _moe_inputs(dev, E, C, K, N, dtype, seed=sum(shape))
    bm, bk, bn = _blocks(C, K, N)
    kw = dict(mode=mode, bm=bm, bk=bk, bn=bn, out_dtype=dtype)
    before, batched = am.KERNEL.launches, am.BATCHED.launches
    y, res, bnd = am.abft_matmul_kernel(x, w, **kw)
    assert am.KERNEL.launches == before + 1
    assert am.BATCHED.launches == batched + 1
    yp, resp, bndp = abft_matmul_batched_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert y.shape == yp.shape and res.shape == resp.shape
    err = (y.float() - yp.float()).abs().max().item()
    assert err <= _y_tol(yp, dtype)
    torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    _, chk = ops.abft_matmul_batched(x, w, mode=mode, out_dtype=dtype)
    assert not bool(chk.flag)


@pytest.mark.parametrize("mode", ["1s", "2s", "replica"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [4, 40])
def test_k1_batched_flags_the_fault_in_every_expert(dev, C, dtype, mode):
    E, K, N = 6, 512, 384
    x, w = _moe_inputs(dev, E, C, K, N, dtype, seed=C)
    row, col = C - 1, N // 2 + 3
    bm, _, bn = _blocks(C, K, N)
    want = (row // bm, col // bn) + (() if mode == "2s" else (row % bm,))
    flat = int(np.ravel_multi_index(want, (-(-C // bm), -(-N // bn))
                                    + (() if mode == "2s" else (bm,))))
    clean, _ = ops.abft_matmul_batched(x, w, mode=mode)
    y, chk = ops.abft_matmul_batched(x, w, mode=mode,
                                     fault=FaultSpec.value(row, col, 1e4))
    assert bool(chk.flag)
    ratio = (chk.residual / chk.threshold).reshape(E, -1)
    assert (ratio.argmax(1) == flat).all()
    assert ((ratio > 1).sum(1) == 1).all()
    diff = (y != clean).nonzero().tolist()
    assert diff == [[e, row, col] for e in range(E)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_batched_is_bit_for_bit_deterministic(dev, dtype):
    x, w = _moe_inputs(dev, 60, 4, 2048, 1408, dtype, seed=8)
    runs = [ops.abft_matmul_batched(x, w) for _ in range(3)]
    for y, chk in runs[1:]:
        assert torch.equal(y, runs[0][0])
        assert torch.equal(chk.residual, runs[0][1].residual)


def test_k1_batched_odd_expert_stride_takes_the_tiles(dev):
    """Experts that do not start on 16-byte boundaries leave only the
    CUDA-core tiles, which read any stride."""
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    E, C, K, N = 4, 8, 64, 32
    buf = torch.randn(E * (K * N + 1), device=dev).to(torch.bfloat16)
    w = buf.as_strided((E, K, N), (K * N + 1, N, 1))
    x = torch.randn(E, C, K, device=dev).to(torch.bfloat16)
    kw = dict(mode="1s", bm=8, bk=64, bn=32, out_dtype=torch.bfloat16)
    y, _, bnd = am.abft_matmul_kernel(x, w, **kw)
    yp, _, bndp = abft_matmul_batched_ref(x, w, **kw)
    assert (y.float() - yp.float()).abs().max().item() <= _y_tol(
        yp, torch.bfloat16)
    torch.testing.assert_close(bnd, bndp, rtol=1e-5, atol=1e-30)
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(x, w, **kw, force="tc")


def test_k1_batched_wrapper_raises_rather_than_falls_back(dev):
    x, w = _moe_inputs(dev, 3, 4, 64, 32, torch.float32, seed=1)
    kw = dict(mode="1s", bm=8, bk=64, bn=32, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(x, w.cpu(), **kw)
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(x, w[:2], **kw)
    with pytest.raises(ValueError):
        am.abft_matmul_kernel(x, w[0], **kw)
    with pytest.raises(TypeError):
        am.abft_matmul_kernel(x, w.to(torch.bfloat16), **kw)


@pytest.mark.parametrize("fdl", [0, 1])
def test_small_moe_engine_on_the_card_equals_the_cpu(dev, fdl):
    """Scaled-down f32 qwen2-moe-a2.7b (and a dense first layer): the
    engine on the card (K1 batched over experts among the kernels) and on
    the CPU give the same greedy streams, dense and paged; K1 ran three
    batched launches a MoE layer a decode step."""
    cfg = scaled_down(get_config("qwen2-moe-a2.7b"), first_dense_layers=fdl)
    n_moe = cfg.n_layers - fdl
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
            reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            if str(d) != "cpu":
                eng.admit(reqs[:2])
                b0 = am.BATCHED.launches
                eng.step()
                assert am.BATCHED.launches - b0 == 3 * n_moe
                reqs = [Request(uid=i, prompt=p, max_new_tokens=8)
                        for i, p in enumerate(prompts)]
                eng = ServeEngine(model, params, slots=2, max_len=64,
                                  dtype=torch.float32, device=d,
                                  cache_kind=kind,
                                  abft=ABFTConfig(flash_attention=True))
            streams[(str(d), kind)] = eng.run(reqs)
    assert len({str(s) for s in streams.values()}) == 1


@pytest.mark.parametrize("fdl", [0, 1])
def test_small_moe_forward_on_the_card_equals_the_cpu(dev, fdl):
    """The same scaled-down f32 stacks through ``Model.forward``: logits
    on the card within 1e-4 of the CPU's (f32 sums in another order),
    equal flags, the aux loss within 1e-5 relative."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    cfg = scaled_down(get_config("qwen2-moe-a2.7b"), first_dense_layers=fdl)
    model = Model(cfg)
    params = model.init_params(3, dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(1, 256, size=(2, 24)))
    out = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            out[str(d)] = model.forward(tree_map(lambda t: t.to(d), params),
                                        {"tokens": tokens.to(d)},
                                        LayerCtx(), device=d)
    a, b = out["cpu"], out[str(dev)]
    assert (a.logits - b.logits.cpu()).abs().max().item() <= 1e-4
    assert bool(a.flag) == bool(b.flag.cpu())
    assert abs(float(a.aux_loss) - float(b.aux_loss)) \
        <= 1e-5 * abs(float(a.aux_loss))


# ------------------------------------------------------------------ MLA

def _mla_layer(dev, dtype=torch.bfloat16):
    """One MLA layer at deepseek-v3's published widths (128 heads, latent
    ranks 1536 / 512, head dims 128 + 64), seeded weights on the card."""
    from repro_torch.models import attention as attn

    cfg = get_config("deepseek-v3-671b")
    gen = torch.Generator(device=dev).manual_seed(17)

    def w(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def vec(n, fill):
        return torch.full((n,), fill, dtype=dtype, device=dev)

    return cfg, attn.init_mla(cfg, w, vec), gen


def test_mla_serving_prefill_is_bit_equal_whole_suffix_and_chunks(dev):
    """At deepseek-v3's widths in bf16 on the card: a 600-token prompt
    prefilled whole (beside a second row), as the suffix behind its first
    512 tokens, and in chunks of 256 gives bit-equal latent cells and
    last-row outputs (row-wise attention, the absorbed products in
    ``ABSORB_ROWS``-row blocks, K1 as one K slice)."""
    import dataclasses

    from repro_torch.core.protected import ABFTConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import LayerCtx

    cfg, p, gen = _mla_layer(dev)
    L = 600
    x = torch.randn(2, L, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    ctx = LayerCtx(abft=dataclasses.replace(ABFTConfig(), one_slice=True))

    def run(cuts, rows=1):
        cache = attn.init_mla_cache(cfg, 2, 1024, torch.bfloat16, dev)
        out = None
        for s, e in zip(cuts[:-1], cuts[1:]):
            n = e - s
            kw = dict(slots=torch.arange(rows, device=dev),
                      lengths=torch.full((rows,), n, device=dev))
            if s:
                kw["starts"] = torch.full((rows,), s, device=dev)
            pos = torch.arange(s, e, device=dev).expand(rows, n)
            out, flag = attn.mla_prefill(x[:rows, s:e], p, cfg, ctx, pos,
                                         cache, spans=[(s, e)] * rows, **kw)
            assert not bool(flag)
        return out[0, -1], cache["latent"][0, :L]

    o_whole, c_whole = run([0, L], rows=2)
    for cuts in ([0, 512, L], [0, 256, 512, L]):
        o, c = run(cuts)
        assert torch.equal(c, c_whole), cuts
        assert torch.equal(o, o_whole), cuts


@pytest.mark.parametrize("slots", [1, 4])
def test_mla_verify_rows_equal_decode_rows(dev, slots):
    """At deepseek-v3's widths in bf16 on the card: each row of a verify
    window of T = 5 (latent norms and absorbed products a step at a time,
    K1 on the decode split) is bit for bit what the decode step computes
    at its position, latents and outputs."""
    import dataclasses

    from repro_torch.core.protected import ABFTConfig
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import LayerCtx

    cfg, p, gen = _mla_layer(dev)
    T = 5
    x = torch.randn(slots, T, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    pos = torch.arange(slots, device=dev, dtype=torch.int32) * 7 + 40
    seed = torch.randn(slots, 128, 576, generator=gen, device=dev).to(
        torch.bfloat16)
    ver = {"latent": seed.clone()}
    dec = {"latent": seed.clone()}
    vctx = LayerCtx(abft=dataclasses.replace(ABFTConfig(),
                                             decode_rows=slots))
    index = attn.verify_write_index(pos, torch.full((slots,), T,
                                                    device=dev), T, 128)
    out_v, _ = attn.mla_verify(x, p, cfg, vctx, pos, ver, index)
    for t in range(T):
        out_d, _ = attn.mla_decode(x[:, t:t + 1].contiguous(), p, cfg,
                                   LayerCtx(), pos + t, dec)
        assert torch.equal(out_v[:, t:t + 1], out_d), t
    assert torch.equal(ver["latent"], dec["latent"])


def test_small_mla_engine_on_the_card_equals_the_cpu(dev):
    """Scaled-down f32 deepseek-v3 (an MLA dense layer and an MLA MoE
    layer): the engine on the card (K1 among the kernels, K2 and K3
    never) and on the CPU give the same greedy streams, dense, paged and
    paged with prefix sharing and chunks of 8."""
    cfg = scaled_down(get_config("deepseek-v3-671b"))
    model = Model(cfg)
    params = model.init_params(3, dtype=torch.float32)
    rng = np.random.default_rng(5)
    sys_p = rng.integers(1, 256, size=12)
    prompts = [np.concatenate([sys_p, rng.integers(1, 256, size=int(n))])
               .astype(np.int32) for n in rng.integers(3, 30, size=5)]
    streams = {}
    for d in ("cpu", dev):
        for name, kw in (("dense", {}), ("paged", dict(cache_kind="paged")),
                         ("shared_chunks", dict(cache_kind="paged",
                                                prefix_sharing=True,
                                                chunk_tokens=8))):
            eng = ServeEngine(model, params, slots=2, max_len=64,
                              dtype=torch.float32, device=d, block_size=8,
                              abft=ABFTConfig(flash_attention=True), **kw)
            k1, k2, k3 = (am.KERNEL.launches, fa.FULL_KERNEL.launches,
                          fa.KERNEL.launches)
            streams[(str(d), name)] = eng.run(
                [Request(uid=i, prompt=p, max_new_tokens=8)
                 for i, p in enumerate(prompts)])
            assert eng.stats.faults_detected == 0
            if str(d) != "cpu":
                assert am.KERNEL.launches > k1
                assert fa.FULL_KERNEL.launches == k2
                assert fa.KERNEL.launches == k3
    assert len({str(s) for s in streams.values()}) == 1


def test_small_mla_forward_on_the_card_equals_the_cpu(dev):
    """Scaled-down f32 deepseek-v3 through ``Model.forward``: logits and
    ``mtp_logits`` on the card within 1e-4 of the CPU's (f32 sums in
    another order), equal flags, the aux loss within 1e-5 relative."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    model = Model(scaled_down(get_config("deepseek-v3-671b")))
    params = model.init_params(3, dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(1, 256, size=(2, 24)))
    out = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            out[str(d)] = model.forward(tree_map(lambda t: t.to(d), params),
                                        {"tokens": tokens.to(d)},
                                        LayerCtx(), device=d)
    a, b = out["cpu"], out[str(dev)]
    assert (a.logits - b.logits.cpu()).abs().max().item() <= 1e-4
    assert (a.mtp_logits - b.mtp_logits.cpu()).abs().max().item() <= 1e-4
    assert bool(a.flag) == bool(b.flag.cpu())
    assert abs(float(a.aux_loss) - float(b.aux_loss)) \
        <= 1e-5 * abs(float(a.aux_loss))


# ------------------------------------------------------------------ SSM

SSM_ARCHS = {"mamba2-1.3b": {}, "jamba-v0.1-52b": {"n_layers": 8}}


@pytest.mark.parametrize("arch", sorted(SSM_ARCHS))
def test_small_ssm_engine_on_the_card_equals_the_cpu(dev, arch):
    """Scaled-down f32 mamba2-1.3b and jamba-v0.1-52b (one 8-layer unit):
    the engine on the card (K1, K3 on jamba's attention layer) and on the
    CPU (their plain versions), dense and paged, clean and with a decode
    fault at ``ssm_out``, give the same greedy streams; the faulted card
    run is retried and ends with the clean card run's state, bit for
    bit."""
    from repro_torch.models.layers import ModelFault

    model = Model(scaled_down(get_config(arch), **SSM_ARCHS[arch]))
    params = model.init_params(3, dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 40, size=5)]
    fault = ModelFault.at(1, "ssm_out", FaultSpec.value(0, 1, 1e5))
    streams, states = {}, {}
    for d in ("cpu", dev):
        for kind, fault_at in (("dense", None), ("paged", None),
                               ("dense", (3, fault))):
            eng = ServeEngine(model, params, slots=2, max_len=64,
                              dtype=torch.float32, device=d,
                              cache_kind=kind, block_size=8,
                              abft=ABFTConfig(flash_attention=True))
            k1 = am.KERNEL.launches
            key = (str(d), kind, fault_at is not None)
            streams[key] = eng.run(
                [Request(uid=i, prompt=p, max_new_tokens=8)
                 for i, p in enumerate(prompts)], fault_at=fault_at)
            assert eng.stats.faults_detected == (fault_at is not None)
            states[key] = [t.cpu() for layer, st in
                           zip(eng.cache, model.state_layers)
                           if st for t in layer.values()]
            if str(d) != "cpu":
                assert am.KERNEL.launches > k1
    assert len({str(s) for s in streams.values()}) == 1
    clean, faulted = states[(str(dev), "dense", False)], \
        states[(str(dev), "dense", True)]
    assert all(torch.equal(a, b) for a, b in zip(clean, faulted))


def test_small_ssm_forward_on_the_card_equals_the_cpu(dev):
    """Scaled-down f32 mamba2-1.3b through ``Model.forward`` (L = 21: a
    padded last chunk): logits on the card within 1e-4 of the CPU's (f32
    sums in another order), equal flags."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    model = Model(scaled_down(get_config("mamba2-1.3b")))
    params = model.init_params(3, dtype=torch.float32)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(1, 256, size=(2, 21)))
    out = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            out[str(d)] = model.forward(tree_map(lambda t: t.to(d), params),
                                        {"tokens": tokens.to(d)},
                                        LayerCtx(), device=d)
    a, b = out["cpu"], out[str(dev)]
    assert (a.logits - b.logits.cpu()).abs().max().item() <= 1e-4
    assert bool(a.flag) == bool(b.flag.cpu())


def test_small_moe_spec_on_the_card_equals_the_cpu(dev):
    """Scaled-down f32 qwen2-moe-a2.7b with n-gram speculation at K = 3
    (the reference's draft_len + 1 window): the card's greedy streams,
    proposals and acceptance equal the CPU's, and K1 ran batched over the
    experts in the verify calls."""
    model = Model(scaled_down(get_config("qwen2-moe-a2.7b")))
    params = model.init_params(3, dtype=torch.float32)
    prompts = [np.tile(3 + np.arange(4 + i % 2, dtype=np.int32), 8)[:19 + i]
               for i in range(3)]
    out = {}
    for d in ("cpu", dev):
        eng = ServeEngine(model, params, slots=2, max_len=64,
                          dtype=torch.float32, device=d,
                          spec_decode="ngram", draft_len=3)
        b = am.BATCHED.launches
        res = eng.run([Request(uid=i, prompt=p, max_new_tokens=8)
                       for i, p in enumerate(prompts)])
        out[str(d)] = (res, eng.stats.draft_proposed,
                       eng.stats.draft_accepted)
        if str(d) != "cpu":
            assert am.BATCHED.launches > b
    assert out["cpu"] == out[str(dev)]
    assert out["cpu"][2] > 0


def _memory_model(arch, seed=3):
    """A scaled-down whisper-tiny or llama-3.2-vision-11b in f32 with its
    memory input (audio frames, image embeddings) and, for vision, the
    cross gates at 0.7 (at their initial 0 the images never reach the
    logits), on the CPU."""
    model = Model(scaled_down(get_config(arch)))
    params = model.init_params(seed, dtype=torch.float32)
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        mem = {"audio": torch.from_numpy(rng.standard_normal(
            (2, 2 * cfg.enc_seq_len, cfg.n_mels)).astype(np.float32))}
    else:
        mem = {"images": torch.from_numpy(rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32))}
        for lp in params["layers"]:
            if "cross_gate" in lp:
                lp["cross_gate"].fill_(0.7)
    tokens = torch.from_numpy(rng.integers(1, 256, size=(2, 19)))
    return model, params, {"tokens": tokens, **mem}


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_small_memory_forward_on_the_card_equals_the_cpu(dev, arch):
    """f32 ``Model.forward`` of the memory path with flash on (whisper's
    encoder on K2 non-causal over its 16 frames, its decoder causal; the
    vision model's cross layer on the plain path, as the reference's):
    logits within 1e-4 of the CPU's (f32 sums in another order), no flag,
    K1 and K2 launched on the card; a prefill of both rows and a decode
    step give the CPU's logits and greedy tokens."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.layers import LayerCtx

    model, params, batch = _memory_model(arch)
    ctx = LayerCtx(abft=ABFTConfig(flash_attention=True))
    mem = {k: v for k, v in batch.items() if k != "tokens"}
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d), params)
        k1, k2 = am.KERNEL.launches, fa.FULL_KERNEL.launches
        with torch.no_grad():
            fwd = model.forward(p, {k: v.to(d) for k, v in batch.items()},
                                ctx, device=d)
            cache = model.init_cache(2, 32, dtype=torch.float32, device=d)
            lg, cache, flag = model.prefill(p, batch["tokens"].to(d), cache,
                                            ctx, inputs=mem)
            tok = lg[:, 0].argmax(-1, keepdim=True)
            lg2, _, flag2 = model.decode(p, tok, cache,
                                         torch.full((2,), 19), ctx)
        out[str(d)] = (fwd, lg.cpu(), tok.cpu(), lg2.cpu())
        assert not bool(fwd.flag) and not bool(flag) and not bool(flag2)
        if str(d) != "cpu":
            assert am.KERNEL.launches > k1 and fa.FULL_KERNEL.launches > k2
    a, b = out["cpu"], out[str(dev)]
    assert (a[0].logits - b[0].logits.cpu()).abs().max().item() <= 1e-4
    assert (a[1] - b[1]).abs().max().item() <= 1e-4
    assert torch.equal(a[2], b[2])
    assert (a[3] - b[3]).abs().max().item() <= 1e-4


def test_f32_conv_stem_on_the_card_is_f32_not_tf32(dev):
    """Whisper's conv stem at its published width (80 mels -> 384, 3000
    frames) in f32 on the card after an engine has set the process's
    flags (``executor.strict_f32``: cuDNN's TF32, on by default, off)
    against the same stem in f64 on the CPU: within 1e-5 of the output's
    scale, f32 rounding over sums of 3 x 384 terms (TF32's 10-bit
    mantissa is off by about 5e-4 there)."""
    from repro_torch.core.tree import tree_map

    torch.backends.cudnn.allow_tf32 = True
    small = Model(scaled_down(get_config("llama3.2-1b")))
    ServeEngine(small, small.init_params(0, dtype=torch.float32), slots=1,
                max_len=16, dtype=torch.float32, device=dev)
    assert torch.backends.cudnn.allow_tf32 is False
    model = Model(get_config("whisper-tiny"))
    gen = torch.Generator().manual_seed(4)
    cs = {"w1": 0.1 * torch.randn(3, 80, 384, generator=gen),
          "b1": 0.1 * torch.randn(384, generator=gen),
          "w2": 0.05 * torch.randn(3, 384, 384, generator=gen),
          "b2": 0.1 * torch.randn(384, generator=gen)}
    audio = torch.randn(2, 3000, 80, generator=gen)
    want = model._conv_stem({"conv_stem": tree_map(lambda t: t.double(), cs)},
                            audio.double())
    got = model._conv_stem({"conv_stem": tree_map(lambda t: t.to(dev), cs)},
                           audio.to(dev))
    assert got.dtype == torch.float32 and got.shape == (2, 1500, 384)
    err = (got.cpu().double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# ---------------------------------------------------------- coverage audit

def _launches():
    return {"K1": am.KERNEL.launches, "K2": fa.FULL_KERNEL.launches,
            "K3": fa.KERNEL.launches}


@pytest.mark.parametrize("flash", [False, True])
def test_audit_records_equal_the_launch_counters(dev, flash):
    """On a llama decode step on the card, the walker's K1/K3 records
    equal the launch counters' increments over the same call: every
    ``ctypes`` launch is in the inventory, flash on and off."""
    from repro_torch.analysis.audit import (
        _audit_abft,
        _zero_params,
        kernel_records,
        trace_decode,
    )

    model = Model(scaled_down(get_config("llama3.2-1b")))
    params = _zero_params(model, torch.float32, dev)
    before = _launches()
    ops_ = trace_decode(model, params, _audit_abft(flash=flash), device=dev)
    torch.cuda.synchronize()
    after = _launches()
    got = kernel_records(ops_)
    assert got == {k: after[k] - before[k] for k in got}
    assert got["K1"] > 0
    assert got["K3"] == (model.cfg.n_layers if flash else 0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-tiny", "llama-3.2-vision-11b"])
def test_scaled_audit_on_the_card_equals_the_cpus(dev, arch):
    """The scaled-down audit (f32, phase mixed, the H100 plan) on the card
    equals the CPU's in every count of its JSON; ``n_ops`` of ``mixed``
    only where the verify step's ``none``/``global`` products run one
    window step at a time on the card (``card_split_ops``)."""
    from repro_torch.analysis.audit import audit_config, card_split_ops

    cpu = audit_config(arch, "mixed", device="cpu")
    card = audit_config(arch, "mixed", device=dev)
    want, got = cpu.to_json(), card.to_json()
    want["phases"]["mixed"]["n_ops"] += card_split_ops(cpu)
    assert got == want
    assert card.protected_fraction == 1.0 and card.crosscheck.bijective


@pytest.mark.parametrize("step", ["chunk", "verify"])
def test_audit_leaves_the_engine_unchanged_on_the_card(dev, step):
    """An engine stepped under the walker on the card ends with the stats,
    cursors and cache cells of the same calls run un-audited."""
    import dataclasses
    import functools

    from repro_torch.analysis.audit import (
        _audit_abft,
        chunk_engine,
        verify_engine,
    )
    from repro_torch.analysis.op_walk import flop_ops

    model = Model(scaled_down(get_config("llama3.2-1b")))
    params = model.init_params(0, dtype=torch.float32, device=dev)
    states = []
    for walk in (True, False):
        if step == "chunk":
            eng, rows = chunk_engine(model, params, _audit_abft(),
                                     device=dev)
            call = functools.partial(eng._run_prefill_chunk, rows, None)
        else:
            eng = verify_engine(model, params, _audit_abft(), device=dev)
            call = eng._verify_core
        if walk:
            assert flop_ops(call)
        else:
            call()
        torch.cuda.synchronize()
        states.append((dataclasses.asdict(eng.stats), eng.pos.tolist(),
                       [{k: v.cpu() for k, v in layer.items()}
                        for layer in eng.cache]))
    (s1, p1, c1), (s2, p2, c2) = states
    assert s1 == s2 and p1 == p2
    for a, b in zip(c1, c2):
        for key in a:
            assert torch.equal(a[key], b[key]), key


# (K, N, f32 out) of llama3.2-1b's GEMMs at TP=2: rank 0's shard of q, the
# kv projections, up/gate, the row-parallel partials of o and down, the
# vocab-sharded head
TP2_SHARDS = [(2048, 1024, False), (2048, 256, False), (1024, 2048, True),
              (2048, 4096, False), (4096, 2048, True), (2048, 64128, True)]


@pytest.mark.parametrize("k,n,f32_out", TP2_SHARDS)
def test_k1_at_the_tp2_shard_shapes(dev, k, n, f32_out):
    """K1 at M = 4 on bf16 operands at a TP=2 shard's shape, the partial
    and the head with f32 out, against its plain version: y within 1e-4
    (f32 out) or 2^-7 (bf16) of max|y|, bounds within 1e-5 relative, no
    false flag."""
    x, w = _k1_inputs(dev, 4, k, n, torch.bfloat16, seed=k + n)
    out = torch.float32 if f32_out else torch.bfloat16
    bm, bk, bn = _blocks(4, k, n)
    y, _, bnd = am.abft_matmul_kernel(x, w, mode="1s", bm=bm, bk=bk,
                                      bn=bn, out_dtype=out)
    yp, _, bndp = abft_matmul_ref(x, w, (0, 0, 0, 0, 0, -1), 0.0,
                                  mode="1s", bm=bm, bk=bk, bn=bn,
                                  out_dtype=out)
    scale = yp.float().abs().max().item()
    tol = (1e-4 if f32_out else 2 ** -7) * scale
    assert y.dtype == out
    assert (y.float() - yp.float()).abs().max().item() <= tol
    assert ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max() <= 1e-5
    _, chk = ops.abft_matmul(x, w, mode="1s", out_dtype=out)
    assert not bool(chk.flag)


def test_tp2_engine_on_the_card_equals_mesh1(dev):
    """Two gloo ranks sharing the card serve a 2-layer llama3.2-1b at its
    full width (bf16, the kernels on, flash decode on) through the mesh
    executor: every rank's greedy streams equal the one-process
    ``mesh=1`` run's."""
    from test_torch_mesh_worker import card_streams

    from repro_torch.distributed import spawn

    want = card_streams(1)
    got = spawn.run(card_streams, 2, 2, device="cuda")
    assert got == [want, want]


# sharded MoE: (E, C, K, N, f32 out) of one rank's expert GEMMs.  EP: the
# rank's E/k experts whole, read at an offset into the replicated
# dispatch buffer; expert-FFN TP: every expert's F sliced, w_up's columns
# (bf16 out) and w_down's rows (the f32 partial)
MOE_SHARDS = {"ep": (8, 4, 512, 1024, False),
              "ep_admission": (8, 40, 512, 1024, False),
              "tp_col": (6, 8, 512, 256, False),
              "tp_row": (6, 8, 256, 512, True)}


@pytest.mark.parametrize("case", sorted(MOE_SHARDS))
def test_k1_batched_at_the_moe_shard_shapes(dev, case):
    """K1 batched over a rank's experts against its plain version: y
    within 2^-7 (bf16) or 1e-4 (f32 out) of max|y|, bounds within 1e-5
    relative, no false flag, one launch.  The EP cases read the upper half
    of a 2E-expert buffer in place, as rank 1's ``moe._experts`` does."""
    from repro_torch.kernels.ref import abft_matmul_batched_ref

    E, C, k, n, f32_out = MOE_SHARDS[case]
    gen = torch.Generator(device=dev).manual_seed(E * C + k)
    lead = 2 * E if case.startswith("ep") else E
    buf = torch.randn(lead, C, k, generator=gen, device=dev).to(
        torch.bfloat16)
    x = buf[lead - E:]
    w = (0.05 * torch.randn(E, k, n, generator=gen, device=dev)).to(
        torch.bfloat16)
    out = torch.float32 if f32_out else torch.bfloat16
    bm, bk, bn = (min(b, -(-d // 8) * 8) for b, d in
                  ((256, C), (512, k), (256, n)))
    kw = dict(mode="1s", bm=bm, bk=bk, bn=bn, out_dtype=out)
    launches = am.BATCHED.launches
    y, _, bnd = am.abft_matmul_kernel(x, w, **kw)
    assert am.BATCHED.launches == launches + 1
    yp, _, bndp = abft_matmul_batched_ref(x.contiguous(), w, **kw)
    scale = yp.float().abs().max().item()
    tol = (1e-4 if f32_out else 2 ** -7) * scale
    assert y.dtype == out and y.shape == (E, C, n)
    assert (y.float() - yp.float()).abs().max().item() <= tol
    assert ((bnd - bndp).abs() / bndp.abs().clamp_min(1e-30)).max() <= 1e-5
    _, chk = ops.abft_matmul_batched(x, w, mode="1s", out_dtype=out)
    assert not bool(chk.flag)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_shard_at_draw_equals_shard_params_on_the_card(dev, arch):
    """``init_params(mesh=)`` on the card, for each rank of a (1, 2) mesh,
    equals ``shard_params`` of the whole tree drawn there, bit for bit."""
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.distributed.mesh import Mesh

    over = {"n_layers": 8} if arch.startswith("jamba") else {}
    model = Model(scaled_down(get_config(arch), **over))
    whole = model.init_params(5, dtype=torch.bfloat16, device=dev)
    for rank in range(2):
        mesh = Mesh(grid=np.arange(2).reshape(1, 2),
                    axis_names=("data", "model"), devices=(dev,) * 2,
                    rank=rank)
        drawn = tree_leaves_with_path(model.init_params(
            5, dtype=torch.bfloat16, device=dev, mesh=mesh))
        cut = tree_leaves_with_path(model.shard_params(whole, mesh))
        assert [p for p, _ in drawn] == [p for p, _ in cut]
        assert all(a.dtype == b.dtype and a.is_cuda and torch.equal(a, b)
                   for (_, a), (_, b) in zip(drawn, cut))
