"""K2 (fused-ABFT flash attention over a full sequence): the port's plain
version, through its wrapper ``flash_ops.flash_attention``, against the
reference wrapper running the Pallas kernel in interpret mode, and the
per-row check arrays against the reference kernel on single heads.

Tolerances (f32): outputs within 1e-5 (online softmax over the same block
partition, sums in another order); bounds and thresholds within 1e-5
relative (sums of magnitudes, order only).  Clean residuals are f32
rounding noise (~1e-6 here): the two agree within 1e-4 absolute and
neither raises a flag.  A faulted residual is the fault's delta (50) and
agrees within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import FaultSpec as JFault
from repro.kernels.flash_attention import flash_attention_kernel as jkernel
from repro.kernels import flash_ops as jfo
from repro_torch.core.faults import FaultSpec
from repro_torch.kernels import flash_ops
from repro_torch.kernels.flash_attention import f32_bits, flash_attention_ref

torch.set_num_threads(1)

BQ = BK = 32


def _case(seed, L, H, KV, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, L, H, D)).astype(np.float32)
    k = rng.standard_normal((2, L, KV, D)).astype(np.float32)
    v = (3 * rng.standard_normal((2, L, KV, D))).astype(np.float32)
    return q, k, v


def _both(q, k, v, causal, fault=None):
    oj, cj = jfo.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=BQ, bk=BK, fault=None if fault is None else JFault.value(*fault))
    ot, ct = flash_ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, bq=BQ, bk=BK,
        fault=None if fault is None else FaultSpec.value(*fault))
    return (np.asarray(oj), cj), (ot.numpy(), ct)


HEADS = [(4, 2), (2, 2)]          # GQA and MHA
CASES = [(L, True) for L in (7, 40, 64, 96)] + [(L, False) for L in (64, 96)]


@pytest.mark.parametrize("heads", HEADS, ids=["gqa", "mha"])
@pytest.mark.parametrize("L,causal", CASES)
def test_plain_version_matches_reference(L, causal, heads):
    q, k, v = _case(L, L, *heads)
    (oj, cj), (ot, ct) = _both(q, k, v, causal)
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)
    tau_t, tau_j = ct.threshold.numpy(), np.asarray(cj.threshold)
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-5)
    res_t, res_j = ct.residual.numpy(), np.asarray(cj.residual)
    np.testing.assert_allclose(res_t, res_j, rtol=0, atol=1e-4)
    assert bool(cj.flag) is False and bool(ct.flag) is False


@pytest.mark.parametrize("L,causal", [(40, True), (96, True), (64, False)])
def test_per_row_check_arrays_match_reference_kernel(L, causal):
    """bnd_s and bnd_pv row by row, every (batch, head) program, against
    the Pallas kernel run on each zero-padded, kv-repeated head."""
    H, KV, D = 4, 2, 16
    q, k, v = _case(3, L, H, KV, D)
    bq, bk = min(BQ, -(-L // 8) * 8), min(BK, -(-L // 8) * 8)
    lq, lk = -(-L // bq) * bq, -(-L // bk) * bk
    fi = (0, 0, 0, 0, 0, 0)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), fi, bq=bq, bk=bk,
                              causal=causal, lq_pad=lq, lk_pad=lk)
    G = H // KV
    qh = np.pad(q, ((0, 0), (0, lq - L), (0, 0), (0, 0)))
    kh = np.pad(np.repeat(k, G, axis=2), ((0, 0), (0, lk - L), (0, 0), (0, 0)))
    vh = np.pad(np.repeat(v, G, axis=2), ((0, 0), (0, lk - L), (0, 0), (0, 0)))

    def flat(a):          # (B, L, H, D) -> (B*H, L, D)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, *a.shape[1::2]))

    o, rs, bs, rp, bp = jax.vmap(lambda a, b_, c: jkernel(
        a, b_, c, jnp.zeros((6,), jnp.int32), bq=bq, bk=bk,
        causal=causal))(flat(qh), flat(kh), flat(vh))
    o = np.asarray(o).reshape(2, H, lq, D).transpose(0, 2, 1, 3)[:, :L]
    np.testing.assert_allclose(got[0].numpy(), o, rtol=1e-5, atol=1e-5)
    for mine, theirs in ((got[2], bs), (got[4], bp)):
        np.testing.assert_allclose(mine.numpy(),
                                   np.asarray(theirs).reshape(mine.shape),
                                   rtol=1e-5)


@pytest.mark.parametrize("heads", HEADS, ids=["gqa", "mha"])
def test_fault_flagged_in_both_at_the_same_q_block(heads):
    L, row, col, delta = 96, 37, 3, 50.0
    q, k, v = _case(5, L, *heads)
    (oj, cj), (ot, ct) = _both(q, k, v, True, fault=(row, col, delta))
    assert bool(cj.flag) is True and bool(ct.flag) is True
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ct.residual.numpy()[1],
                               np.asarray(cj.residual)[1], rtol=1e-4)
    # the per-row PV residual peaks at the faulted row of q block 1, in
    # every (batch, head) program
    fi = (row // BQ, 0, row % BQ, col, 1, f32_bits(delta))
    _, _, _, rp, _ = flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), fi,
        bq=BQ, bk=BK, causal=True, lq_pad=L, lk_pad=L)
    flat = rp.reshape(rp.shape[0], rp.shape[1], -1)
    assert (flat.argmax(-1) == row).all()
    assert row // BQ == 1


def test_noncausal_padding_raises_in_both():
    q, k, v = _case(7, 40, 4, 2)
    with pytest.raises(AssertionError):
        jfo.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, bq=BQ, bk=BK)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False, bq=BQ,
                                  bk=BK)


def test_flash_attention_refuses_autograd():
    q, k, v = (torch.from_numpy(a) for a in _case(8, 16, 4, 2))
    q.requires_grad_()
    with pytest.raises(NotImplementedError):
        flash_ops.flash_attention(q, k, v)
    with torch.no_grad():
        out, chk = flash_ops.flash_attention(q, k, v)
    assert out.shape == (2, 16, 4, 16) and not bool(chk.flag)


def test_fault_bits_round_trip():
    for x in (0.0, 1e4, -3.25, 1e-30):
        bits = f32_bits(x)
        back = torch.tensor(bits, dtype=torch.int32).view(torch.float32)
        assert back.item() == np.float32(x)


def test_tensor_core_route_terms():
    """K2's bf16 tensor-core kernel takes 16-byte-aligned rows (strided
    views of a fused projection included); f32, odd head dims, key blocks
    that are not multiples of 8 and misaligned bases take the CUDA-core
    kernel."""
    from repro_torch.kernels.flash_attention import tc_path

    bf = torch.bfloat16
    B, L, H, KV, D = 2, 64, 8, 2, 64
    q, k, v = (torch.zeros(B, L, n, D, dtype=bf) for n in (H, KV, KV))
    assert tc_path(q, k, v, 64)
    assert not tc_path(q.float(), k.float(), v.float(), 64)
    assert not tc_path(q, k, v, 60)
    q60, k60, v60 = (torch.zeros(B, L, n, 60, dtype=bf) for n in (H, KV, KV))
    assert not tc_path(q60, k60, v60, 64)
    fused = torch.zeros(B, L, (H + 2 * KV) * D, dtype=bf)
    qs = fused[..., :H * D].view(B, L, H, D)
    ks = fused[..., H * D:(H + KV) * D].view(B, L, KV, D)
    vs = fused[..., (H + KV) * D:].view(B, L, KV, D)
    assert not qs.is_contiguous() and tc_path(qs, ks, vs, 64)
    off = torch.zeros(q.numel() + 1, dtype=bf)[1:].view(q.shape)
    assert not tc_path(off, k, v, 64)
