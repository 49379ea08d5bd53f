"""K3 (fused-ABFT flash decode): the port's plain version, through its
wrappers ``flash_decode`` / ``flash_decode_paged``, against the reference
wrappers running the Pallas kernels in interpret mode.  GQA grouping,
ragged lengths, a permuted block table with sentinel tails, and alien
data in every slot past a row's length.

Tolerances: outputs within 1e-5 (f32 online softmax, same block
partition); bounds within 1e-5 relative; thresholds within 1e-5
relative.  Residuals are f32 rounding noise and are checked against the
threshold, not element-wise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_ops as jfo
from repro_torch.kernels import flash_ops
from repro_torch.kernels.flash_attention import (
    flash_decode_kernel,
    flash_decode_ref,
)

torch.set_num_threads(1)


def _paged_case(seed, B=3, KV=2, G=2, D=16, BS=8, W=5):
    rng = np.random.default_rng(seed)
    NB = B * W + 3
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    # alien data everywhere: slots past a row's length hold large garbage
    kp = (5 * rng.standard_normal((NB, BS, KV, D))).astype(np.float32)
    vp = (5 * rng.standard_normal((NB, BS, KV, D))).astype(np.float32)
    table = rng.permutation(NB)[:B * W].reshape(B, W).astype(np.int32)
    lengths = np.array([1, 20, 40][:B], np.int32)
    table[0, 1:] = NB                              # sentinel tail
    return q, kp, vp, table, lengths


def _close(cj, ct):
    np.testing.assert_allclose(ct.threshold.numpy(),
                               np.asarray(cj.threshold), rtol=1e-5)
    assert bool(cj.flag) == bool(ct.flag)
    assert (ct.residual.numpy() <= ct.threshold.numpy()).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_plain_version_matches_reference(seed):
    q, kp, vp, table, lengths = _paged_case(seed)
    oj, cj = jfo.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(table),
                                    jnp.asarray(lengths))
    ot, ct = flash_ops.flash_decode_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    _close(cj, ct)


@pytest.mark.parametrize("S", [37, 64, 200])
def test_dense_plain_version_matches_reference(S):
    rng = np.random.default_rng(S)
    B, KV, G, D = 3, 2, 2, 16
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    vc = (5 * rng.standard_normal((B, S, KV, D))).astype(np.float32)
    lengths = np.array([1, S // 2, S], np.int32)
    oj, cj = jfo.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(lengths))
    ot, ct = flash_ops.flash_decode(torch.from_numpy(q),
                                    torch.from_numpy(kc),
                                    torch.from_numpy(vc),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    _close(cj, ct)


def test_alien_data_past_length_changes_nothing():
    """Rewriting every invalid slot changes neither the output nor the
    check vectors (both score-check sides are masked to < length)."""
    q, kp, vp, table, lengths = _paged_case(7)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    a = flash_decode_ref(*args, block=kp.shape[1])
    kp2, vp2 = kp.copy(), vp.copy()
    BS = kp.shape[1]
    for b in range(table.shape[0]):
        for j in range(table.shape[1]):
            blk = table[b, j]
            if blk >= kp.shape[0]:
                continue
            for t in range(BS):
                if j * BS + t >= lengths[b]:
                    kp2[blk, t] = 1e3
                    vp2[blk, t] = -1e3
    owned = set(table[table < kp.shape[0]].tolist())
    for blk in set(range(kp.shape[0])) - owned:
        kp2[blk], vp2[blk] = 7e2, 7e2
    args[1], args[2] = torch.from_numpy(kp2), torch.from_numpy(vp2)
    bsum = flash_decode_ref(*args, block=BS)
    for u, v in zip(a, bsum):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_dense_reads_cache_without_repeat_or_pad():
    """GQA grouping: all query heads of one kv head see the same keys;
    the dense wrapper passes the cache itself (no copy) to the kernel."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(
        np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 13, 2, 8)).astype(
        np.float32))
    seen = {}

    def spy(q_, k_, v_, table, lengths, *, block, scale=None):
        seen["k"], seen["block"] = k_, block
        return flash_decode_ref(q_, k_, v_, table, lengths, block=block)

    orig = flash_ops.flash_decode_ref
    flash_ops.flash_decode_ref = spy
    try:
        flash_ops.flash_decode(q, kc, kc, 5)
    finally:
        flash_ops.flash_decode_ref = orig
    assert seen["k"] is kc and seen["block"] == 16


def test_kernel_wrapper_never_falls_back_for_cpu_tensors():
    q, kp, vp, table, lengths = _paged_case(4)
    with pytest.raises(ValueError):
        flash_decode_kernel(*(torch.from_numpy(a) for a in
                              (q, kp, vp, table, lengths)), block=8)
