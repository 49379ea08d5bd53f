"""``protected_matmul``'s plain products and K1's gradient.

A bf16 GEMM with an f32 output (the bf16 model's tied head) under the
``global`` and ``none`` schemes returns the f32 accumulator, as the
reference's ``preferred_element_type=f32`` does, and the ``global``
threshold is the reference's ``global_row_check`` threshold.  Tolerances:
y within 1e-5 relative of max|y| (f32 sums in another order; one bf16
rounding would be 2^-8 relative), thresholds within 1e-6 relative (the
same f32 magnitude sums).

K1's autograd wrapper (the plain version on the CPU) gives the gradients
of a plain ``x @ w`` within 1e-5 relative (f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import FixedPolicy as JFixed
from repro.core.protected import ABFTConfig as JABFT, protected_matmul as jpm
from repro.core.schemes import Scheme as JScheme
from repro_torch.core.policy import FixedPolicy
from repro_torch.core.protected import ABFTConfig, protected_matmul
from repro_torch.core.schemes import Scheme
from repro_torch.kernels import ops

torch.set_num_threads(1)


def _bf16_head_case(seed=0, m=8, k=512, n=1024):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.02 * rng.standard_normal((k, n))).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    wj = jnp.asarray(w, jnp.bfloat16)
    # the same bf16 values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).bfloat16()
    return xj, wj, xt, wt


@pytest.mark.parametrize("scheme", ["global", "none"])
def test_bf16_gemm_with_f32_output_keeps_the_accumulator(scheme):
    xj, wj, xt, wt = _bf16_head_case()
    yj, cj = jpm(xj, wj, JABFT.from_policy(JFixed(JScheme(scheme))),
                 out_dtype=jnp.float32)
    yt, ct = protected_matmul(xt, wt, ABFTConfig.from_policy(
        FixedPolicy(Scheme(scheme))), out_dtype=torch.float32)
    assert yt.dtype == torch.float32
    yj = np.asarray(yj)
    scale = np.abs(yj).max()
    assert np.abs(yt.numpy() - yj).max() <= 1e-5 * scale
    assert bool(ct.flag) is False and bool(cj.flag) is False
    if scheme == "global":
        np.testing.assert_allclose(ct.threshold.numpy(),
                                   np.asarray(cj.threshold), rtol=1e-6)
        assert (ct.residual.numpy() <= ct.threshold.numpy()).all()


@pytest.mark.parametrize("tied", [False, True], ids=["w", "embed_T"])
def test_k1_gradient_is_the_plain_product_gradient(tied):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 20, 48)).astype(np.float32))
    if tied:
        emb = torch.from_numpy(rng.standard_normal((72, 48)).astype(
            np.float32)).requires_grad_()
        w = emb.t()
    else:
        emb = None
        w = torch.from_numpy(rng.standard_normal((48, 72)).astype(
            np.float32)).requires_grad_()
    x.requires_grad_()
    gy = torch.from_numpy(rng.standard_normal((2, 20, 72)).astype(
        np.float32))
    y, chk = ops.abft_matmul(x, w, mode="1s", out_dtype=torch.float32)
    assert not chk.residual.requires_grad and not bool(chk.flag)
    gx, gw = torch.autograd.grad(y, (x, emb if tied else w), gy)
    ref = x.detach() @ (w.detach())
    torch.testing.assert_close(y.detach(), ref, rtol=1e-5, atol=1e-5)
    xd, wd = x.detach(), w.detach()
    rx, rw = torch.autograd.grad(
        (xd.requires_grad_() @ wd.requires_grad_()), (xd, wd), gy)
    torch.testing.assert_close(gx, rx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gw, rw.t() if tied else rw, rtol=1e-5,
                               atol=1e-5)
    if tied:
        assert gw.is_contiguous()      # embed's own layout, no transpose copy
