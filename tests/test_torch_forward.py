"""Full-sequence forward parity: the port's ``Model.forward`` against the
reference's on scaled-down llama3.2-1b (2 layers, f32, the reference's
own parameters converted through numpy), with fused-ABFT flash attention
(K2) off and on, clean and with an ``attn_out`` fault.

The reference runs K2 in interpret mode and its block schemes through
the XLA emulation (``use_pallas=False``), or, for a faulted run, through
K1 in interpret mode; the port runs the K1 and K2 plain versions.
Tolerance: logits within 1e-4 absolute and relative (f32, sums in another
order).  Flags must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core import FaultSpec as JFault
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, ModelFault as JMF, build_model
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.faults import FaultSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import LayerCtx, ModelFault
from repro_torch.models.model import Model, params_from_reference

torch.set_num_threads(1)

B, L = 2, 24


@pytest.fixture(scope="module")
def models():
    jcfg = jscaled(jget("llama3.2-1b"), n_layers=2)
    jm = build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    cfg = scaled_down(get_config("llama3.2-1b"), n_layers=2)
    tp = params_from_reference(cfg, jax.tree_util.tree_map(np.asarray, jp))
    toks = np.random.default_rng(3).integers(1, 256, size=(B, L)).astype(
        np.int32)
    return jm, jp, Model(cfg), tp, toks


def _forward(models, flash, fault):
    jm, jp, tm, tp, toks = models
    # a faulted run compares with the reference's Pallas K1 (interpret
    # mode): its emulation corrupts (row, col) in every batch row, the
    # kernel (and the port) flattened row ``row`` only
    jctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=fault,
                                       hardware=JTPU, flash_attention=flash),
                fault=JMF.at(1, "attn_out", JFault.value(0, 2, 1e4))
                if fault else None)
    tctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                                hardware=TPU_V5E,
                                                flash_attention=flash),
                    fault=ModelFault.at(1, "attn_out",
                                        FaultSpec.value(0, 2, 1e4))
                    if fault else None)
    # the reference jitted (its op-by-op run takes several times longer)
    jo = jax.jit(lambda p, b: jm.forward(p, b, jctx))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        to = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, tctx,
                        device="cpu")
    return jo, to


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "attn_out"])
@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "flash"])
def test_forward_logits_and_flag_match_reference(models, flash, fault):
    before = fa.FULL_KERNEL.launches
    jo, to = _forward(models, flash, fault)
    assert to.logits.shape == (B, L, 256) and to.logits.dtype == torch.float32
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               atol=1e-4, rtol=1e-4)
    assert bool(to.flag) == bool(jo.flag) == fault
    assert float(to.aux_loss) == float(jo.aux_loss) == 0.0
    # the CPU run takes the plain version: no kernel launch is counted
    assert fa.FULL_KERNEL.launches == before


def test_flash_and_chunked_forward_agree(models):
    _, a = _forward(models, False, False)
    _, b = _forward(models, True, False)
    np.testing.assert_allclose(a.logits.numpy(), b.logits.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_forward_needs_cuda_or_an_explicit_cpu(models, monkeypatch):
    _, _, tm, tp, toks = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.forward(tp, {"tokens": torch.from_numpy(toks)}, LayerCtx())


def test_unported_inputs_raise(models):
    """An input the model does not read (encoder frames to llama) is
    refused, not ignored."""
    _, _, tm, tp, toks = models
    batch = {"tokens": torch.from_numpy(toks),
             "enc_input": torch.zeros(B, 4, 64)}
    with pytest.raises(ValueError, match="enc_input"):
        tm.forward(tp, batch, LayerCtx(), device="cpu")


def test_forward_equals_prefill_logits(models):
    """The last position of the full forward is the prefill's logits."""
    _, _, tm, tp, toks = models
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        full = tm.forward(tp, {"tokens": t}, LayerCtx(), device="cpu")
        cache = tm.init_cache(B, L, dtype=torch.float32)
        last, _, _ = tm.prefill(tp, t, cache, LayerCtx())
    np.testing.assert_allclose(full.logits[:, -1:].numpy(), last.numpy(),
                               atol=1e-5, rtol=1e-5)
