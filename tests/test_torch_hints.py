"""``hints=`` on the port: ``ShardingHints.dp_size`` sets the MoE
dispatch's group count (``models/moe.py``), the whole of what the hints
change in a layer's numbers.  The port's ``moe_forward`` under
``ShardingHints(dp_size=4)`` against the reference's, jitted inside a
one-device ``("data", "model")`` mesh (``jax.set_mesh``) so that its
``constrain`` runs; f32
on the CPU, y within 1e-5 absolute and relative and the aux loss within
1e-6 relative (``tests/test_torch_moe.py``'s tolerances).  At
``capacity_factor=1.0`` the grouped dispatch drops other tokens than one
group does, so the grouped output must differ from the ungrouped one by
far more than that tolerance; a group count that does not divide the
token count falls back to one group, as the reference's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget, scaled_down as jscaled
from repro.core.hardware import TPU_V5E as JTPU
from repro.core.policy import IntensityGuidedPolicy as JGuided
from repro.core.protected import ABFTConfig as JABFT
from repro.models import LayerCtx as JCtx, moe as jmoe
from repro.models.layers import ShardingHints as JHints
from repro_torch.configs import get_config, scaled_down
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.policy import IntensityGuidedPolicy
from repro_torch.core.protected import ABFTConfig
from repro_torch.models import moe
from repro_torch.models.layers import LayerCtx, ShardingHints

torch.set_num_threads(1)

B, L = 4, 12


@pytest.fixture(scope="module")
def setup():
    over = dict(capacity_factor=1.0)
    jcfg = jscaled(jget("qwen2-moe-a2.7b"), **over)
    tcfg = scaled_down(get_config("qwen2-moe-a2.7b"), **over)
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(9).standard_normal((B, L, 64)).astype(
        np.float32)
    return jcfg, tcfg, p, tp, x


def _ref(jcfg, p, x, dp_size):
    ctx = JCtx(abft=JABFT.from_policy(JGuided(), use_pallas=False,
                                      hardware=JTPU),
               hints=JHints(dp=("data",), dp_size=dp_size))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with jax.set_mesh(mesh):
        y, f, a = jax.jit(lambda x, p: jmoe.moe_forward(
            x, p, jcfg, ctx))(jnp.asarray(x), p)
    return np.asarray(y), bool(f), float(a)


def _port(tcfg, tp, x, hints):
    ctx = LayerCtx(abft=ABFTConfig.from_policy(IntensityGuidedPolicy(),
                                               hardware=TPU_V5E),
                   hints=hints)
    with torch.no_grad():
        y, f, a = moe.moe_forward(torch.from_numpy(x), tp, tcfg, ctx)
    return y.numpy(), bool(f), float(a)


@pytest.mark.parametrize("dp_size", [4, 5])
def test_moe_hints_match_reference(setup, dp_size):
    jcfg, tcfg, p, tp, x = setup
    jy, jf, ja = _ref(jcfg, p, x, dp_size)
    ty, tf, ta = _port(tcfg, tp, x, ShardingHints(dp_size=dp_size))
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    assert tf == jf is False


def test_grouping_changes_the_output(setup):
    jcfg, tcfg, p, tp, x = setup
    grouped, _, _ = _port(tcfg, tp, x, ShardingHints(dp_size=4))
    single, _, _ = _port(tcfg, tp, x, None)
    fallback, _, _ = _port(tcfg, tp, x, ShardingHints(dp_size=5))
    # ten times the parity test's 1e-5: the test tells grouping apart
    assert np.abs(grouped - single).max() > 1e-4
    np.testing.assert_array_equal(fallback, single)
    assert moe.capacity(tcfg, B * L // 4) * 4 != moe.capacity(tcfg, B * L)
    assert dataclasses.asdict(ShardingHints()) == {
        "dp": ("data",), "dp_size": 1, "ep": ("model",), "tp": "model",
        "moe_mode": "ep"}
