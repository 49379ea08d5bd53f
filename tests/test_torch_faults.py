"""Fault-campaign primitives of the port against the reference:
``exponent_bit_range``, ``random_fault`` and ``FaultModel``.  Both draw
through ``numpy.random.default_rng(seed)`` in the same order, so every
comparison here is EXACT (no tolerance): the same seed gives the same
bits, rows, columns, deltas and schedules record for record."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faults import (
    FaultModel as JFaultModel,
    exponent_bit_range as jbits,
    random_fault as jrandom_fault,
)
from repro_torch.core.faults import (
    FaultModel,
    exponent_bit_range,
    random_fault,
)
from repro_torch.models.layers import SITES

torch.set_num_threads(1)

# (torch dtype, reference dtype, numpy dtype or name)
DTYPES = [(torch.bfloat16, jnp.bfloat16, "bfloat16"),
          (torch.float32, np.float32, np.float32),
          (torch.float16, np.float16, np.float16)]


@pytest.mark.parametrize("tdt,jdt,ndt", DTYPES)
def test_exponent_bit_range_matches_reference(tdt, jdt, ndt):
    want = jbits(jdt)
    assert exponent_bit_range(tdt) == want
    assert exponent_bit_range(ndt) == want
    assert exponent_bit_range(jdt) == want


@pytest.mark.parametrize("dt", [torch.int32, np.int32, "int8"])
def test_exponent_bit_range_rejects_non_float(dt):
    with pytest.raises(ValueError):
        exponent_bit_range(dt)


@pytest.mark.parametrize("magnitude", [None, 1e4, 0.3])
@pytest.mark.parametrize("tdt,jdt,_", DTYPES)
def test_random_fault_matches_reference(magnitude, tdt, jdt, _):
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(40):
        got = random_fault(ra, 4, 32, magnitude=magnitude, dtype=tdt)
        ref = jrandom_fault(rb, 4, 32, magnitude=magnitude, dtype=jdt)
        assert (got.row, got.col, got.bit, got.enabled) == (
            int(ref.row), int(ref.col), int(ref.bit), int(ref.enabled))
        # the port keeps the Python delta; the kernels take it as f32
        assert np.float32(got.delta) == np.float32(ref.delta)


def _poll_both(kw, tdt, jdt, n=60, clear_at=None, reset_at=None):
    a, b = FaultModel(dtype=tdt, **kw), JFaultModel(dtype=jdt, **kw)
    for i in range(n):
        if i == clear_at:
            a.clear_sticky()
            b.clear_sticky()
        if i == reset_at:
            a.reset()
            b.reset()
        fa, fb = a.poll(), b.poll()
        assert (fa is None) == (fb is None)
        if fa is not None:
            assert fa.describe() == fb.describe()
            mf = fa.model_fault
            assert (mf.layer, mf.site) == (fa.layer, SITES[fa.site])
            assert (mf.spec.row, mf.spec.col, mf.spec.bit) == (
                fa.row, fa.col, fa.bit)
    return a, b


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("rates", [(0.3, 0.0), (0.0, 0.2), (0.4, 0.1),
                                   (1.0, 1.0)])
@pytest.mark.parametrize("duration", [1, 4, None])
@pytest.mark.parametrize("dt", [0, 1], ids=["bf16", "f32"])
def test_fault_model_schedule_matches_reference(seed, rates, duration, dt):
    tdt, jdt, _ = DTYPES[dt]
    kw = dict(transient_rate=rates[0], permanent_rate=rates[1],
              permanent_duration=duration, seed=seed, layers=3)
    a, b = _poll_both(kw, tdt, jdt)
    assert a.schedule == b.schedule
    assert a.step == b.step


@pytest.mark.parametrize("magnitude", [None, 1e4])
def test_fault_model_clear_sticky_and_reset_match_reference(magnitude):
    kw = dict(transient_rate=0.3, permanent_rate=0.2, permanent_duration=50,
              seed=5, layers=16, magnitude=magnitude, rows=4, cols=64,
              sites=("qkv", "mlp_down"))
    a, b = _poll_both(kw, torch.float32, np.float32, n=80, clear_at=10,
                      reset_at=40)
    assert a.schedule == b.schedule and a.schedule


def test_fault_model_validation_matches_reference():
    for bad in (dict(transient_rate=1.5), dict(permanent_rate=-0.1),
                dict(permanent_duration=0)):
        with pytest.raises(ValueError):
            JFaultModel(**bad)
        with pytest.raises(ValueError):
            FaultModel(**bad)
