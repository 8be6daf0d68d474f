"""The port's last host modules against hebbax's: the single-level
wavelet transforms (``hebbax_torch/ops/wavelets.py``, equal to the bit
for every filter bank) and the slope timing of a step
(``hebbax_torch/utils/timing.py``, which cancels a fixed fetch cost)."""

import time

import numpy as np
import pytest
import torch

import hebbax.ops.wavelets as jw
import hebbax.utils.timing as jtiming
from hebbax_torch import ops as tops
from hebbax_torch.ops import wavelets as tw
from hebbax_torch.utils import timing as ttiming

FAMILIES = ("haar", "db1", "db2", "db4", "coif1", "bior1.5", "bior2.4",
            "dmey")


@pytest.mark.parametrize("name", FAMILIES)
def test_filters_equal_hebbax(name):
    for got, ref in zip(tw.filters(name), jw.filters(name)):
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
    assert tw.filters(name.upper())[0].shape == jw.filters(name)[0].shape


def test_unknown_wavelet_raises():
    with pytest.raises(ValueError, match="unknown wavelet"):
        tw.filters("sym5")


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("shape", [(17, 12), (8, 31), (3, 5)])
def test_dwt2_bit_equal(name, shape):
    """Odd sizes and a signal shorter than the filter (dmey's 62 taps on
    3 samples: repeated reflection) included."""
    img = np.random.default_rng(sum(shape)).standard_normal(shape)
    got_ll, got_d = tw.dwt2(img, name)
    ref_ll, ref_d = jw.dwt2(img, name)
    np.testing.assert_array_equal(got_ll, ref_ll)
    for g, r in zip(got_d, ref_d):
        np.testing.assert_array_equal(g, r)
    n = (shape[0] + len(tw.filters(name)[0]) - 1) // 2
    assert got_ll.shape[0] == n


@pytest.mark.parametrize("name", ["haar", "db2", "bior2.4", "coif1"])
def test_dwtn3_bit_equal(name):
    vol = np.random.default_rng(5).random((9, 8, 7)).astype(np.float32)
    got, ref = tw.dwtn3(vol, name), jw.dwtn3(vol, name)
    assert sorted(got) == sorted(ref) and len(got) == 8
    for k in ref:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_ops_exports_the_transforms():
    assert tops.dwt2 is tw.dwt2 and tops.dwtn3 is tw.dwtn3


def test_haar_of_a_constant_is_its_scaled_mean():
    ll, (lh, hl, hh) = tw.dwt2(np.full((8, 8), 3.0), "haar")
    np.testing.assert_allclose(ll, 6.0)
    for d in (lh, hl, hh):
        np.testing.assert_allclose(d, 0.0, atol=1e-12)


# -- measure_step ---------------------------------------------------------------

STEP_S, FETCH_S = 0.004, 0.05


def _step(state):
    time.sleep(STEP_S)
    return state + 1, {"loss": torch.full((2,), float(state))}


def _slow_fetch(out, fetched):
    time.sleep(FETCH_S)
    fetched.append(ttiming.fetch(out))


def test_measure_step_slope_cancels_a_fixed_fetch():
    """A step of 4 ms with a 50 ms fetch: the slope between 2 and 8 steps
    is the step's time (within 8 ms: sleeps overrun on a loaded host); a
    plain mean over 2 steps would read ~29 ms.
    hebbax's measure_step gives the same reading of the same step."""
    fetched = []
    got = ttiming.measure_step(_step, 0, n1=2, n2=8, warmup=1,
                               fetch=lambda o: _slow_fetch(o, fetched))
    ref = jtiming.measure_step(_step, 0, n1=2, n2=8, warmup=1,
                               fetch=lambda o: _slow_fetch(o, []))
    assert STEP_S * 0.9 < got < STEP_S + 0.008
    assert STEP_S * 0.9 < ref < STEP_S + 0.008
    # one fetch after the warm-up and one after each run, each of the
    # last step's output (the state threads through 1 + 2 + 8 calls)
    assert fetched == [0.0, 4.0, 20.0]


def test_default_fetch_reads_the_first_tensor():
    assert ttiming.fetch({"a": [torch.ones(3)], "b": torch.zeros(1)}) == 3.0
    assert ttiming.fetch((torch.full((2, 2), 0.5),)) == 2.0
    with pytest.raises(ValueError, match="no tensor"):
        ttiming.fetch({"a": 1.0})


def test_measure_step_rejects_an_empty_slope():
    with pytest.raises(ValueError):
        ttiming.measure_step(_step, 0, n1=3, n2=3)
