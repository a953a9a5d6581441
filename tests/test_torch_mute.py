"""The port's mute against the JAX package's ``ops/mute.py``: the numpy
functions equal exactly, and the torch twin ``apply_mute_device`` (on the
CPU here) against ``jax_apply_mute`` — zero mode exact, fade within 1e-6
(the tolerance of tests/test_silence.py) — and against the numpy
``apply_mute``.  The twin on the card is in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from softspoken_tpu.ops import mute as jmute
from softspoken_tpu_torch.ops import mute

SR = 16000
N = 40000
CASES = {
    "none": [],
    "one": [(0.5, 1.0)],
    "overlapping": [(0.1, 0.4), (0.3, 0.6), (0.55, 0.58), (1.0, 1.2)],
    "degenerate": [(0.9, 0.2), (0.3, 0.6), (0.5, 0.5)],
    "past_both_ends": [(-1.0, 0.1), (2.4, 99.0), (-5.0, -4.0), (7.0, 8.0)],
    "half_even": [(0.5 / SR, 2.5 / SR), (1.5 / SR, 3.5 / SR)],
    "whole": [(-1.0, 10.0)],
}


def _audio(channels=2, n=N, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, (channels, n)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interval_samples_and_gain_equal(case):
    iv = CASES[case]
    s, e = mute.interval_samples(iv, SR, N)
    js, je = jmute.interval_samples(iv, SR, N)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(e, je)
    assert s.dtype == js.dtype
    for fade in (0, 1, 160):
        g = mute.mute_gain(N, s, e, fade)
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, jmute.mute_gain(N, js, je, fade))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fade", [0, 160])
def test_apply_mute_equal_whole_and_chunked(case, fade):
    iv, x = CASES[case], _audio()
    whole = mute.apply_mute(x, iv, SR, fade_samples=fade)
    np.testing.assert_array_equal(whole, jmute.apply_mute(x, iv, SR, fade_samples=fade))
    parts, jparts = [], []
    for pos in range(0, N, 9999):
        c = x[:, pos:pos + 9999]
        parts.append(mute.apply_mute(c, iv, SR, fade, offset=pos, total_samples=N))
        jparts.append(jmute.apply_mute(c, iv, SR, fade, offset=pos, total_samples=N))
    np.testing.assert_array_equal(np.concatenate(parts, 1), np.concatenate(jparts, 1))
    np.testing.assert_allclose(np.concatenate(parts, 1), whole, atol=1e-7)


def test_apply_mute_mono_and_alias_when_untouched():
    x = _audio(1)[0]
    out = mute.apply_mute(x, [(0.1, 0.2)], SR)
    np.testing.assert_array_equal(out, jmute.apply_mute(x, [(0.1, 0.2)], SR))
    # no interval touches this chunk: the input comes back aliased
    assert mute.apply_mute(x, [(3.0, 3.1)], SR, offset=0, total_samples=10 * N) is x
    assert mute.apply_mute(x, [], SR) is x


def _raw_samples(iv, n=N):
    """Unclipped round-half-even sample indices: the twin clips itself."""
    arr = np.asarray(iv, np.float64).reshape(-1, 2)
    return np.rint(arr[:, 0] * SR).astype(np.int32), np.rint(arr[:, 1] * SR).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fade", [0, 160])
def test_device_twin_on_the_cpu_matches_jax(case, fade):
    iv, x = CASES[case], _audio()
    s, e = _raw_samples(iv)
    got = mute.apply_mute_device(torch.from_numpy(x), torch.from_numpy(s),
                                 torch.from_numpy(e), fade, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(jmute.jax_apply_mute(x, s, e, fade_samples=fade))
    numpy_ref = mute.apply_mute(x, iv, SR, fade_samples=fade)
    if fade == 0:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, numpy_ref)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got, numpy_ref, atol=1e-6, rtol=0)


def test_device_twin_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mute.apply_mute_device(np.zeros((1, 8), np.float32), [1], [2])
