"""The degradations of the quality grid (``train/degrade.py``) and the codec
host halves they use (``ops/mulaw.py``, ``ops/bfp4.py``) are bit-identical
to the JAX package's for the same inputs and seeds."""

import numpy as np
import pytest

from softspoken_tpu.ops import bfp4 as jbfp4
from softspoken_tpu.ops import mulaw as jmulaw
from softspoken_tpu.train import degrade as jdegrade
from softspoken_tpu_torch.ops import bfp4, mulaw
from softspoken_tpu_torch.train import degrade

ALL_I16 = np.arange(65536, dtype=np.uint16).view(np.int16)


def test_mulaw_host_half_over_every_int16():
    np.testing.assert_array_equal(mulaw.encode_lut(), jmulaw.encode_lut())
    q = mulaw.encode_i16(ALL_I16)
    np.testing.assert_array_equal(q, jmulaw.encode_i16(ALL_I16))
    d = mulaw.decode_host(q)
    np.testing.assert_array_equal(d, jmulaw.decode_host(q))
    assert np.abs(d - ALL_I16 / 32768.0).max() <= mulaw.MAX_ABS_ERROR
    with pytest.raises(TypeError):
        mulaw.encode_i16(ALL_I16.view(np.uint16))


@pytest.mark.parametrize("n", [65536, 1, 300, 65536 - 77])
def test_bfp4_host_half_over_every_int16(n):
    x = np.random.default_rng(n).permutation(ALL_I16)[:n]
    packed, scales = bfp4.encode_i16(x)
    jpacked, jscales = jbfp4.encode_i16(x)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(scales, jscales)
    np.testing.assert_array_equal(bfp4.decode_host(packed, scales, n),
                                  jbfp4.decode_host(packed, scales, n))
    np.testing.assert_array_equal(bfp4.roundtrip_i16(x), jbfp4.roundtrip_i16(x))


def _recording(sr, seconds=3.0, seed=5):
    """Speech-band bursts over a noise floor, peak near 0.8."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.02 * rng.standard_normal(n)
    gate = (np.sin(2 * np.pi * 0.7 * t) > 0.3).astype(np.float64)
    x += 0.6 * gate * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", [32000, 16000])
@pytest.mark.parametrize("kind", jdegrade.DEGRADATIONS)
def test_apply_each_kind_is_bit_identical(kind, sr):
    assert degrade.DEGRADATIONS == jdegrade.DEGRADATIONS
    x = _recording(sr)
    a = degrade.apply(x, sr, [kind], np.random.default_rng(11))
    b = jdegrade.apply(x, sr, [kind], np.random.default_rng(11))
    assert a.dtype == b.dtype == np.float32 and a.shape == x.shape
    np.testing.assert_array_equal(a, b)


def test_apply_composes_like_jax():
    x = _recording(32000, seconds=5.0)
    kinds = ["rolloff4k", "mulaw", "hum", "fading"]
    np.testing.assert_array_equal(
        degrade.apply(x, 32000, kinds, np.random.default_rng(3)),
        jdegrade.apply(x, 32000, kinds, np.random.default_rng(3)))


@pytest.mark.parametrize("rt60", [0.3, 0.8, 1.5])
@pytest.mark.parametrize("sr", [32000, 16000])
def test_image_source_rir_taps_are_bit_identical(rt60, sr):
    a = degrade._image_source_rir(sr, rt60, np.random.default_rng(int(rt60 * 10)))
    b = jdegrade._image_source_rir(sr, rt60, np.random.default_rng(int(rt60 * 10)))
    assert a.dtype == b.dtype == np.float64 and len(a) == int(sr * (rt60 * 1.2 + 0.05))
    np.testing.assert_array_equal(a, b)
