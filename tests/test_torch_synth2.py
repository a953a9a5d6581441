"""The out-of-family eval generator (``train/synth2.py``) is bit-identical
to the JAX package's for the same seeds: samples and labels."""

import numpy as np
import pytest

from softspoken_tpu.train import synth2 as jsynth2
from softspoken_tpu_torch.train import synth2


@pytest.mark.parametrize("seed,seconds", [(0, 2.0), (1, 4.5), (2, 0.4)])
def test_speech2_is_bit_identical(seed, seconds):
    n = int(seconds * synth2.SR)
    a, sa = synth2.speech2(np.random.default_rng(seed), n)
    b, sb = jsynth2.speech2(np.random.default_rng(seed), n)
    assert a.dtype == b.dtype == np.float32 and a.shape == (n,)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


@pytest.mark.parametrize("kind", list(jsynth2.TEXTURES2) + [None])
def test_texture2_is_bit_identical(kind):
    assert synth2.TEXTURES2 == jsynth2.TEXTURES2
    n = int(3.0 * synth2.SR)
    a = synth2.texture2(np.random.default_rng(21), n, kind)
    b = jsynth2.texture2(np.random.default_rng(21), n, kind)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,seconds,sr", [(7000, 8.0, 32000), (3, 6.0, 22050),
                                             (4, 10.0, 32000)])
def test_field_recording2_is_bit_identical(seed, seconds, sr):
    a, la = synth2.field_recording2(np.random.default_rng(seed), seconds, sr=sr)
    b, lb = jsynth2.field_recording2(np.random.default_rng(seed), seconds, sr=sr)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert la == lb and la


def test_field_recording2_options_are_bit_identical():
    kw = dict(sr=32000, speech_events=(3, 3), snr_db=(5.0, 5.0))
    a, la = synth2.field_recording2(np.random.default_rng(8), 12.0, **kw)
    b, lb = jsynth2.field_recording2(np.random.default_rng(8), 12.0, **kw)
    np.testing.assert_array_equal(a, b)
    assert la == lb
