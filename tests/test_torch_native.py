"""The port's native host DSP (``softspoken_tpu_torch/io/native.py`` over its
copy of ``csrc/ssdsp.cpp``, built by ``ops/_build.build_host``) against the
JAX package's ``io/native.py``: bit-equal on the same arrays, within the
JAX ``tests/test_native.py`` tolerances of scipy, and scipy's exact result
when native code is disabled."""

import math
import os

import numpy as np
import pytest
import scipy.signal

from softspoken_tpu.io import native as jnative
from softspoken_tpu.io.resample import resample as jresample
from softspoken_tpu_torch.io import native
from softspoken_tpu_torch.io.resample import design_taps, resample
from softspoken_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _toolchain():
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("no g++: neither package can build its native library")


@pytest.mark.parametrize("name", ["ssdsp.cpp", "ssflac.cpp"])
def test_csrc_copies_are_byte_equal(name):
    with open(os.path.join(ROOT, "csrc", name), "rb") as a, \
            open(os.path.join(ROOT, "softspoken_tpu_torch", "csrc", name), "rb") as b:
        assert a.read() == b.read()


def test_libraries_build_into_the_checkout_under_a_hashed_name():
    for name in ("ssdsp", "ssflac"):
        path = _build.build_host(name)
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert os.path.basename(path).startswith(name + "-")
        assert path.endswith(f"-{_build.host_isa_tag()}.so") and os.path.exists(path)
    assert _build.BUILD_DIR.startswith(ROOT)


@pytest.mark.parametrize("orig,target", [(32000, 22050), (48000, 22050),
                                         (22050, 16000), (44100, 22050)])
def test_resample_is_bit_equal_to_jax_and_near_scipy(orig, target):
    x = np.random.default_rng(0).normal(0, 0.3, 32000 * 2).astype(np.float32)
    g = math.gcd(orig, target)
    up, down = target // g, orig // g
    taps = design_taps(up, down)
    got = native.resample_f32(x, up, down, taps)
    np.testing.assert_array_equal(got, jnative.resample_f32(x, up, down, taps))
    want = scipy.signal.resample_poly(x.astype(np.float64), up, down,
                                      window=taps).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)
    # the host resampler takes the native path for 1-D input, as JAX's does
    np.testing.assert_array_equal(resample(x, orig, target), got)
    np.testing.assert_array_equal(resample(x, orig, target), jresample(x, orig, target))


def test_resample_short_taps_read_no_further_than_the_taps():
    x = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    taps = np.asarray([0.25, 0.5, 0.25], np.float64)  # far fewer taps than up
    got = native.resample_f32(x, 16, 5, taps)
    np.testing.assert_array_equal(got, jnative.resample_f32(x, 16, 5, taps))
    want = scipy.signal.resample_poly(x.astype(np.float64), 16, 5, window=taps)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=2e-6)


@pytest.mark.parametrize("channels", [2, 3, 6])
def test_downmix_is_bit_equal_to_jax(channels):
    x = np.random.default_rng(1).normal(0, 0.5, (100_000, channels)).astype(np.float32)
    got = native.downmix_f32(x)
    np.testing.assert_array_equal(got, jnative.downmix_f32(x))
    np.testing.assert_allclose(got, x.mean(axis=1), atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_pcm16_to_mono_is_bit_equal_to_jax(channels):
    raw = np.random.default_rng(2).integers(-32768, 32767, size=50_000 * channels,
                                            dtype=np.int16)
    got = native.pcm16_to_mono_f32(raw, channels)
    np.testing.assert_array_equal(got, jnative.pcm16_to_mono_f32(raw, channels))
    want = (raw.reshape(-1, channels).astype(np.float64) / 32768.0).mean(axis=1)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-6)


def test_calls_are_counted():
    native.reset_call_counts()
    x = np.zeros((1000, 2), np.float32)
    native.downmix_f32(x)
    native.pcm16_to_mono_f32(np.zeros(2000, np.int16), 2)
    resample(x[:, 0], 32000, 22050)
    assert dict(native.NATIVE_CALLS) == {
        "downmix_f32": 1, "pcm16_to_mono_f32": 1, "resample_f32": 1}


def test_disabled_native_gives_scipys_result(monkeypatch):
    x = np.random.default_rng(3).normal(0, 0.3, 20_000).astype(np.float32)
    monkeypatch.setenv("SOFTSPOKEN_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.native_available()
    assert native.resample_f32(x, 441, 640, design_taps(441, 640)) is None
    assert native.downmix_f32(np.zeros((4, 2), np.float32)) is None
    want = scipy.signal.resample_poly(x.astype(np.float64), 441, 640,
                                      window=design_taps(441, 640)).astype(np.float32)
    np.testing.assert_array_equal(resample(x, 32000, 22050), want)


def test_a_failed_build_falls_back_to_scipy(monkeypatch):
    """No compiler (or a failing one): the wrappers return None, nothing
    raises, and the resampler takes scipy's path."""
    def no_gxx(name):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(_build, "build_host", no_gxx)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.load_host_lib("ssdsp") is None and not native.native_available()
    x = np.ones(1000, np.float32)
    want = scipy.signal.resample_poly(x.astype(np.float64), 441, 640,
                                      window=design_taps(441, 640)).astype(np.float32)
    np.testing.assert_array_equal(resample(x, 32000, 22050), want)
