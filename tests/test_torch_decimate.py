"""The port's wire decimator (``softspoken_tpu_torch/io/decimate.py``, a copy
of the JAX package's ``io/decimate.py``) against the original on the CPU:
the same factors and taps, and ``WireDecimator.read`` bit-equal over
misaligned, overlapping windows and at both file edges, the native route
to the JAX native route and the numpy route to the JAX numpy route (the two
routes agree only to about 1 LSB); plus the fused engine's decimation
policy, as ``tests/test_decimate.py`` holds the JAX one."""

import types

import numpy as np
import pytest

from softspoken_tpu.engine.fused import _maybe_wire_decimate as j_maybe
from softspoken_tpu.io import decimate as JD
from softspoken_tpu.io import native as jnative
from softspoken_tpu_torch.engine.fused import _maybe_wire_decimate
from softspoken_tpu_torch.io import decimate as D
from softspoken_tpu_torch.io import native

RATES = [8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000, 192000]


@pytest.fixture(autouse=True)
def _one_thread_reference(monkeypatch):
    """The JAX package's threaded ss_fir_decim_i16 (>= 65,536 outputs with
    more than one thread) reads a thread_local scratch from its worker
    threads and crashes the process; one thread gives the same samples."""
    monkeypatch.setattr(jnative, "_threads", lambda: 1)


def _numpy_route(monkeypatch):
    monkeypatch.setattr(native, "fir_decim_i16", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "fir_decim_i16", lambda *a, **k: None)


def test_version_and_factors_equal():
    assert D.DECIM_VERSION == JD.DECIM_VERSION
    for sr in RATES:
        for f_max in (4000.0, 8000.0, 10000.0):
            assert D.decim_factor(sr, f_max) == JD.decim_factor(sr, f_max)
    # tests/test_decimate.py's table
    assert [D.decim_factor(sr) for sr in (32000, 44100, 48000, 96000, 192000)] == [2, 2, 3, 6, 12]
    assert D.decim_factor(32000, f_max=10000.0) == 1


@pytest.mark.parametrize("sr,M", [(32000, 2), (44100, 2), (48000, 3), (96000, 6)])
def test_taps_equal(sr, M):
    h = D.decim_taps(sr, M)
    assert h.dtype == np.float32 and len(h) % 2 == 1
    np.testing.assert_array_equal(h, JD.decim_taps(sr, M))
    assert abs(float(h.sum()) - 1.0) < 1e-4
    with pytest.raises(ValueError):
        D.decim_taps(sr, 1)


def _nat(n, seed=0):
    return np.random.default_rng(seed).integers(-20000, 20000, n).astype(np.int16)


def _pair(nat, sr, M):
    rd = lambda s, n: nat[s:s + n]  # noqa: E731
    return D.WireDecimator(rd, len(nat), sr, M), JD.WireDecimator(rd, len(nat), sr, M)


# (start, frames): both file edges, misaligned and overlapping windows, a
# read past EOF, one at EOF, and one of >= 65,536 outputs (the C loop's
# threaded size)
WINDOWS = [(0, 1), (0, 3), (0, 5000), (1, 777), (13, 4096), (4000, 9001), (4001, 9000),
           (23990, 10), (23997, 3), (23990, 100), (24000, 10), (0, 24000)]


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("sr,M", [(32000, 2), (48000, 3)])
def test_read_is_bit_equal_to_jax(monkeypatch, route, sr, M):
    if route == "native" and not (native.native_available() and jnative.native_available()):
        pytest.skip("no g++: neither package can build its native library")
    if route == "numpy":
        _numpy_route(monkeypatch)
    nat = _nat(24000 * M, seed=M)
    d, jd = _pair(nat, sr, M)
    assert (d.frames, d.sr, d.T, d.half) == (jd.frames, jd.sr, jd.T, jd.half)
    for start, frames in WINDOWS:
        got = d.read(start, frames)
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, jd.read(start, frames))


def test_native_read_of_many_outputs(monkeypatch):
    """70,000 outputs at once: the size at which the C loop would thread
    (the port always runs it on one thread)."""
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("no g++: neither package can build its native library")
    nat = _nat(2 * 70_000 + 500, seed=4)
    d, jd = _pair(nat, 32000, 2)
    native.reset_call_counts()
    got = d.read(0, 70_000)
    assert native.NATIVE_CALLS["fir_decim_i16"] == 1
    np.testing.assert_array_equal(got, jd.read(0, 70_000))


def test_routes_agree_to_one_lsb(monkeypatch):
    nat = _nat(32000, seed=3)
    d, _ = _pair(nat, 32000, 2)
    xbuf = np.zeros((d.frames - 1) * d.M + d.T, np.int16)
    xbuf[d.half: d.half + len(nat)] = nat[: len(xbuf) - d.half]
    got_native = native.fir_decim_i16(xbuf, d.h, d.M, d.frames)
    if got_native is None:
        pytest.skip("native code unavailable (no g++)")
    got_np = d._decimate_numpy(xbuf, d.frames)
    assert np.abs(got_native.astype(np.int32) - got_np.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError):
        native.fir_decim_i16(xbuf[:-1], d.h, d.M, d.frames)


def _naive(nat, h, M, n_out):
    """Literal contract: y[j] = rint(sum_k h[k]*nat0[j*M - half + k])."""
    T, half = len(h), len(h) // 2
    natp = np.concatenate([np.zeros(half), nat.astype(np.float64), np.zeros(T)])
    out = np.array([h @ natp[j * M: j * M + T] for j in range(n_out)])
    return np.clip(np.rint(out), -32768, 32767).astype(np.int16)


def test_matches_naive_oracle_and_is_windowing_invariant():
    nat = _nat(32000 * 2, seed=7)
    d, _ = _pair(nat, 32000, 2)
    whole = d.read(0, d.frames)
    ref = _naive(nat, d.h64, 2, d.frames)
    assert np.abs(whole.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    rng = np.random.default_rng(1)
    pos, parts = 0, []
    while pos < d.frames:
        step = int(rng.integers(1, 9000))
        parts.append(d.read(pos, min(step, d.frames - pos)))
        pos += step
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    assert len(d.read(d.frames - 10, 100)) == 10 and len(d.read(d.frames, 10)) == 0


def test_tones_pass_and_stop():
    sr, t = 32000, np.arange(32000 * 2) / 32000
    for f, keep in ((1000.0, True), (5000.0, True), (15000.0, False)):
        x = (10000 * np.sin(2 * np.pi * f * t)).astype(np.int16)
        d = D.WireDecimator(lambda s, n, x=x: x[s:s + n], len(x), sr, 2)
        y = d.read(0, d.frames).astype(np.float64)
        rms = np.sqrt(np.mean(y[1000:-1000] ** 2)) / (10000 / np.sqrt(2))
        assert (rms > 0.99) if keep else (rms < 0.01)


def _det(**eng):
    """What ``_maybe_wire_decimate`` reads of a detector: its config."""
    from softspoken_tpu_torch import Config

    return types.SimpleNamespace(cfg=Config().with_engine(**eng))


def _jdet(**eng):
    from softspoken_tpu import Config as JConfig

    return types.SimpleNamespace(cfg=JConfig().with_engine(**eng))


@pytest.mark.parametrize("kind", ["i16", "f32", "mulaw8", "adpcm4"])
@pytest.mark.parametrize("sr", [16000, 22050, 32000, 44100, 48000])
@pytest.mark.parametrize("wd", ["auto", "off"])
def test_maybe_wire_decimate_policy_matches_jax(kind, sr, wd):
    rd = lambda s, n: np.zeros(n, np.int16)  # noqa: E731
    _, nfr, wsr = _maybe_wire_decimate(_det(wire_decimate=wd), rd, sr * 10, sr, kind)
    _, jnfr, jwsr = j_maybe(_jdet(wire_decimate=wd), rd, sr * 10, sr, kind)
    assert (nfr, wsr) == (jnfr, jwsr)


def test_maybe_wire_decimate_policy():
    """tests/test_decimate.py::test_maybe_wire_decimate_policy on the port."""
    det = _det()
    rd = lambda s, n: np.zeros(n, np.int16)  # noqa: E731
    assert _maybe_wire_decimate(det, rd, 32000, 32000, "i16")[2] == 32000
    assert _maybe_wire_decimate(det, rd, 32000, 32000, "f32")[2] == 32000
    _, nfr, sr = _maybe_wire_decimate(det, rd, 32000 * 10, 32000, "mulaw8")
    assert (nfr, sr) == (16000 * 10, 16000)
    assert _maybe_wire_decimate(det, rd, 22050, 22050, "mulaw8")[2] == 22050
    assert _maybe_wire_decimate(_det(wire_decimate="off"), rd, 32000, 32000, "mulaw8")[2] == 32000
