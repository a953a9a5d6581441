"""The music post-filter (``engine/postfilter.py``) and the detector's hook
against the JAX package: scores, context windows and kept intervals equal
on seeded beat and speech-like signals, the reader-error fail-open, and
the filtered Detector's intervals equal to the JAX Detector's on
``detect_file`` and on the host ``detect_file_streaming`` (the flow of
tests/test_postfilter.py)."""

import numpy as np
import pytest

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine import postfilter as JPF
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine import postfilter as PF

SR = 22050


def _beat_signal(seconds=6.0, bpm=126.0, seed=0):
    """Four-on-the-floor kick + offbeat hat: strongly beat-periodic."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = np.zeros(n, np.float32)
    period = 60.0 / bpm
    t_kick = np.arange(0.0, seconds, period)
    for tk in t_kick:
        i = int(tk * SR)
        seg = np.arange(min(int(0.09 * SR), n - i))
        x[i:i + len(seg)] += (np.sin(2 * np.pi * 55.0 * seg / SR)
                              * np.exp(-seg / (0.03 * SR))).astype(np.float32)
    for tk in t_kick + period / 2:
        i, dur = int(tk * SR), int(0.03 * SR)
        if i + dur < n:
            x[i:i + dur] += (0.3 * rng.standard_normal(dur)).astype(np.float32)
    return x


def _speechlike(seconds=6.0, seed=1):
    """Aperiodic syllabic gates over voiced harmonics."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    phase = np.cumsum(2 * np.pi * (120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)) / SR)
    carrier = sum(np.sin(k * phase) / k for k in range(1, 6))
    gate = np.zeros(n, np.float32)
    pos = 0.0
    while pos < seconds:
        on, off = rng.uniform(0.08, 0.25), rng.uniform(0.05, 0.3)
        gate[int(pos * SR):min(int((pos + on) * SR), n)] = 1.0
        pos += on + off
    return (carrier * gate).astype(np.float32)


@pytest.mark.parametrize("make,seed", [(_beat_signal, 0), (_beat_signal, 3),
                                       (_speechlike, 1), (_speechlike, 4)])
@pytest.mark.parametrize("seconds", [2.0, 4.0, 9.0])
def test_music_score_equals_jax(make, seed, seconds):
    x = make(seconds=seconds, seed=seed)
    assert PF.music_score(x, SR) == JPF.music_score(x, SR)
    L = PF._stft_logmag(x)
    np.testing.assert_array_equal(L, JPF._stft_logmag(x))
    if seconds >= 4.0:
        k = int(PF._FLUX_FMAX * PF._N_FFT / SR)
        flux = np.maximum(0.0, np.diff(L, axis=0))[:, :k].sum(axis=1)
        assert PF._beat_info(flux, SR / PF._HOP) == JPF._beat_info(flux, SR / PF._HOP)
    assert PF.music_score(_beat_signal(9.0), SR) >= PF.DEFAULT_THRESHOLD


def test_constants_and_context_bounds_equal_jax():
    assert PF.DEFAULT_THRESHOLD == JPF.DEFAULT_THRESHOLD == 0.85
    assert PF.MIN_CONTEXT_SECONDS == JPF.MIN_CONTEXT_SECONDS
    rng = np.random.default_rng(2)
    for _ in range(200):
        dur = float(rng.uniform(0.5, 60.0))
        s = float(rng.uniform(-1.0, dur))
        e = s + float(rng.uniform(0.0, 8.0))
        for ctx in (4.0, 6.0):
            assert PF.context_bounds(s, e, dur, ctx) == JPF.context_bounds(s, e, dur, ctx)


def test_filter_intervals_equals_jax():
    audio = np.concatenate([_beat_signal(20.0), _speechlike(20.0)])
    dur = len(audio) / SR

    def rd(s, e):
        return audio[int(s * SR):int(e * SR)]

    ivs = [(-0.5, 0.4), (5.0, 6.0), (19.0, 21.5), (25.0, 26.0), (39.5, 40.2)]
    for thr in (0.5, PF.DEFAULT_THRESHOLD, 1.2):
        got = PF.filter_intervals(ivs, rd, SR, dur, thr)
        assert got == JPF.filter_intervals(ivs, rd, SR, dur, thr)
    kept, scores = PF.filter_intervals(ivs, rd, SR, dur, PF.DEFAULT_THRESHOLD)
    assert (5.0, 6.0) not in kept and (25.0, 26.0) in kept
    assert scores[1] >= PF.DEFAULT_THRESHOLD > scores[3]


def test_unreadable_context_keeps_its_region():
    ivs = [(1.0, 2.0), (5.0, 6.0)]

    def bad_reader(s, e):
        raise IOError("decode failed")

    kept, scores = PF.filter_intervals(ivs, bad_reader, SR, 60.0, 0.6)
    assert kept == ivs and all(v == -np.inf for v in scores)
    assert (kept, scores) == JPF.filter_intervals(ivs, bad_reader, SR, 60.0, 0.6)
    kept, _ = PF.filter_intervals(ivs, lambda s, e: None, SR, 60.0, 0.6)
    assert kept == ivs
    # a context shorter than MIN_CONTEXT_SECONDS is never read
    kept, scores = PF.filter_intervals([(0.0, 1.0)], bad_reader, SR, 2.0, 0.0)
    assert kept == [(0.0, 1.0)] and scores == [-np.inf]


ENG = dict(precision="parity", device_batch=4, chunk_seconds=12.0, pipeline="host")


def _pair(music_filter):
    eng = dict(ENG, music_filter=music_filter)
    port = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(seed=0),
                    device="cpu")
    jax = JDetector(JConfig().with_engine(**eng), variables=jckpt.fixture_variables(seed=0))
    return port, jax


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("postfilter")
    out = {}
    for name, x in (("beat", _beat_signal(12.0)),
                    ("mix", np.concatenate([_beat_signal(8.0), _speechlike(8.0)]))):
        out[name] = str(d / f"{name}.wav")
        jwavio.write(out[name], x, SR, subtype="PCM_16")
    return out


@pytest.mark.parametrize("method", ["detect_file", "detect_file_streaming"])
def test_filtered_detector_intervals_equal_jax(wavs, method):
    base, _ = _pair(None)
    port, jax = _pair(PF.DEFAULT_THRESHOLD)
    dropped = 0
    for path in wavs.values():
        r0 = getattr(base, method)(path)
        r1 = getattr(port, method)(path)
        j1 = getattr(jax, method)(path)
        assert r0.intervals  # the fixture weights fire on most input
        np.testing.assert_array_equal(r1.avg_values, r0.avg_values)  # grid untouched
        np.testing.assert_allclose(r1.avg_values, j1.avg_values, atol=2e-5)
        assert r1.intervals == j1.intervals
        dropped += len(r0.intervals) - len(r1.intervals)
    assert dropped > 0  # the beat's regions went


def test_detect_waveform_reads_its_own_audio():
    base, _ = _pair(None)
    port, jax = _pair(PF.DEFAULT_THRESHOLD)
    audio = _beat_signal(12.0)
    r0, r1 = base.detect_waveform(audio), port.detect_waveform(audio)
    assert len(r1.intervals) < len(r0.intervals) or r1.intervals == []
    assert r1.intervals == jax.detect_waveform(audio).intervals
