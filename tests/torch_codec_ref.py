"""Shared checks of the codec parity tests (tests/test_torch_{mp3,oggvorbis,
opus}.py): the port's audio dispatch and fused detect on a compressed file
against the JAX package's, and both packages on a host where the codec's
system library does not load."""

import dataclasses

import numpy as np
import pytest

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import detect_file_fused as jax_detect_file_fused
from softspoken_tpu.io import audio as jaudio
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu.runtime.workers import DetectRunner as JRunner
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import detect_file_fused
from softspoken_tpu_torch.io import audio
from softspoken_tpu_torch.project.store import DetectionStore
from softspoken_tpu_torch.runtime.workers import DetectRunner

FUSED = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")


def port_detector(**eng) -> Detector:
    return Detector(Config().with_engine(**dict(FUSED, **eng)),
                    state_dict=fixture_state_dict(0), device="cpu")


def jax_detector(**eng) -> JDetector:
    return JDetector(JConfig().with_engine(**dict(FUSED, **eng)),
                     variables=jckpt.fixture_variables(seed=0))


def assert_dispatch_equals_jax(path: str) -> None:
    """probe, read_any (whole and a range), read_mono, load_audio (whole
    and a 3 s slice), get_audio_data, internal_length and stream_chunks
    give the JAX package's values, bit for bit (the same system library
    decodes on both sides)."""
    got, want = audio.probe(path), jaudio.probe(path)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for kw in ({}, {"start": 1234, "frames": 20000}):
        got, want = audio.read_any(path, **kw), jaudio.read_any(path, **kw)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(audio.read_mono(path)[0], jaudio.read_mono(path)[0])
    for kw in ({}, {"start": 30000}):
        got, want = audio.load_audio(path, **kw), jaudio.load_audio(path, **kw)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    assert audio.get_audio_data(path) == jaudio.get_audio_data(path)
    assert audio.internal_length(path) == jaudio.internal_length(path)
    got = np.concatenate([c.data for c in audio.stream_chunks(path, 30000)])
    want = np.concatenate([c.data for c in jaudio.stream_chunks(path, 30000)])
    np.testing.assert_array_equal(got, want)


def assert_fused_detect_equals_jax(path: str) -> None:
    """A fused ``detect_file_streaming`` on the compressed file: the grid
    within 1e-5 of JAX ``detect_file_fused`` (float32 on both sides, the
    same decoded samples; measured ~1e-7) and the intervals equal."""
    got = port_detector().detect_file_streaming(path)
    ref = jax_detect_file_fused(jax_detector(), path)
    assert got.num_windows == ref.num_windows > 0
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-5)
    assert got.intervals == ref.intervals
    assert got.audio_seconds == pytest.approx(ref.audio_seconds)


def assert_missing_library_as_jax(monkeypatch, tmp_path, mod, jmod, path: str,
                                  error: type, jerror: type) -> None:
    """Both packages on a host where the codec's library does not load
    (``_load`` returns None, as after a failed dlopen): ``available()`` is
    False; probe and read_any raise the codec's format error with the JAX
    message; load_audio gives (None, None); a fused detect raises the
    format error; the runner records the file as failed."""
    for m in (mod, jmod):
        monkeypatch.setattr(m, "_load", lambda: None)
    assert not mod.available() and not jmod.available()
    for call, jcall in ((audio.probe, jaudio.probe), (audio.read_any, jaudio.read_any),
                        (audio.get_audio_data, jaudio.get_audio_data)):
        with pytest.raises(jerror) as want:
            jcall(path)
        with pytest.raises(error) as got:
            call(path)
        assert str(got.value) == str(want.value)
    assert audio.load_audio(path) == (None, None) == jaudio.load_audio(path)
    with pytest.raises(error):
        port_detector().detect_file_streaming(path)
    with pytest.raises(jerror):
        jax_detect_file_fused(jax_detector(), path)

    # the host pipeline decodes in memory on both sides: a decode failure
    # (the port words it as its own OSError, JAX as "decode failed")
    host = dict(pipeline="host")
    rep = DetectRunner(port_detector(**host),
                       DetectionStore(str(tmp_path / "d.csv"))).run([path])
    jrep = JRunner(jax_detector(**host), JStore(str(tmp_path / "j.csv"))).run([path])
    assert rep.files_done == jrep.files_done == 0
    assert set(rep.errors) == set(jrep.errors) == {path}
    assert rep.errors[path] == f"OSError: failed to decode {path}"
    assert jrep.errors[path] == "decode failed"
    # the fused pipeline streams: the codec's format error, recorded
    rep = DetectRunner(port_detector(), DetectionStore(str(tmp_path / "f.csv"))).run([path])
    assert rep.files_done == 0 and set(rep.errors) == {path}
    assert rep.errors[path].startswith(f"{error.__name__}: ")
