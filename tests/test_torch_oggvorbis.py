"""The port's Ogg/Vorbis reader (``softspoken_tpu_torch/io/oggvorbis.py``),
mirroring tests/test_oggvorbis.py, and held to the JAX package's reader on
the same files: the same system libvorbis decodes on both sides, so the
samples are equal bit for bit.
"""

import os

import numpy as np
import pytest

from softspoken_tpu.io import oggvorbis as jov
from softspoken_tpu_torch.io import oggvorbis as ov
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project import Table
from softspoken_tpu_torch.silence import SilenceRunner
from torch_codec_ref import (assert_dispatch_equals_jax, assert_fused_detect_equals_jax,
                             assert_missing_library_as_jax)

pytestmark = pytest.mark.skipif(
    not ov.available(), reason="system libvorbis not installed")


def _tone(sr=22050, seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=len(t))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def ogg_file(tmp_path_factory):
    sr = 22050
    x = _tone(sr)
    p = str(tmp_path_factory.mktemp("ogg") / "tone.ogg")
    ov.write_vorbis(p, x, sr, quality=0.5)
    return p, x, sr


def test_info(ogg_file):
    p, x, sr = ogg_file
    inf = ov.info(p)
    assert inf.samplerate == sr
    assert inf.channels == 1
    assert inf.frames == len(x)
    assert inf.subtype == "VORBIS"
    assert abs(inf.duration - 5.0) < 1e-6


def test_roundtrip_close(ogg_file):
    p, x, sr = ogg_file
    y, sr2 = ov.read(p)
    assert sr2 == sr and len(y) == len(x)
    # lossy codec: strong correlation, not equality
    assert np.corrcoef(x, y)[0, 1] > 0.98


def test_range_read_sample_accurate(ogg_file):
    p, x, sr = ogg_file
    full, _ = ov.read(p)
    part, _ = ov.read(p, start=sr, frames=sr)
    np.testing.assert_allclose(part, full[sr:2 * sr], atol=1e-6)
    tail, _ = ov.read(p, start=len(x) - 100, frames=1000)  # EOF clamp
    assert len(tail) == 100


def test_stereo_roundtrip(tmp_path):
    sr = 32000
    t = np.arange(2 * sr) / sr
    x = np.stack([0.3 * np.sin(2 * np.pi * 300 * t),
                  0.3 * np.sin(2 * np.pi * 500 * t)], axis=1).astype(np.float32)
    p = str(tmp_path / "st.ogg")
    ov.write_vorbis(p, x, sr)
    inf = ov.info(p)
    assert inf.channels == 2 and inf.frames == len(t)
    y, _ = ov.read(p)
    assert y.shape == x.shape
    assert np.corrcoef(x[:, 0], y[:, 0])[0, 1] > 0.95
    assert np.corrcoef(x[:, 1], y[:, 1])[0, 1] > 0.95
    np.testing.assert_array_equal(y, jov.read(p)[0])
    assert_dispatch_equals_jax(p)


def test_probe_and_read_any_dispatch(ogg_file):
    from softspoken_tpu_torch.io.audio import get_audio_data, read_any, read_mono

    p, x, sr = ogg_file
    dur, native_sr = get_audio_data(p)
    assert native_sr == sr and abs(dur - 5.0) < 1e-6
    data, sr2 = read_any(p, start=100, frames=50)
    assert sr2 == sr and len(data) == 50
    mono, sr3 = read_mono(p)
    assert sr3 == sr and mono.ndim == 1 and len(mono) == len(x)


def test_not_ogg_raises(tmp_path):
    p = str(tmp_path / "junk.ogg")
    with open(p, "wb") as f:
        f.write(b"OggS" + b"\x00" * 64)  # magic but not a vorbis stream
    with pytest.raises(ov.OggFormatError):
        ov.info(p)


def test_detect_file_on_ogg(tmp_path):
    """Fused detect on an Ogg file (the generic read_mono branch, as in the
    JAX package): the JAX package's grid and intervals."""
    sr = 32000
    x = (0.02 * np.random.default_rng(3).normal(size=10 * sr)).astype(np.float32)
    p = str(tmp_path / "field.ogg")
    ov.write_vorbis(p, x, sr)
    assert ov.info(p).frames == 10 * sr
    assert_fused_detect_equals_jax(p)


def test_silencer_on_ogg(tmp_path):
    """The silence workflow covers every format probe() dispatches
    (OggInfo.data_bytes feeds the stream-size gate)."""
    sr = 22050
    x = _tone(sr, seconds=4.0, seed=3)
    src = str(tmp_path / "rec.ogg")
    ov.write_vorbis(src, x, sr, quality=0.5)
    review = Table(["file_path", "file_name", "start_time", "end_time", "erase"],
                   [{"file_path": str(tmp_path), "file_name": "rec.ogg",
                     "start_time": 1.0, "end_time": 2.0, "erase": 1}])
    report = SilenceRunner(str(tmp_path / "out")).run(review)
    assert report.files_failed == 0 and report.files_done == 1
    y, osr = wavio.read(report.outputs[0])
    assert osr == sr and len(y) == len(x)
    s0, s1 = int(1.0 * sr), int(2.0 * sr)
    assert np.all(y[s0:s1] == 0)              # the muted span is hard zero
    assert np.abs(y[: s0 - 1]).max() > 0.05   # audio elsewhere survives


def test_write_vorbis_bad_path_raises_and_state_survives(tmp_path):
    """A failed write raises cleanly and leaks no encoder state; a later
    good write works."""
    x = (0.2 * np.sin(2 * np.pi * 440 * np.arange(8000) / 8000)).astype(np.float32)
    with pytest.raises(OSError):
        ov.write_vorbis(str(tmp_path / "no_such_dir" / "x.ogg"), x, 8000)
    ok = str(tmp_path / "ok.ogg")
    ov.write_vorbis(ok, x, 8000)
    y, sr = ov.read(ok)
    assert sr == 8000 and len(y) == len(x)


def test_write_vorbis_failure_leaves_no_file(tmp_path):
    """A rejected encode (quality out of range) raises and removes the
    partly opened output."""
    p = str(tmp_path / "bad.ogg")
    with pytest.raises(ov.OggFormatError):
        ov.write_vorbis(p, np.zeros(256, np.float32), samplerate=8000, quality=-2.0)
    assert not os.path.exists(p)


# ---------------------------------------------------------------------------
# the port against the JAX package

def test_reader_equals_jax_bit_for_bit(ogg_file):
    p, x, sr = ogg_file
    assert ov.info(p).__dict__ == jov.info(p).__dict__
    for kw in ({}, {"start": 0, "frames": 1000}, {"start": 33333, "frames": 22050},
               {"start": len(x) - 10, "frames": 100}, {"always_2d": True}):
        got, want = ov.read(p, **kw), jov.read(p, **kw)
        assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])
    assert_dispatch_equals_jax(p)


def test_writer_bytes_equal_jax(ogg_file, tmp_path):
    """The encoder is the JAX package's over the same library, with the
    same fixed stream serial: the same bytes."""
    _p, x, sr = ogg_file
    a, b = str(tmp_path / "a.ogg"), str(tmp_path / "b.ogg")
    ov.write_vorbis(a, x, sr, quality=0.3)
    jov.write_vorbis(b, x, sr, quality=0.3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_without_libvorbis_as_jax(monkeypatch, tmp_path, ogg_file):
    assert_missing_library_as_jax(monkeypatch, tmp_path, ov, jov, ogg_file[0],
                                  ov.OggFormatError, jov.OggFormatError)
