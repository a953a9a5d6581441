"""The port's MPEG audio reader (``softspoken_tpu_torch/io/mp3.py``),
mirroring tests/test_mp3.py, and held to the JAX package's reader on the
same files: the same system libmpg123 decodes on both sides, so the
samples are equal bit for bit.

pygame's bundled house_lo.mp3 is the real third-party-encoded oracle file.
"""

import os

import numpy as np
import pytest

from softspoken_tpu.io import mp3 as jmp3
from softspoken_tpu_torch.io import mp3
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.project import Table
from softspoken_tpu_torch.silence import SilenceRunner
from torch_codec_ref import (assert_dispatch_equals_jax, assert_fused_detect_equals_jax,
                             assert_missing_library_as_jax)

pytestmark = pytest.mark.skipif(
    not mp3.available(), reason="system libmpg123 not installed")

needs_encoder = pytest.mark.skipif(
    not mp3.encoder_available(), reason="system libmp3lame not installed")


def _tone(sr=22050, seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(size=len(t))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def mp3_file(tmp_path_factory):
    if not mp3.encoder_available():
        pytest.skip("system libmp3lame not installed")
    sr = 22050
    x = _tone(sr)
    p = str(tmp_path_factory.mktemp("mp3") / "tone.mp3")
    mp3.write_mp3(p, x, sr)
    return p, x, sr


@needs_encoder
def test_info_exact_length(mp3_file):
    """The LAME tag written by write_mp3 makes gapless decode recover the
    EXACT original sample count — no encoder delay/padding leaks."""
    p, x, sr = mp3_file
    inf = mp3.info(p)
    assert inf.samplerate == sr
    assert inf.channels == 1
    assert inf.frames == len(x)
    assert inf.subtype == "MPEG_LAYER_III"
    assert abs(inf.duration - 5.0) < 1e-6


@needs_encoder
def test_roundtrip_close(mp3_file):
    p, x, sr = mp3_file
    y, sr2 = mp3.read(p)
    assert sr2 == sr and len(y) == len(x)
    # lossy codec: assert strong correlation, not equality
    assert np.corrcoef(x, y)[0, 1] > 0.98


@needs_encoder
def test_range_read_sample_accurate(mp3_file):
    """Post-seek decode matches the continuous decode to <= 1 float ulp
    (mpg123 re-warms the synthesis filterbank from PREFRAMES frames)."""
    p, x, sr = mp3_file
    full, _ = mp3.read(p)
    part, _ = mp3.read(p, start=sr, frames=sr)
    np.testing.assert_allclose(part, full[sr:2 * sr], atol=1e-6)
    # non-frame-aligned start
    part2, _ = mp3.read(p, start=12345, frames=1000)
    np.testing.assert_allclose(part2, full[12345:13345], atol=1e-6)
    # EOF clamp
    tail, _ = mp3.read(p, start=len(x) - 100, frames=1000)
    assert len(tail) == 100
    # empty read
    none, _ = mp3.read(p, start=50, frames=0)
    assert len(none) == 0


@needs_encoder
def test_stereo_roundtrip(tmp_path):
    sr = 32000
    t = np.arange(2 * sr) / sr
    x = np.stack([0.3 * np.sin(2 * np.pi * 300 * t),
                  0.3 * np.sin(2 * np.pi * 500 * t)], axis=1).astype(np.float32)
    p = str(tmp_path / "st.mp3")
    mp3.write_mp3(p, x, sr)
    inf = mp3.info(p)
    assert inf.channels == 2 and inf.frames == len(t)
    y, _ = mp3.read(p)
    assert y.shape == x.shape
    assert np.corrcoef(x[:, 0], y[:, 0])[0, 1] > 0.95
    assert np.corrcoef(x[:, 1], y[:, 1])[0, 1] > 0.95


@needs_encoder
def test_sequential_reader_matches_read(mp3_file):
    p, x, sr = mp3_file
    full, _ = mp3.read(p)
    with mp3.SequentialMonoReader(p) as smr:
        assert smr.info.frames == len(x)
        a = smr.read(0, 10000)
        b = smr.read(8000, 10000)      # overlapping (backward seek)
        c = smr.read(60000, 10**9)     # EOF clamp
    np.testing.assert_allclose(a, full[:10000], atol=1e-6)
    np.testing.assert_allclose(b, full[8000:18000], atol=1e-6)
    assert len(c) == len(x) - 60000


@needs_encoder
def test_probe_and_read_any_dispatch(mp3_file):
    from softspoken_tpu_torch.io.audio import get_audio_data, read_any, read_mono

    p, x, sr = mp3_file
    dur, native_sr = get_audio_data(p)
    assert native_sr == sr and abs(dur - 5.0) < 1e-6
    data, sr2 = read_any(p, start=100, frames=50)
    assert sr2 == sr and len(data) == 50
    mono, sr3 = read_mono(p)
    assert sr3 == sr and mono.ndim == 1 and len(mono) == len(x)


@needs_encoder
def test_stream_chunks_concat_equals_load(mp3_file):
    """The MPEG branch of stream_chunks (persistent handle) must
    reproduce load_audio output exactly when concatenated."""
    from softspoken_tpu_torch.io.audio import load_audio, stream_chunks

    p, x, sr = mp3_file
    whole, _ = load_audio(p)
    parts = list(stream_chunks(p, chunk_samples=30000))
    assert parts[-1].is_last and not parts[0].is_last
    cat = np.concatenate([c.data for c in parts])
    assert len(cat) == len(whole)
    np.testing.assert_allclose(cat, whole, atol=2e-6)


@needs_encoder
def test_scan_index_cache_reused_and_exact(tmp_path):
    """The second open of an unchanged file must import the first open's
    frame index (no re-scan) and decode byte-identically — the review
    screen opens a fresh handle per spectrogram window, so without this
    every window load re-reads the whole file."""
    sr = 22050
    x = _tone(sr, seconds=3.0, seed=7)
    p = str(tmp_path / "cache.mp3")
    mp3.write_mp3(p, x, sr)
    mp3._scan_cache.clear()

    with mp3._Handle(p) as h1:
        assert h1.scanned  # first open: fresh scan, index published
        full1 = np.empty((h1.total, h1.channels), np.float32)
        h1.read_into(full1)
    with mp3._Handle(p) as h2:
        assert not h2.scanned  # second open: cached index adopted
        assert h2.total == h1.total
        assert h2.subtype == h1.subtype
        full2 = np.empty((h2.total, h2.channels), np.float32)
        h2.read_into(full2)
    # full decode: scan leaves the handle needing an internal seek back
    # to frame 0, the cached handle decodes straight through — the only
    # difference is the module's documented <= 1-ulp seek re-warm
    # (measured: both paths individually deterministic)
    np.testing.assert_allclose(full1, full2, atol=6e-8)

    # range reads seek on BOTH paths: byte-identical
    a, _ = mp3.read(p, start=12347, frames=5000)   # cached path
    mp3._scan_cache.clear()
    b, _ = mp3.read(p, start=12347, frames=5000)   # fresh-scan path
    assert np.array_equal(a, b)


@needs_encoder
def test_scan_index_cache_invalidated_on_rewrite(tmp_path):
    """A changed file (size/mtime) must not reuse the stale index."""
    sr = 22050
    p = str(tmp_path / "mut.mp3")
    mp3.write_mp3(p, _tone(sr, seconds=2.0, seed=1), sr)
    assert mp3.info(p).frames == 2 * sr
    mp3.write_mp3(p, _tone(sr, seconds=4.0, seed=2), sr)
    inf = mp3.info(p)
    assert inf.frames == 4 * sr
    y, _ = mp3.read(p)
    assert len(y) == 4 * sr


class _FakeCLib:
    """Stand-in for a ctypes CDLL: unknown symbols appear on first access
    (like dlsym hits), except _64 names when the build lacks the LFS
    alias layer — those raise AttributeError (like dlsym misses)."""

    def __init__(self, with64: bool):
        self.__dict__["_with64"] = with64

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name.endswith("_64") and not self.__dict__["_with64"]:
            raise AttributeError(name)
        import types

        fn = types.SimpleNamespace()
        self.__dict__[name] = fn
        return fn


def test_pick64_binding_fallback():
    """_bind must prefer the _64 entry points and fall back to the plain
    names (publishing them under the _64 attribute) on builds without
    the LFS aliases."""
    no64 = _FakeCLib(with64=False)
    mp3._bind(no64, None)
    assert no64.mpg123_open_64 is no64.mpg123_open
    assert no64.mpg123_length_64 is no64.mpg123_length
    assert no64.mpg123_seek_64 is no64.mpg123_seek
    assert no64.mpg123_set_index_64 is no64.mpg123_set_index

    has64 = _FakeCLib(with64=True)
    mp3._bind(has64, None)
    assert has64.mpg123_open_64 is not has64.mpg123_open
    assert has64.mpg123_seek_64 is not has64.mpg123_seek


def test_is_mp3_rejects_other_formats(tmp_path):
    w = str(tmp_path / "x.wav")
    wavio.write(w, np.zeros(100, np.float32), 8000)
    assert not mp3.is_mp3(w)
    j = str(tmp_path / "x.bin")
    with open(j, "wb") as f:
        f.write(b"\x00\x01\x02\x03" * 16)
    assert not mp3.is_mp3(j)
    # sync bytes but reserved layer/bitrate fields
    k = str(tmp_path / "y.bin")
    with open(k, "wb") as f:
        f.write(bytes([0xFF, 0xE0, 0xF0, 0x00]) * 16)
    assert not mp3.is_mp3(k)


@needs_encoder
def test_truncated_file_reads_short_not_hang(mp3_file, tmp_path):
    """A crash-truncated MP3 (mid-frame cut) must decode to fewer frames
    than intact — never hang, crash, or fabricate samples."""
    p, x, sr = mp3_file
    with open(p, "rb") as f:
        blob = f.read()
    q = str(tmp_path / "cut.mp3")
    with open(q, "wb") as f:
        f.write(blob[: len(blob) // 2])
    inf = mp3.info(q)
    assert 0 < inf.frames < len(x)
    y, sr2 = mp3.read(q)
    assert sr2 == sr and 0 < len(y) <= inf.frames


def test_not_mp3_raises(tmp_path):
    p = str(tmp_path / "junk.mp3")
    with open(p, "wb") as f:
        f.write(b"ID3" + b"\x00" * 64)  # tag magic but no MPEG frames
    with pytest.raises(mp3.Mp3FormatError):
        mp3.info(p)


@needs_encoder
def test_write_mp3_bad_path_raises_and_failure_leaves_no_file(tmp_path):
    x = np.zeros(4000, np.float32)
    with pytest.raises(OSError):
        mp3.write_mp3(str(tmp_path / "no_such_dir" / "x.mp3"), x, 22050)
    # a rejected encode (non-MPEG sample rate) raises AND removes the file
    p = str(tmp_path / "bad.mp3")
    with pytest.raises(mp3.Mp3FormatError):
        mp3.write_mp3(p, x, samplerate=12345)
    assert not os.path.exists(p)
    # encoder state is not process-global: a good write still works
    ok = str(tmp_path / "ok.mp3")
    mp3.write_mp3(ok, _tone(22050, 1.0), 22050)
    y, sr = mp3.read(ok)
    assert sr == 22050 and len(y) == 22050


def test_real_mp3_matches_sdl_oracle():
    """pygame's house_lo.mp3: real third-party-encoded MPEG2.5 Layer III.
    Our libmpg123 binding and SDL's independent decoder must agree to
    int16 precision with the SAME sample count and alignment."""
    pygame = pytest.importorskip("pygame")
    p = os.path.join(os.path.dirname(pygame.__file__),
                     "examples", "data", "house_lo.mp3")
    if not os.path.exists(p):
        pytest.skip("pygame example data not present")
    inf = mp3.info(p)
    assert inf.samplerate == 11025 and inf.channels == 1
    ours, sr = mp3.read(p)
    assert sr == 11025 and len(ours) == inf.frames

    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    import pygame.sndarray as sa

    pygame.mixer.quit()
    pygame.mixer.init(frequency=inf.samplerate, size=-16, channels=1)
    try:
        theirs = sa.array(pygame.mixer.Sound(p)).reshape(-1).astype(
            np.float32) / 32768.0
    finally:
        pygame.mixer.quit()
    assert len(theirs) == len(ours)  # same gapless/delay convention
    # measured max |diff| = 0.5 int16 LSB (SDL's int16 rounding)
    np.testing.assert_allclose(ours, theirs, atol=1.001 / 32768.0)


@needs_encoder
def test_detect_file_on_mp3(tmp_path):
    """Fused detect on an MP3 (the persistent sequential reader): the JAX
    package's grid and intervals."""
    sr = 32000
    x = (0.02 * np.random.default_rng(3).normal(size=10 * sr)).astype(np.float32)
    p = str(tmp_path / "field.mp3")
    mp3.write_mp3(p, x, sr)
    assert mp3.info(p).frames == 10 * sr
    assert_fused_detect_equals_jax(p)


@needs_encoder
def test_silencer_on_mp3(tmp_path):
    """The silence workflow must cover every format probe() dispatches
    (Mp3Info.data_bytes=0 falls back to frames * bytes-per-frame in the
    stream gate, like OggInfo)."""
    sr = 22050
    x = _tone(sr, seconds=4.0, seed=3)
    src = str(tmp_path / "rec.mp3")
    mp3.write_mp3(src, x, sr)

    review = Table(["file_path", "file_name", "start_time", "end_time", "erase"],
                   [{"file_path": str(tmp_path), "file_name": "rec.mp3",
                     "start_time": 1.0, "end_time": 2.0, "erase": 1}])
    report = SilenceRunner(str(tmp_path / "out")).run(review)
    assert report.files_failed == 0 and report.files_done == 1
    y, osr = wavio.read(report.outputs[0])
    assert osr == sr and len(y) == len(x)
    s0, s1 = int(1.0 * sr), int(2.0 * sr)
    assert np.all(y[s0:s1] == 0)
    assert np.abs(y[: s0 - 1]).max() > 0.05


# ---------------------------------------------------------------------------
# the port against the JAX package

@needs_encoder
def test_reader_equals_jax_bit_for_bit(mp3_file):
    """info, read (whole, ranges, EOF), the sequential reader and the audio
    dispatch give the JAX module's values."""
    p, x, sr = mp3_file
    assert mp3.info(p).__dict__ == jmp3.info(p).__dict__
    for kw in ({}, {"start": 12345, "frames": 1000}, {"start": sr, "frames": sr},
               {"start": len(x) - 10, "frames": 100}, {"always_2d": True}):
        got, want = mp3.read(p, **kw), jmp3.read(p, **kw)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    with mp3.SequentialMonoReader(p) as a, jmp3.SequentialMonoReader(p) as b:
        for start, n in ((0, 10000), (8000, 10000), (60000, 10**9)):
            np.testing.assert_array_equal(a.read(start, n), b.read(start, n))
    assert_dispatch_equals_jax(p)


@needs_encoder
def test_writer_bytes_equal_jax(tmp_path):
    x = _tone(22050, seconds=2.0, seed=4)
    a, b = str(tmp_path / "a.mp3"), str(tmp_path / "b.mp3")
    mp3.write_mp3(a, x, 22050)
    jmp3.write_mp3(b, x, 22050)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@needs_encoder
def test_without_libmpg123_as_jax(monkeypatch, tmp_path, mp3_file):
    assert_missing_library_as_jax(monkeypatch, tmp_path, mp3, jmp3, mp3_file[0],
                                  mp3.Mp3FormatError, jmp3.Mp3FormatError)
