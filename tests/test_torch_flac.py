"""The port's FLAC reader (``softspoken_tpu_torch/io/flac.py`` over its copy
of ``csrc/ssflac.cpp``) against the JAX package's, on the fixtures of the
numpy test encoder ``tests/flac_ref.py``: every decoded sample, info field
and range read is exactly equal.  Then detect on a FLAC against the same
PCM as a WAV (port, bit-equal grids on the fused path) and against the JAX
package in parity mode (equal intervals)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flac_ref
from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.io import audio as jaudio
from softspoken_tpu.io import flac as jflac
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.io import audio, flac
from softspoken_tpu_torch.io.native import NATIVE_CALLS

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = flac_ref.BLOCKSIZE


@pytest.fixture(autouse=True)
def _decoders():
    if not (flac.flac_available() and jflac.flac_available()):
        pytest.skip("no g++: neither package can build its FLAC decoder")


def _ints(frames, channels, bits, seed=0):
    """A sine per channel plus noise, as integers of ``bits`` bits."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    amp = (1 << (bits - 1)) - 1
    x = np.stack([0.5 * amp * np.sin(2 * np.pi * (300 + 200 * c) * t / 22050)
                  + 0.05 * amp * rng.standard_normal(frames)
                  for c in range(channels)], axis=1)
    return np.clip(np.rint(x), -(1 << (bits - 1)), amp).astype(np.int64)


# name -> (write_flac arguments, samples)
FIXTURES = {
    "mono16": (dict(samplerate=22050, bits=16), _ints(10_000, 1, 16)),
    "stereo16-short-last-block": (dict(samplerate=32000, bits=16),
                                  _ints(2 * BS + 123, 2, 16, seed=1)),
    "mono8": (dict(samplerate=16000, bits=8), _ints(5000, 1, 8, seed=2)),
    "mono24": (dict(samplerate=48000, bits=24), _ints(BS + 4, 1, 24, seed=4)),
    "stereo24": (dict(samplerate=44100, bits=24), _ints(3000, 2, 24, seed=6)),
    "verbatim": (dict(samplerate=22050, bits=16, force_subframe="verbatim"),
                 _ints(6000, 1, 16, seed=2)),
    "fixed0": (dict(samplerate=22050, bits=16, force_subframe="fixed0"),
               _ints(6000, 1, 16, seed=2)),
    "fixed1": (dict(samplerate=22050, bits=16, force_subframe="fixed1"),
               _ints(6000, 1, 16, seed=2)),
    "fixed2": (dict(samplerate=22050, bits=16, force_subframe="fixed2"),
               _ints(6000, 1, 16, seed=2)),
    "constant": (dict(samplerate=22050, bits=16), np.full((5000, 1), -1234, np.int64)),
    "left-side": (dict(samplerate=22050, bits=16, left_side=True),
                  _ints(5000, 2, 16, seed=3)),
    "seektable": (dict(samplerate=22050, bits=16, seektable_every=2),
                  _ints(5 * BS, 1, 16, seed=5)),
}


def _write(tmp_path, name):
    kw, x = FIXTURES[name]
    p = str(tmp_path / f"{name}.flac")
    flac_ref.write_flac(p, x, **kw)
    return p, x


@pytest.mark.parametrize("name", list(FIXTURES))
def test_reader_equals_jax_and_the_encoder_input(tmp_path, name):
    p, x = _write(tmp_path, name)
    assert flac.is_flac(p) and flac.info(p).__dict__ == jflac.info(p).__dict__
    with flac.FlacReader(p) as r, jflac.FlacReader(p) as j:
        got = r.read_i32(len(x) + 10)                    # past EOF: clamped
        np.testing.assert_array_equal(got, j.read_i32(len(x) + 10))
    np.testing.assert_array_equal(got.astype(np.int64), x)
    for always_2d in (False, True):
        a, sr = flac.read(p, always_2d=always_2d)
        b, jsr = jflac.read(p, always_2d=always_2d)
        assert sr == jsr and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_seektable_range_reads_equal_jax(tmp_path):
    p, x = _write(tmp_path, "seektable")
    with flac.FlacReader(p) as r, jflac.FlacReader(p) as j:
        for start, n in [(0, 100), (5000, 1000), (12_000, 4097), (100, 50),
                         (5 * BS - 10, 100), (5 * BS, 10), (3 * BS, 0)]:
            got = r.read_f32(start, n)
            np.testing.assert_array_equal(got, j.read_f32(start, n))
            np.testing.assert_array_equal(
                got, x[start: start + n, 0].astype(np.float32) / 32768.0)


def test_eof_reads_and_seeks_are_empty(tmp_path):
    p, x = _write(tmp_path, "mono16")
    for start, frames in [(len(x), None), (len(x) + 100, 10)]:
        got, _ = audio.read_any(p, start=start, frames=frames)
        want, _ = jaudio.read_any(p, start=start, frames=frames)
        assert got.shape == want.shape == (0,)
    with flac.FlacReader(p) as r:
        r.seek(r.info.frames)
        assert r.read_i32(100).shape == (0, 1)
        r.seek(0)
        assert r.read_i32(10).shape == (10, 1)


def test_bad_files_raise_like_jax(tmp_path):
    p = str(tmp_path / "x.flac")
    with open(p, "wb") as f:
        f.write(b"fLaCgarbage")
    assert flac.is_flac(p) and not flac.is_flac(__file__)
    with pytest.raises(flac.FlacError):
        flac.FlacReader(p)
    with pytest.raises(jflac.FlacError):
        jflac.FlacReader(p)
    assert audio.load_audio(p) == (None, None) == jaudio.load_audio(p)


def test_malformed_first_frame_seek_terminates(tmp_path):
    """A stream whose first frame number is nonzero: the seek to 0 ends
    (in a subprocess, so a regression is a timeout, not a hang) at the
    position the JAX reader reaches."""
    data = (np.arange(2 * BS) % 97).astype(np.int16)
    p = str(tmp_path / "mal.flac")
    flac_ref.write_flac(p, data, 22050, bits=16, first_frame_number=10)
    pos = {}
    for pkg in ("softspoken_tpu_torch", "softspoken_tpu"):
        code = (f"from {pkg}.io import flac\n"
                f"r = flac.FlacReader({p!r})\nr.seek(0)\nprint(r._pos)\nr.close()\n")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120, cwd=ROOT,
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert res.returncode == 0, res.stderr
        pos[pkg] = res.stdout.split()[-1]
    assert pos["softspoken_tpu_torch"] == pos["softspoken_tpu"]


@pytest.mark.parametrize("dtype,name", [("f32", "stereo16-short-last-block"),
                                        ("i16", "mono16"), ("f32", "mono24"),
                                        ("i16", "mono8")])
def test_sequential_reader_chunks_concatenate(tmp_path, dtype, name):
    """Overlapping, forward and backward ranges of SequentialMonoReader
    equal the JAX reader's, and the chunks concatenated are the file."""
    p, x = _write(tmp_path, name)
    n = len(x)
    ranges = [(0, 3000), (2500, 3000), (5500, 1), (5501, 4000), (1000, 200),
              (9000, n)]
    with flac.SequentialMonoReader(p, dtype=dtype) as r, \
            jflac.SequentialMonoReader(p, dtype=dtype) as j:
        for s, k in ranges:
            np.testing.assert_array_equal(r.read(s, k), j.read(s, k))
    with flac.SequentialMonoReader(p, dtype=dtype) as r:
        parts = [r.read(s, 1777) for s in range(0, n, 1777)]
    with flac.SequentialMonoReader(p, dtype=dtype) as r:
        whole = r.read(0, n)
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    if dtype == "i16":
        bits = FIXTURES[name][0]["bits"]
        np.testing.assert_array_equal(whole, (x[:, 0] << (16 - bits)).astype(np.int16))


def test_i16_sequential_reader_rejects_stereo_and_wide(tmp_path):
    for name in ("stereo16-short-last-block", "mono24"):
        p, _ = _write(tmp_path, name)
        with pytest.raises(ValueError):
            flac.SequentialMonoReader(p, dtype="i16")


def test_reads_are_counted_as_native_calls(tmp_path):
    p, _ = _write(tmp_path, "mono16")
    before = NATIVE_CALLS["flac_read_i32"]
    flac.read(p)
    assert NATIVE_CALLS["flac_read_i32"] > before


# ---------------------------------------------------------------------------
# detect on a FLAC
# ---------------------------------------------------------------------------
PARITY = dict(precision="parity", device_batch=4, chunk_seconds=6.0)


def _pair(tmp_path, x16, sr, bits=16):
    """The same samples as a FLAC and as a WAV (PCM16, or float for >16 bits)."""
    fp, wp = str(tmp_path / "d.flac"), str(tmp_path / "d.wav")
    flac_ref.write_flac(fp, x16, sr, bits=bits)
    scale = float(1 << (bits - 1))
    jwavio.write(wp, (x16 / scale).astype(np.float32), sr,
                 subtype="PCM_16" if bits == 16 else "FLOAT")
    return fp, wp


def _det(**eng):
    return Detector(Config().with_engine(**PARITY, **eng),
                    state_dict=fixture_state_dict(0), device="cpu")


@pytest.mark.parametrize("sr", [22050, 32000])
def test_fused_flac_grid_is_bit_equal_to_the_wav(tmp_path, sr):
    """Mono 16-bit FLAC rides the int16 wire like the PCM16 WAV: the grids
    are bit-equal, and the intervals equal the JAX package's fused ones."""
    rng = np.random.default_rng(8)
    x16 = np.clip(np.rint(9000 * rng.standard_normal(8 * sr)), -32768, 32767
                  ).astype(np.int64)
    fp, wp = _pair(tmp_path, x16, sr)
    det = _det(pipeline="fused")
    rf, rw = det.detect_file_streaming(fp), det.detect_file_streaming(wp)
    assert rf.num_windows == rw.num_windows
    np.testing.assert_array_equal(rf.avg_values, rw.avg_values)
    assert rf.intervals == rw.intervals
    jdet = JDetector(JConfig().with_engine(**PARITY, pipeline="fused"),
                     variables=jckpt.fixture_variables(seed=0))
    ref = jdet.detect_file_fused(fp)
    np.testing.assert_allclose(rf.avg_values, ref.avg_values, atol=1e-5)
    assert rf.intervals == ref.intervals


def test_fused_stereo24_flac_rides_the_f32_wire(tmp_path):
    """A stereo 24-bit FLAC decodes and downmixes on its sequential reader:
    its grid is bit-equal to the same samples as a float WAV (both on the
    f32 wire; the sum of two 24-bit samples is exact in float32, so both
    downmixes give the same floats)."""
    x = _ints(6 * 22050, 2, 24, seed=11)
    fp, wp = _pair(tmp_path, x, 22050, bits=24)
    det = _det(pipeline="fused")
    rf, rw = det.detect_file_streaming(fp), det.detect_file_streaming(wp)
    assert rf.num_windows == rw.num_windows
    np.testing.assert_array_equal(rf.avg_values, rw.avg_values)
    assert rf.intervals == rw.intervals


def test_host_flac_equals_wav_and_jax(tmp_path):
    rng = np.random.default_rng(9)
    x16 = np.clip(np.rint(9000 * rng.standard_normal(8 * 32000)), -32768, 32767
                  ).astype(np.int64)
    fp, wp = _pair(tmp_path, x16, 32000)
    det = _det(pipeline="host")
    for run in (det.detect_file, det.detect_file_streaming):
        rf, rw = run(fp), run(wp)
        np.testing.assert_allclose(rf.avg_values, rw.avg_values, atol=1e-6)
        assert rf.intervals == rw.intervals
    jdet = JDetector(JConfig().with_engine(**PARITY, pipeline="host"),
                     variables=jckpt.fixture_variables(seed=0))
    ref = jdet.detect_file(fp)
    got = det.detect_file(fp)
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-5)
    assert got.intervals == ref.intervals


def test_cli_detects_a_flac(tmp_path):
    from softspoken_tpu_torch import cli

    rng = np.random.default_rng(10)
    x16 = np.clip(np.rint(9000 * rng.standard_normal(4 * 22050)), -32768, 32767
                  ).astype(np.int64)
    fp, _ = _pair(tmp_path, x16, 22050)
    rc = cli.main(["detect", "--files", fp, "--out", str(tmp_path / "d.csv"),
                   "--random-init", "--device", "cpu", "--device-batch", "4"])
    assert rc == 0
