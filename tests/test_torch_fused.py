"""The port's whole slice (WAV → fused chunk program → intervals) against the
JAX package's fused pipeline on the CPU, at full model width and short audio
(device_batch=4, short chunks, as tests/test_fused.py).

Fused is held against fused only: the host pipeline differs at the ±3 s pad
joins by design (softspoken_tpu/engine/fused.py:17-22); test_torch_host.py
holds the host pipeline.  "auto" is host on the CPU, so every case here pins
pipeline="fused".
"""

import csv
import os

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import detect_file_fused as jax_detect_file_fused
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu_torch import Config
from softspoken_tpu_torch import cli
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import detect_file_fused

torch.set_num_threads(2)

PARITY = dict(precision="parity", device_batch=4, pipeline="fused")


def _wav(tmp_path, sr, seconds, subtype="PCM_16", channels=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = (int(sr * seconds),) if channels == 1 else (int(sr * seconds), channels)
    x = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    p = str(tmp_path / f"f_{sr}_{subtype}_{channels}_{seed}.wav")
    jwavio.write(p, x, sr, subtype=subtype)
    return p


def _jax(path, **eng):
    det = JDetector(JConfig().with_engine(**eng), variables=jckpt.fixture_variables(seed=0))
    return jax_detect_file_fused(det, path)


def _port(path, **eng):
    det = Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                   device="cpu")
    return detect_file_fused(det, path)


CASES = [
    # (sample rate, seconds, subtype, channels, chunk_seconds)
    pytest.param(22050, 8.0, "PCM_16", 1, 6.0, id="22050-pcm16-no-resampler"),
    pytest.param(32000, 10.0, "PCM_16", 1, 6.0, id="32000-pcm16-polyphase"),
    pytest.param(44100, 9.0, "FLOAT", 1, 6.0, id="44100-float-f32-wire"),
    pytest.param(16000, 9.0, "FLOAT", 2, 6.0, id="16000-float-stereo-downmix"),
    pytest.param(22050, 20.0, "PCM_16", 1, 12.0, id="22050-multi-chunk"),
    pytest.param(32000, 21.0, "PCM_16", 1, 6.0, id="32000-multi-chunk"),
]


@pytest.mark.parametrize("sr,seconds,subtype,channels,chunk", CASES)
def test_fused_matches_jax_parity(tmp_path, sr, seconds, subtype, channels, chunk):
    """float32 on both sides with the same windows, grid and carry: equal
    windows and intervals; 1e-4 on the averaged grid covers summation order
    (measured ~6e-8)."""
    p = _wav(tmp_path, sr, seconds, subtype, channels, seed=sr)
    ref = _jax(p, chunk_seconds=chunk, **PARITY)
    got = _port(p, chunk_seconds=chunk, **PARITY)
    assert got.num_windows == ref.num_windows > 0
    assert got.avg_values.shape == ref.avg_values.shape
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals
    assert got.audio_seconds == pytest.approx(ref.audio_seconds)


# mel precision through the fused-kernel route (plain version on the CPU)
# against the JAX kernel in interpret mode.  "highest"/"high": the frontends
# agree to ~1e-5 (test_torch_mel.py), which the U-Net carries to ~1e-5.
# "default": the JAX kernel's frame 0 runs in float32 on the CPU and the
# port's in bf16 (~1e-2 on one of 256 frames per window); measured ~1e-3 on
# the grid, bound 1e-2.
@pytest.mark.parametrize("mode,tol", [("highest", 1e-4), ("high", 1e-4), ("default", 1e-2)])
def test_fused_kernel_route_matches_jax(tmp_path, mode, tol):
    p = _wav(tmp_path, 22050, 8.0, seed=3)
    eng = dict(PARITY, chunk_seconds=6.0, mel_kernel="fused", mel_precision=mode)
    ref, got = _jax(p, **eng), _port(p, **eng)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=tol)


def test_chunked_equals_unchunked(tmp_path):
    """The inter-chunk carry makes chunking invisible; 1e-6 covers the
    carry's summation order."""
    p = _wav(tmp_path, 32000, 21.0, seed=5)
    multi = _port(p, chunk_seconds=6.0, **PARITY)
    single = _port(p, chunk_seconds=60.0, **PARITY)
    assert multi.num_windows == single.num_windows
    np.testing.assert_allclose(multi.avg_values, single.avg_values, atol=1e-6)
    assert multi.intervals == single.intervals


def test_subwindow_file(tmp_path):
    p = _wav(tmp_path, 22050, 0.5, seed=1)
    ref, got = _jax(p, chunk_seconds=6.0, **PARITY), _port(p, chunk_seconds=6.0, **PARITY)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)


def test_cli_writes_the_reference_csv(tmp_path):
    """`detect` through the CLI writes the same rows as the JAX package's
    pandas-backed store would for the same intervals."""
    p = _wav(tmp_path, 22050, 8.0, seed=9)
    out = str(tmp_path / "d.csv")
    conf = tmp_path / "c.json"
    conf.write_text('{"engine": {"chunk_seconds": 6.0, "pipeline": "fused"}}')
    args = ["--out", out, "--random-init", "--device-batch", "4", "--device", "cpu",
            "--config", str(conf)]
    assert cli.main(["detect", "--files", p, "--precision", "parity", *args]) == 0
    ref = _jax(p, chunk_seconds=6.0, **PARITY)
    jstore = JStore(str(tmp_path / "j.csv"))
    jstore.append_intervals(os.path.abspath(p), ref.intervals)
    jstore.save()
    with open(out) as a, open(tmp_path / "j.csv") as b:
        assert list(csv.reader(a)) == list(csv.reader(b))
    # a second run skips the processed file and leaves the CSV as it was
    assert cli.main(["detect", "--files", p, *args]) == 0
    with open(out) as a, open(tmp_path / "j.csv") as b:
        assert a.read() == b.read()


def test_cli_fails_on_an_unreadable_file(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    rc = cli.main(["detect", "--files", str(bad), "--out", str(tmp_path / "d.csv"),
                   "--random-init", "--device", "cpu", "--device-batch", "4"])
    assert rc == 1


@pytest.mark.parametrize("eng", [
    dict(upload_codec="mulaw8"), dict(chunk_checkpoint_every=2),
], ids=["mulaw8-wire", "journal"])
def test_later_slices_raise(tmp_path, eng):
    p = _wav(tmp_path, 22050, 1.0)
    with pytest.raises(NotImplementedError):
        Detector(Config().with_engine(pipeline="fused", **eng),
                 state_dict=fixture_state_dict(0), device="cpu").detect_file_streaming(p)
