"""The port's host pipeline (decode/resample on the host, one upload and one
fetch per chunk, the grid averaged on the host) against the JAX package's
host pipeline on the CPU: parity mode on both sides, the full-width U-Net
with the fixture weights, device_batch=4 and short chunks, so every file
below spans several chunks and ends in a ragged, padded batch.

Held host to host, never against fused: the two pipelines pad in different
domains by design (softspoken_tpu/engine/fused.py:17-22).  Grids agree to
1e-4 (float32 on both sides, other summation orders, as
test_torch_fused.py), intervals exactly; resampled audio to 1e-5 (scipy in
float64 here, the JAX package's C++ polyphase or the same scipy call
there).
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine import regions as jregions
from softspoken_tpu.io import load_audio as jload_audio
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.io.resample import resample as jresample
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu_torch import Config, cli
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine import regions
from softspoken_tpu_torch.engine.detector import resolve_pipeline, resolve_resample_backend
from softspoken_tpu_torch.io import (audio, internal_length, load_audio,
                                     load_audio_startstop, resample, stream_chunks)
from softspoken_tpu_torch.project import DetectionStore
from softspoken_tpu_torch.runtime import DetectRunner
from softspoken_tpu_torch.runtime import workers

torch.set_num_threads(2)

HOST = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="host")
GRID_ATOL = 1e-4
AUDIO_ATOL = 1e-5


def _wav(tmp_path, sr, seconds, subtype="PCM_16", channels=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = (int(sr * seconds),) if channels == 1 else (int(sr * seconds), channels)
    x = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    p = str(tmp_path / f"h_{sr}_{subtype}_{channels}_{seed}.wav")
    jwavio.write(p, x, sr, subtype=subtype)
    return p


def _jdet(**eng):
    return JDetector(JConfig().with_engine(**eng), variables=jckpt.fixture_variables(seed=0))


def _pdet(**eng):
    return Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0),
                    device="cpu")


def _same(got, ref):
    assert got.num_windows == ref.num_windows > 0
    assert got.avg_values.shape == ref.avg_values.shape
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=GRID_ATOL)
    assert got.intervals == ref.intervals
    assert got.audio_seconds == pytest.approx(ref.audio_seconds)


# ---------------------------------------------------------------------------
# the pipeline end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sr", [22050, 32000], ids=["22050-no-resampler", "32000-host-resampler"])
def test_detect_file_matches_jax(tmp_path, sr):
    p = _wav(tmp_path, sr, 5.0, seed=sr)
    _same(_pdet(**HOST).detect_file(p), _jdet(**HOST).detect_file(p))


@pytest.mark.parametrize("backend", ["host", "device"])
def test_detect_file_streaming_matches_jax(tmp_path, backend):
    p = _wav(tmp_path, 32000, 5.0, seed=7)
    eng = dict(HOST, resample_backend=backend)
    _same(_pdet(**eng).detect_file_streaming(p), _jdet(**eng).detect_file_streaming(p))


def test_multi_chunk_file_matches_jax(tmp_path):
    """3 s chunks: 4 windows a chunk, 14 windows, the last chunk ragged."""
    p = _wav(tmp_path, 22050, 5.0, seed=4)
    eng = dict(HOST, chunk_seconds=3.0)
    det = _pdet(**eng)
    assert det.chunk_windows() == 4
    got = det.detect_file_streaming(p)
    assert got.num_windows == 14
    _same(got, _jdet(**eng).detect_file_streaming(p))


def test_subwindow_file_matches_jax(tmp_path):
    p = _wav(tmp_path, 22050, 0.5, seed=1)
    _same(_pdet(**HOST).detect_file(p), _jdet(**HOST).detect_file(p))


@pytest.mark.parametrize("pipeline", ["host", "fused"])
def test_pallas_kernel_route_matches_jax(tmp_path, pipeline):
    """mel_kernel="pallas" (K2's plain version here, the Pallas kernel in
    interpret mode there) on either pipeline, against the same setting."""
    p = _wav(tmp_path, 22050, 5.0, seed=8)
    eng = dict(HOST, pipeline=pipeline, mel_kernel="pallas")
    det = _pdet(**eng)
    assert det.mel_kernel == "pallas"
    _same(det.detect_file_streaming(p), _jdet(**eng).detect_file_streaming(p))


def test_process_batch_matches_jax():
    rng = np.random.default_rng(9)
    padded = (0.2 * rng.normal(size=66150 * 2)).astype(np.float32)
    idx = [0, 13230, 66150 + 17]  # the last window runs past the audio: zero-filled
    spec, mask = _pdet(**HOST).process_batch(padded, idx)
    jspec, jmask = _jdet(**HOST).process_batch(padded, idx)
    assert spec.shape == jspec.shape == (3, 2, 128, 256)
    assert mask.shape == jmask.shape == (3, 1, 256)
    np.testing.assert_allclose(spec, jspec, atol=GRID_ATOL)
    np.testing.assert_allclose(mask, jmask, atol=GRID_ATOL)


def test_process_batch_empty_and_int32_guard():
    det = _pdet(**HOST)
    spec, mask = det.process_batch(np.zeros(66150, np.float32), [])
    assert spec.shape == (0, 2, 128, 256) and mask.shape == (0, 1, 256)
    with pytest.raises(ValueError, match="int32"):
        det.process_batch(np.zeros(66150, np.float32), [2**31])


def test_waveform_apis_and_reference_shapes_match_jax(tmp_path):
    """detect_waveform, mask_logits_for_padded, averaged_detections and
    plan_detection_job on one waveform."""
    rng = np.random.default_rng(3)
    wave = rng.uniform(-0.5, 0.5, int(22050 * 2.5)).astype(np.float32)
    det, jdet = _pdet(**HOST), _jdet(**HOST)
    got, ref = det.detect_waveform(wave), jdet.detect_waveform(wave)
    _same(got, ref)
    a, b = got.averaged_detections(), ref.averaged_detections()
    assert [t for _, t in a] == [t for _, t in b]
    np.testing.assert_allclose([v for v, _ in a], [v for v, _ in b], atol=GRID_ATOL)
    padded = np.pad(wave, 3 * 22050)
    np.testing.assert_allclose(det.mask_logits_for_padded(padded),
                               jdet.mask_logits_for_padded(padded), atol=GRID_ATOL)
    p = _wav(tmp_path, 32000, 7.3, seed=2)
    plan, jplan = det.plan_detection_job([p]), jdet.plan_detection_job([p])
    np.testing.assert_array_equal(plan[p], jplan[p])


def test_average_grid_host_equals_jax():
    logits = np.random.default_rng(5).standard_normal((23, 256)).astype(np.float32)
    for step in (0.6, 0.5):
        s, c = regions.average_grid_host(logits, step)
        js, jc = jregions.average_grid_host(logits, step)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(c, jc)
    assert all(len(a) == 0 for a in regions.average_grid_host(np.zeros((0, 256)), 0.6))


# ---------------------------------------------------------------------------
# decode and resample
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sr", [32000, 44100, 16000])
def test_host_resample_matches_jax(sr):
    x = np.random.default_rng(sr).normal(0, 0.3, sr * 2).astype(np.float32)
    got, want = resample(x, sr, 22050), jresample(x, sr, 22050)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)


@pytest.mark.parametrize("subtype,channels", [("PCM_16", 1), ("FLOAT", 2)])
def test_load_audio_matches_jax(tmp_path, subtype, channels):
    p = _wav(tmp_path, 32000, 3.0, subtype, channels, seed=6)
    got, sr = load_audio(p)
    want, jsr = jload_audio(p)
    assert sr == jsr == 22050 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)
    # a 3 s slice at an internal-rate offset, and a seconds range
    got, _ = load_audio(p, start=13230)
    want, _ = jload_audio(p, start=13230)
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)
    from softspoken_tpu.io import load_audio_startstop as jstartstop

    got, _ = load_audio_startstop(p, (0.5, 9.0))  # stop clamps at EOF
    want, _ = jstartstop(p, (0.5, 9.0))
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL)
    assert load_audio_startstop(p, (2.0, 1.0)) == (None, None)


def test_stream_chunks_matches_full_load(tmp_path):
    """As tests/test_resample.py: chunks concatenated are load_audio."""
    x = np.random.default_rng(1).normal(0, 0.2, (120000, 2)).astype(np.float32)
    p = str(tmp_path / "s.wav")
    jwavio.write(p, x, 32000, subtype="FLOAT")
    full, sr = load_audio(p)
    parts = []
    for chunk in stream_chunks(p, chunk_samples=17001):
        assert chunk.start_sample == sum(len(q) for q in parts)
        assert chunk.total_samples == len(full) == internal_length(p)
        parts.append(chunk.data)
    assert chunk.is_last
    got = np.concatenate(parts)
    assert len(got) == len(full)
    np.testing.assert_allclose(got, full, atol=1e-6)


def test_stream_chunks_native_rate_is_exact(tmp_path):
    x = np.random.default_rng(2).normal(0, 0.2, 50000).astype(np.float32)
    p = str(tmp_path / "n.wav")
    jwavio.write(p, x, 22050, subtype="FLOAT")
    for backend in ("host", "device"):
        got = np.concatenate([c.data for c in stream_chunks(p, 9999, backend=backend,
                                                            device="cpu")])
        np.testing.assert_array_equal(got, load_audio(p)[0])


def test_device_resampler_matches_host(tmp_path):
    """The polyphase GEMM per chunk (here on the CPU) against scipy."""
    x = np.random.default_rng(0).uniform(-0.6, 0.6, 32000 * 6).astype(np.float32)
    p = str(tmp_path / "r.wav")
    jwavio.write(p, x, 32000, subtype="PCM_16")
    host = np.concatenate([c.data for c in stream_chunks(p, 50000, backend="host")])
    dev = np.concatenate([c.data for c in stream_chunks(p, 50000, backend="device",
                                                        device="cpu")])
    assert host.shape == dev.shape
    np.testing.assert_allclose(dev, host, atol=AUDIO_ATOL)
    np.testing.assert_allclose(dev, jload_audio(p)[0], atol=AUDIO_ATOL)


def test_device_resampler_guards_its_alignment():
    from softspoken_tpu_torch.io.resample import get_device_resampler

    rs = get_device_resampler(32000, 22050, 5000, torch.device("cpu"))
    assert rs is get_device_resampler(32000, 22050, 5000, torch.device("cpu"))
    with pytest.raises(ValueError):
        rs.resample_range(lambda s, n: np.zeros(n, np.float32), 10**6, 0, 5001)


def test_corrupt_and_unported_files(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all, nor any other audio format")
    assert load_audio(str(bad)) == (None, None)
    assert jload_audio(str(bad)) == (None, None)
    with pytest.raises(IOError):
        _pdet(**HOST).detect_file(str(bad))
    flac = tmp_path / "x.flac"
    flac.write_bytes(b"fLaC" + bytes(60))
    with pytest.raises(NotImplementedError, match="FLAC"):
        load_audio(str(flac))
    with pytest.raises(NotImplementedError, match="FLAC"):
        _pdet(**HOST).detect_file_streaming(str(flac))
    ogg = tmp_path / "x.opus"
    ogg.write_bytes(b"OggS" + bytes(24) + b"OpusHead" + bytes(30))
    with pytest.raises(NotImplementedError, match="Opus"):
        audio.get_audio_data(str(ogg))


# ---------------------------------------------------------------------------
# pipeline choice, runner and CLI
# ---------------------------------------------------------------------------
def test_auto_means_fused_on_the_card_and_host_on_the_cpu():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_pipeline("auto", cuda) == "fused"
    assert resolve_pipeline("auto", cpu) == "host"
    assert resolve_pipeline("fused", cpu) == "fused"
    assert resolve_resample_backend("auto", cuda) == "device"
    assert resolve_resample_backend("auto", cpu) == "host"
    with pytest.raises(ValueError):
        resolve_pipeline("xla", cpu)
    det = Detector(Config(), state_dict=fixture_state_dict(0), device="cpu")
    assert (det.pipeline, det.resample_backend) == ("host", "host")


def test_runner_streams_like_the_jax_runner(tmp_path, monkeypatch):
    p = _wav(tmp_path, 22050, 0.2)
    store = DetectionStore(str(tmp_path / "d.csv"))
    host = DetectRunner(_pdet(**HOST), store)
    assert not host._use_streaming(p)                      # small file: in memory
    assert DetectRunner(_pdet(**HOST), store, streaming=True)._use_streaming(p)
    assert DetectRunner(_pdet(**dict(HOST, pipeline="fused")), store)._use_streaming(p)
    monkeypatch.setattr(workers, "STREAM_ABOVE_BYTES", 1000)
    assert host._use_streaming(p)                          # "over 1 GiB"


@pytest.mark.parametrize("engine,streaming", [
    ({"pipeline": "host"}, False), ({"pipeline": "host"}, True), ({}, False),
], ids=["in-memory", "streaming", "auto-on-cpu"])
def test_cli_host_config_writes_the_jax_rows(tmp_path, engine, streaming):
    """`detect --config {"engine": {"pipeline": "host"}}` writes the rows the
    JAX package's host pipeline gives; the in-memory run decodes on the
    prefetch thread, --streaming streams, and "auto" on --device cpu is the
    host pipeline in memory."""
    p = _wav(tmp_path, 32000, 5.0, seed=9)
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"engine": dict(engine, chunk_seconds=6.0)}))
    out = str(tmp_path / "d.csv")
    args = ["detect", "--files", p, "--out", out, "--random-init", "--device-batch", "4",
            "--device", "cpu", "--precision", "parity", "--config", str(conf)]
    report = cli.cmd_detect(cli.build_parser().parse_args(
        args + (["--streaming"] if streaming else [])))
    assert report["files_done"] == 1 and not report["errors"]
    assert ("decode" in report["stage_seconds"]) is not streaming
    assert report["stage_seconds"]["fetch"] > 0
    ref = _jdet(**HOST).detect_file(p)
    jstore = JStore(str(tmp_path / "j.csv"))
    jstore.append_intervals(os.path.abspath(p), ref.intervals)
    jstore.save()
    with open(out) as a, open(tmp_path / "j.csv") as b:
        assert list(csv.reader(a)) == list(csv.reader(b))


def test_runner_records_unreadable_files_and_goes_on(tmp_path):
    good = _wav(tmp_path, 22050, 0.5)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    flac = tmp_path / "x.flac"
    flac.write_bytes(b"fLaC" + bytes(60))
    store = DetectionStore(str(tmp_path / "d.csv"))
    report = DetectRunner(_pdet(**HOST), store).run([str(bad), str(flac), good])
    assert report.files_done == 1
    assert set(report.errors) == {str(bad), str(flac)}
    assert report.errors[str(bad)].startswith("OSError")
    assert report.errors[str(flac)].startswith("NotImplementedError")
