"""The plain reference against itself and against a small CPU run of the
port on the same seeded recording."""

import numpy as np
import pytest
import torch

import benchcopy

from benchmarks.harness import registry
from benchmarks.reference import audio, detect, grid, mel

WEIGHTS = f"{benchcopy.REPO}/root/models/spec_unet_2d/model_checkpoint.pth"


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    gen = registry.load_module("generators", "field_recordings")
    out = tmp_path_factory.mktemp("rec")
    params = dict(files=1, seconds=8.0, sample_rate=48000, speech_share=0.35,
                  event_seconds=[1.0, 3.0], snr_db=[10.0, 20.0], bed_tile_seconds=4.0,
                  bed_bank=2)
    return gen.generate(params, 2**31 + 11, str(out))[0]


def test_the_generator_is_seeded_and_sized(tmp_path):
    gen = registry.load_module("generators", "field_recordings")
    params = dict(files=2, seconds=3.0, sample_rate=32000, speech_share=0.075,
                  event_seconds=[1.0, 2.0], snr_db=[0.0, 20.0], bed_tile_seconds=2.0,
                  bed_bank=2)
    a = gen.generate(params, 7, str(tmp_path / "a"))
    b = gen.generate(params, 7, str(tmp_path / "b"))
    c = gen.generate(params, 8, str(tmp_path / "c"))
    for x, y, z in zip(a, b, c):
        assert x["frames"] == y["frames"] == z["frames"] == 96000
        assert open(x["path"], "rb").read() == open(y["path"], "rb").read()
        assert open(x["path"], "rb").read() != open(z["path"], "rb").read()
        pcm, sr = audio.read_wav(x["path"])
        assert sr == 32000 and len(pcm) == 96000


def test_reference_mel_is_torch_stft(recording):
    wave = detect.internal_wave(recording["path"])
    x = torch.from_numpy(np.stack([wave[:66150], wave[13230:13230 + 66150]]))
    with detect.no_tf32():
        got = mel.LogMel("cpu")(x)
    want = mel.stft_log_mel(x)
    assert got.shape == (2, 128, 256)
    assert torch.max(torch.abs(got - want)).item() < 1e-4


def test_reference_resampler_is_the_ports_host_resampler(recording):
    from softspoken_tpu_torch.io.resample import resample as port_resample

    pcm, sr = audio.read_wav(recording["path"])
    x = pcm[:96000].astype(np.float64) / 32768.0
    got = audio.resample(x, sr, 22050)
    want = port_resample(x.astype(np.float32), sr, 22050)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-5


def test_reference_matches_the_port_in_parity(recording):
    """The port's fused pipeline in parity precision (float32, plain mel
    chain) on the CPU holds to the reference within float32 rounding, and
    gives the same regions."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector

    cfg = Config().with_engine(precision="parity", pipeline="fused", device_batch=8,
                               chunk_seconds=4.8)
    port = Detector(cfg, checkpoint_path=WEIGHTS, device="cpu").detect_file_streaming(
        recording["path"])
    ref = detect.Detector(WEIGHTS, "cpu", "float32", batch=8).detect(recording["path"])
    p = np.asarray(port.avg_values, np.float64)
    assert p.shape == ref.grid.shape
    assert np.max(np.abs(p - ref.grid)) < 2e-3
    assert np.sqrt(np.sum((p - ref.grid) ** 2) / np.sum(ref.grid ** 2)) < 1e-4
    assert port.intervals == grid.regions(p)
    assert ref.intervals, "the recording should hold speech"


def test_the_control_reads_far_from_the_reference(recording):
    wave = detect.internal_wave(recording["path"])
    f32 = detect.Detector(WEIGHTS, "cpu", "float32").detect_wave(wave)
    q8 = detect.Detector(WEIGHTS, "cpu", "fp8").detect_wave(wave)
    rel = np.sqrt(np.sum((q8.grid - f32.grid) ** 2) / np.sum(f32.grid ** 2))
    assert rel > 0.02
