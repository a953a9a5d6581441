"""The detect paths on the card: the fused path with K1 and the host path
with K2 (``mel_kernel="pallas"``) in parity mode (float32, TF32 off, so
that a grid speaks for the path) against themselves and the CPU, each
kernel launched once per batch, and two fast runs bit-equal.

Card only (the kernels have no CPU mode); the command is in
tests/test_torch_cuda.py's docstring.
"""

import numpy as np
import pytest

from torch_cuda_helpers import counted_detect, field_wav, need_card

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def wav60(tmp_path_factory):
    need_card()  # before any work: the test skips without a card
    return field_wav(str(tmp_path_factory.mktemp("detect") / "field_60s.wav"), 60.0, 32000, 5)


@pytest.fixture(scope="module")
def wav400(tmp_path_factory):
    """Three default chunks (150 s) at 32 kHz."""
    need_card()  # before any work: the test skips without a card
    return field_wav(str(tmp_path_factory.mktemp("detect") / "field_400s.wav"), 400.0, 32000, 11)


def test_fused_parity_chunked_equals_unchunked(wav60):
    """The same float32 program over other chunk boundaries: only the
    carry's summation order differs (1e-5); the fast path's grid on the
    same file is finite and as long."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    sd = fixture_state_dict(0)
    par = Config().with_engine(precision="parity", pipeline="fused")
    whole = Detector(par, state_dict=sd).detect_file_streaming(wav60)
    chunked = Detector(par.with_engine(chunk_seconds=12.0), state_dict=sd
                       ).detect_file_streaming(wav60)
    assert np.isfinite(whole.avg_values).all()
    assert float(np.abs(whole.avg_values - chunked.avg_values).max()) <= 1e-5
    assert chunked.intervals == whole.intervals
    fast = Detector(Config(), state_dict=sd).detect_file_streaming(wav60)
    assert np.isfinite(fast.avg_values).all() and len(fast.avg_values) == len(whole.avg_values)


def test_fused_parity_on_the_card_equals_the_cpu(wav60):
    """Float32 with TF32 off on both; cuDNN and the CPU sum convolutions in
    other orders, which the U-Net amplifies to ~1e-5 (1e-4)."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    sd = fixture_state_dict(0)
    small = Config().with_engine(precision="parity", pipeline="fused", device_batch=8,
                                 chunk_seconds=12.0)
    card = Detector(small, state_dict=sd).detect_file_streaming(wav60)
    cpu = Detector(small, state_dict=sd, device="cpu").detect_file_streaming(wav60)
    assert float(np.abs(card.avg_values - cpu.avg_values).max()) <= 1e-4
    assert card.intervals == cpu.intervals


def test_host_parity_on_the_card_equals_the_cpu_and_streams(wav60):
    """The host path with K2: card == CPU (float32 with TF32 off on both;
    K2 and cuDNN sum in other orders than the CPU: 1e-4), and streaming
    with either resampler == in memory on the card (the same program over
    audio resampled chunk by chunk, on the card by a float32 GEMM: 1e-5)."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    sd = fixture_state_dict(0)
    par = Config().with_engine(precision="parity", pipeline="host", mel_kernel="pallas",
                               device_batch=8, chunk_seconds=12.0)
    card = Detector(par, state_dict=sd).detect_file(wav60)
    cpu = Detector(par, state_dict=sd, device="cpu").detect_file(wav60)
    assert np.isfinite(card.avg_values).all() and card.num_windows == cpu.num_windows
    assert float(np.abs(card.avg_values - cpu.avg_values).max()) <= 1e-4
    assert card.intervals == cpu.intervals
    for backend in ("host", "auto"):
        det = Detector(par.with_engine(resample_backend=backend), state_dict=sd)
        stream = det.detect_file_streaming(wav60)
        assert float(np.abs(stream.avg_values - card.avg_values).max()) <= 1e-5, backend
        assert stream.intervals == card.intervals, backend


def test_fused_fast_detect_launches_k1_once_per_batch(wav400):
    """The main path (fast, the CLI's defaults) over three chunks: K1 once
    for each batch of every chunk, no other hand kernel."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine

    det = Detector(Config(), state_dict=fixture_state_dict(0))
    _res, counted, launches, _calls = counted_detect(det, wav400)
    nb = get_fused_engine(det, 32000, "i16").nb
    assert counted["chunks"] == 3
    assert launches["frame_mel"] == counted["batches"] == 3 * nb
    assert launches.get("dft_mel", 0) == launches.get("adpcm_decode", 0) == 0


def test_host_detect_launches_k2_on_every_batch(wav400):
    """The host path at full width with ``mel_kernel="pallas"``: K2 on
    every batch (whole chunks, and the ragged tail padded to whole
    batches), decoding through the native library."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
    from softspoken_tpu_torch.io import internal_length, native
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

    det = Detector(Config().with_engine(pipeline="host", mel_kernel="pallas"),
                   state_dict=fixture_state_dict(0))
    cfg = det.cfg
    n_windows = num_windows_for_padded_length(
        internal_length(wav400, cfg.dsp.sample_rate) + 2 * cfg.pad_samples, cfg)
    B, chunk_w = cfg.engine.device_batch, det.chunk_windows()
    full, tail = divmod(n_windows, chunk_w)
    reset_launch_counts()
    native.reset_call_counts()
    res = det.detect_file(wav400)
    assert res.num_windows == n_windows
    assert KERNEL_LAUNCHES["dft_mel"] >= full * (chunk_w // B) + -(-tail // B)
    assert KERNEL_LAUNCHES.get("frame_mel", 0) == 0
    assert native.NATIVE_CALLS.get("resample_f32") and native.NATIVE_CALLS.get("pcm16_to_mono_f32")


def test_two_fused_fast_runs_are_bit_equal(wav400):
    """The trained weights in fast mode (bf16, K1) over three chunks, twice
    in one process: the same grid and intervals, bit for bit."""
    need_card()
    from softspoken_tpu_torch.engine import Detector

    det = Detector()
    a, b = det.detect_file_streaming(wav400), det.detect_file_streaming(wav400)
    np.testing.assert_array_equal(a.avg_values, b.avg_values)
    assert a.intervals == b.intervals
