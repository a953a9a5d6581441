"""Tests of the port that need the CUDA card (the kernels have no CPU mode).

They import neither JAX nor the JAX package, so they also run on a machine
with only PyTorch; there, skip the repo's conftest (which sets up JAX):

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
from softspoken_tpu_torch.ops import dft_mel as dm
from softspoken_tpu_torch.ops import frame_mel as fm
from softspoken_tpu_torch.ops import mel as melops

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _buf_and_starts():
    # the fixture of tests/test_pallas_frame_mel.py, plus a window flush
    # with the buffer's end
    rng = np.random.default_rng(7)
    buf = rng.standard_normal(66150 + 4 * 13230 + 300).astype(np.float32)
    starts = np.array([0, 174, 13230, 2 * 13230, 3 * 13230, buf.size - 66150], np.int32)
    return torch.from_numpy(buf).cuda(), torch.from_numpy(starts).cuda()


@pytest.mark.parametrize("mode", ["highest", "high", "default"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_frame_mel_kernel_matches_plain_version(mode, out_dtype):
    """"default"/"high": same operands, same rounding, only the summation
    order differs; "highest": the kernel's six-pass bf16 split against a
    float32 product, terms of weight 2^-24 dropped (1e-4 at float32 out;
    one bf16 ulp below 4, 2**-6, at bf16 out)."""
    _need_card()
    buf, starts = _buf_and_starts()
    before = KERNEL_LAUNCHES[fm.NAME]
    got = fm.log_mel_windows_fused(buf, starts, mode, out_dtype)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[fm.NAME] == before + 1
    assert got.dtype == out_dtype and got.shape == (6, 128, 256)
    ref = fm.log_mel_windows_fused_ref(buf, starts, mode, out_dtype)
    tol = 1e-4 if out_dtype == torch.float32 else 2.0 ** -6
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), atol=tol)


@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("mode", ["highest", "default"])
def test_frame_mel_kernel_at_unaligned_starts(b, mode):
    """Window starts that are no multiple of 4 samples (the loads are only
    4-byte aligned), for one window, an odd count, and the engine's batch."""
    _need_card()
    rng = np.random.default_rng(3)
    n = 66150 + 13230 * (b - 1) + 7
    buf = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    starts_np = np.arange(b) * 13230 // 4 * 4 + 1 + (np.arange(b) % 3)  # 1, 2, 3 mod 4
    starts_np[-1] = n - 66150
    assert (starts_np % 4 != 0).sum() >= b - 1 and starts_np.max() + 66150 <= n
    starts = torch.from_numpy(starts_np.astype(np.int32)).cuda()
    got = fm.log_mel_windows_fused(buf, starts, mode)
    torch.cuda.synchronize()
    assert got.shape == (b, 128, 256) and bool(torch.isfinite(got).all())
    ref = fm.log_mel_windows_fused_ref(buf, starts, mode)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


def test_kernels_on_two_streams_agree():
    """Launches in flight on two streams at once give what one launch
    gives: a block's barriers and ring live in its own shared memory."""
    _need_card()
    buf, starts = _buf_and_starts()
    frames = _frames(4, 256)
    want_fm = fm.log_mel_windows_fused(buf, starts, "high")
    want_dm = dm.log_mel_from_frames_dft(frames)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    got = []
    for _ in range(3):
        with torch.cuda.stream(s1):
            a = fm.log_mel_windows_fused(buf, starts, "high")
            c = dm.log_mel_from_frames_dft(frames)
        with torch.cuda.stream(s2):
            b = fm.log_mel_windows_fused(buf, starts, "high")
            d = dm.log_mel_from_frames_dft(frames)
        got.append((a, b, c, d))
    torch.cuda.synchronize()
    for a, b, c, d in got:
        assert torch.equal(a, want_fm) and torch.equal(b, want_fm)
        assert torch.equal(c, want_dm) and torch.equal(d, want_dm)


def test_frame_mel_kernel_marks_out_of_range_windows():
    _need_card()
    buf, _ = _buf_and_starts()
    bad = torch.tensor([buf.shape[0] - 66149, -1], dtype=torch.int32, device="cuda")
    assert torch.isnan(fm.log_mel_windows_fused(buf, bad)).all()


def test_gather_marks_out_of_range_windows_on_the_card():
    """On the card the gather does not wait for the device to check the
    starts: a window outside the buffer comes out NaN, the others exact."""
    _need_card()
    buf, starts = _buf_and_starts()
    bad = torch.tensor([0, buf.shape[0] - 66149, -1, 13230], dtype=torch.int32, device="cuda")
    frames = melops.gather_frames(buf, bad)
    assert torch.isnan(frames[1:3]).all() and not torch.isnan(frames[[0, 3]]).any()
    np.testing.assert_array_equal(frames[[0, 3]].cpu().numpy(),
                                  melops.gather_frames(buf.cpu(), bad[[0, 3]].cpu()).numpy())


def test_frame_mel_wrapper_rejects_wrong_layouts():
    _need_card()
    buf, starts = _buf_and_starts()
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf.double(), starts)
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts.long())
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts.cpu())


def _frames(b=3, f=256, seed=11):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (b, f, 512)).astype(np.float32)).cuda()


@pytest.mark.parametrize("b,f", [(3, 256), (4, 64), (64, 100), (1, 256), (2, 128)],
                         ids=["F256", "F64", "F100-unaligned", "rows256", "rows256-F128"])
def test_dft_mel_kernel_matches_plain_version(b, f):
    """Float32 class on both sides (the kernel's six-pass bf16 split drops
    terms of weight 2^-24; TF32 off in the plain version): ~1e-6 on values
    below ~4.  F=100 takes the kernel's scalar store path (F % 8 != 0: a
    group of 8 rows spans two windows); rows = 256 is the smallest input
    the wrapper takes."""
    _need_card()
    frames = _frames(b, f)
    before = KERNEL_LAUNCHES[dm.NAME]
    got = dm.log_mel_from_frames_dft(frames)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[dm.NAME] == before + 1
    assert got.shape == (b, 128, f) and got.dtype == torch.float32
    ref = dm.log_mel_from_frames_dft_ref(frames)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


def test_dft_mel_windows_entry_point_launches_once():
    _need_card()
    buf, starts = _buf_and_starts()
    before = KERNEL_LAUNCHES[dm.NAME]
    got = dm.log_mel_windows_dft(buf, starts[:4])
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[dm.NAME] == before + 1
    frames = melops.gather_frames(buf, starts[:4])
    np.testing.assert_allclose(got.cpu().numpy(),
                               dm.log_mel_from_frames_dft_ref(frames).cpu().numpy(), atol=1e-4)


def test_dft_mel_wrapper_rejects_wrong_inputs():
    _need_card()
    frames = _frames(2, 256)
    before = KERNEL_LAUNCHES[dm.NAME]
    for bad in (frames.double(), frames.half(), frames.transpose(0, 1),
                frames[:, :, :256], frames[:, :100],
                torch.empty(frames.shape, device="meta")):
        with pytest.raises(ValueError):
            dm.log_mel_from_frames_dft(bad)
    assert KERNEL_LAUNCHES[dm.NAME] == before


def test_device_resampler_on_the_card_matches_the_host(tmp_path):
    """One polyphase GEMM per chunk on the card (float32, TF32 off) against
    scipy's float64 polyphase: float round-off."""
    _need_card()
    from softspoken_tpu_torch.io import load_audio, stream_chunks, wavio

    x = np.random.default_rng(0).uniform(-0.6, 0.6, 32000 * 12).astype(np.float32)
    p = str(tmp_path / "r.wav")
    wavio.write(p, x, 32000, subtype="PCM_16")
    dev = np.concatenate([c.data for c in stream_chunks(p, 50000, backend="device",
                                                        device="cuda")])
    host = np.concatenate([c.data for c in stream_chunks(p, 50000, backend="host")])
    assert dev.shape == host.shape
    np.testing.assert_allclose(dev, host, atol=1e-5)
    np.testing.assert_allclose(dev, load_audio(p)[0], atol=1e-5)
