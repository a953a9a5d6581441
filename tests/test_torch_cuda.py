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


def test_train_step_on_the_card_matches_the_cpu():
    """One float32 step (TF32 off, dropout off) from the same weights and
    batch: chip_smoke's check, with its tolerances, at B = 2."""
    _need_card()
    import chip_smoke

    chip_smoke.train_step_card_vs_cpu(batch_size=2)


def test_pth_trained_on_the_card_runs_in_detector(tmp_path):
    _need_card()
    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.train import fit_synthetic

    p = str(tmp_path / "card.pth")
    m = fit_synthetic(steps=2, batch_size=2, n_inner=1, pool_speech=2, pool_noise=2,
                      ckpt_out=p, augmentations=("add_reverb", "reduce_volume"))
    assert all(np.isfinite(v) for v in m.values())
    sd, epoch = load_pth(p)
    assert epoch == 2 and all(not torch.as_tensor(v).is_cuda for v in sd.values())
    wav = str(tmp_path / "x.wav")
    rng = np.random.default_rng(0)
    wavio.write(wav, (0.1 * rng.standard_normal(32000 * 20)).astype(np.float32), 32000)
    det = Detector(checkpoint_path=p)
    assert det.device.type == "cuda" and det.epoch == 2
    res = det.detect_file_streaming(wav)
    assert res.num_windows > 0 and np.isfinite(res.avg_values).all()


@pytest.mark.parametrize("fade", [0, 640])
def test_mute_twin_on_the_card_matches_numpy(fade):
    """``apply_mute_device`` on the card against the numpy ``apply_mute``:
    zero mode bit-equal, fade within 1e-6 (chip_smoke's tolerances), with
    overlapping, degenerate and out-of-range intervals."""
    _need_card()
    from softspoken_tpu_torch.ops import mute

    sr = 16000
    iv = [(0.1, 0.4), (0.3, 0.6), (0.9, 0.2), (0.5, 0.5), (-1.0, 0.1), (2.4, 99.0)]
    x = np.random.default_rng(0).normal(0, 0.3, (2, 40000)).astype(np.float32)
    samples = np.rint(np.asarray(iv, np.float64) * sr).astype(np.int64)
    out = mute.apply_mute_device(x, samples[:, 0], samples[:, 1], fade)
    assert out.is_cuda
    got, want = out.cpu().numpy(), mute.apply_mute(x, iv, sr, fade_samples=fade)
    if fade == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_eval_on_the_card_matches_the_cpu(tmp_path):
    """``evaluate_detector`` on a 2 x 30 s synthetic set in fast mode: the
    card (K1) within 0.01 frame F1 of the CPU (the plain mel chain)."""
    _need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.train import evaluate as E

    labeled = E.load_labels(E.make_eval_set(str(tmp_path), n_files=2, seconds=30.0, seed=21))
    KERNEL_LAUNCHES.clear()
    card = E.evaluate_detector(Detector(Config()), labeled)
    assert KERNEL_LAUNCHES["frame_mel"] > 0
    cpu = E.evaluate_detector(Detector(Config(), device="cpu"), labeled)
    assert abs(card["frame"]["f1"] - cpu["frame"]["f1"]) <= 0.01
    assert card["frame"]["f1"] > 0.8


@pytest.mark.parametrize(
    "n_samples,nb,saturate",
    [(2_498_976, None, False), (2_498_976 - 160, None, False), (256 * 37 + 5, None, False),
     (256, 1, False), (100, 1, False), (13 * 256, 13, False), (13 * 256 - 7, 14, False),
     (256 * 40 + 1, None, False), (256 * 40 + 8, None, False), (256 * 40 + 9, None, False),
     (256 * 40 + 255, None, False), (256 * 45, None, True)],
    ids=["chunk", "whole-blocks", "short-tail", "nb1", "nb1-tail", "nb13",
         "nb14-block-past-n", "tail-lane+1", "tail-lane+8", "tail-lane+9", "tail-lane+255",
         "saturate-every-step"])
def test_adpcm_kernel_is_bit_equal_to_plain_version(n_samples, nb, saturate):
    """K3 on the wire of a default chunk at the 16 kHz decimated rate
    (2,498,976 samples, 160 past a whole block) of random bytes with header
    indices 0..255, on whole blocks, and on a short tail; on one block; on
    13 and 14 blocks (not a multiple of the kernel's 4 warps a CUDA block,
    the 14th wholly past n); with n ending one sample into a lane's 8, on
    its end, one past it and one short of the block; and on a wire whose
    every step saturates a clip (seeds at -32768 and 32767, nibble runs 0xF
    and 0x7 at step index 88).  The same integers and one exact scale, so
    equal bits, in one launch."""
    _need_card()
    from softspoken_tpu_torch.ops import adpcm

    nb = nb or adpcm.n_blocks(n_samples)
    rng = np.random.default_rng(n_samples)
    w = rng.integers(0, 256, nb * adpcm.BLOCK_BYTES).astype(np.uint8).reshape(nb, -1)
    if saturate:
        w[:, 2] = 88
        w[0::2, 0:2], w[0::2, adpcm.HDR_BYTES:] = [0x00, 0x80], 0xFF  # -32768, falling
        w[1::2, 0:2], w[1::2, adpcm.HDR_BYTES:] = [0xFF, 0x7F], 0x77  # 32767, rising
    else:
        w[:2, 0:2] = [[0x00, 0x80], [0xFF, 0x7F]][:nb]   # seeds -32768 and 32767
        w[0, adpcm.HDR_BYTES:] = 0xFF
        if nb > 1:
            w[1, adpcm.HDR_BYTES:] = 0x77
    wire = torch.from_numpy(w.reshape(-1)).cuda()
    before = KERNEL_LAUNCHES[adpcm.NAME]
    got = adpcm.decode_device(wire, n_samples)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[adpcm.NAME] == before + 1
    assert got.shape == (n_samples,) and got.dtype == torch.float32
    ref = adpcm.decode_device_ref(wire, n_samples)
    assert torch.equal(got, ref)
    k = min(nb, 37)
    m = min(n_samples, k * 256)
    np.testing.assert_array_equal(got[:m].cpu().numpy(),
                                  adpcm.decode_device_ref(wire[: k * adpcm.BLOCK_BYTES].cpu(),
                                                          m).numpy())
    if saturate:
        pcm = (got.reshape(-1, 256).cpu().numpy() * 32768).astype(np.int64)
        assert (pcm[0::2] == -32768).all() and (pcm[1::2] == 32767).all()


def test_adpcm_wrapper_rejects_a_misaligned_wire():
    _need_card()
    from softspoken_tpu_torch.ops import adpcm

    wire = torch.zeros(2 * adpcm.BLOCK_BYTES + 1, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        adpcm.decode_device(wire[1:], 10)


def _field_wav(path, seconds, sr, seed):
    from softspoken_tpu_torch.io import wavio

    rng = np.random.default_rng(seed)
    x = (0.02 * rng.standard_normal(int(seconds * sr))).astype(np.float32)
    x[sr: 3 * sr] += (0.4 * np.sin(2 * np.pi * 700 * np.arange(2 * sr) / sr)).astype(np.float32)
    wavio.write(path, x, sr, subtype="PCM_16")


def test_journaled_resume_on_the_card_is_bit_equal(tmp_path):
    """Killed after 2 chunk programs and resumed, fast mode (K1) on the card:
    the remaining programs only, the grid bit-equal, the sidecar cleared."""
    _need_card()
    import os

    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine

    p, jd = str(tmp_path / "j.wav"), str(tmp_path / "progress")
    _field_wav(p, 60.0, 32000, seed=3)
    det = Detector(Config().with_engine(device_batch=16, chunk_seconds=15.0,
                                        chunk_checkpoint_every=1),
                   state_dict=fixture_state_dict(0))
    base = det.detect_file_streaming(p)
    engine = get_fused_engine(det, 32000, "i16")
    n_chunks = -(-base.num_windows // engine.chunk_w)
    assert n_chunks >= 3
    program, calls = engine._program, []

    def killer(*a, **k):
        if len(calls) >= 2:
            raise RuntimeError("simulated preemption")
        calls.append(1)
        return program(*a, **k)

    engine._program = killer
    try:
        with pytest.raises(RuntimeError):
            det.detect_file_streaming(p, journal_dir=jd)
        calls.clear()
        engine._program = lambda *a, **k: (calls.append(1), program(*a, **k))[1]
        res = det.detect_file_streaming(p, journal_dir=jd)
    finally:
        del engine._program
    assert len(calls) == n_chunks - 2
    np.testing.assert_array_equal(res.avg_values, base.avg_values)
    assert res.intervals == base.intervals and os.listdir(jd) == []


def test_two_files_on_two_threads_equal_the_sequential_run(tmp_path):
    """DetectRunner with file_concurrency=2 (two worker threads sharing the
    card) writes the byte-identical CSV of K=1, in fast mode on the card."""
    _need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.project import DetectionStore
    from softspoken_tpu_torch.runtime import DetectRunner

    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"s{i}.wav"))
        _field_wav(paths[-1], 40.0 + 10 * i, 32000, seed=10 + i)
    out = []
    for k in (1, 2):
        cfg = Config().with_engine(chunk_seconds=15.0, file_concurrency=k)
        det = Detector(cfg, state_dict=fixture_state_dict(0))
        store = DetectionStore(str(tmp_path / f"k{k}.csv"))
        rep = DetectRunner(det, store, cfg).run(paths)
        assert not rep.errors and rep.files_done == 4
        with open(store.path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


def test_bench_line_on_the_card_has_every_jax_key(tmp_path):
    """The port's bench at 60 s on the card: every key of the JAX line plus
    ``device``, the i16 wire, and an MFU against the card's own peak."""
    _need_card()
    import json
    import os
    import subprocess
    import sys

    import chip_smoke
    from softspoken_tpu_torch.runtime.metrics import device_peak_flops, flops_per_audio_second

    root = chip_smoke.HERE
    keys, _assigned = chip_smoke.bench_payload_keys(os.path.join(root, "bench.py"))
    env = dict(os.environ, PYTHONPATH=root, TMPDIR=str(tmp_path), BENCH_REPEATS="1",
               BENCH_TIME_BUDGET="0", BENCH_DEV_CHUNK_SECONDS="150")
    r = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", "bench", "--seconds",
                        "60"], cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert keys <= set(line) and "device" in line
    assert line["device"].startswith(torch.cuda.get_device_name())
    assert line["wire_codec"] == "i16" and line["device_only"] > 0
    peak = device_peak_flops()
    assert abs(line["mfu"] - line["value"] * flops_per_audio_second() / peak) <= 1e-6
    assert 0 < line["device_only_mfu"] < 1


def test_mfu_takes_the_peak_of_the_card():
    _need_card()
    from softspoken_tpu_torch.runtime import metrics

    peak = metrics.PEAK_BF16_FLOPS[torch.cuda.get_device_name()]
    assert metrics.device_peak_flops() == peak
    assert metrics.mfu(4000.0) == metrics.mfu(4000.0, peak_flops=peak)
    assert metrics.mfu(4000.0) == pytest.approx(
        4000.0 * metrics.flops_per_audio_second() / peak)


def test_gui_detect_on_the_card_equals_detect_csv(tmp_path):
    """The Qt app's detector screen (headless shim, the card, the trained
    weights, fused) writes the detections CSV that ``detect`` writes."""
    _need_card()
    import os

    from softspoken_tpu_torch import Config, cli
    from softspoken_tpu_torch.ui.qt_shim import install

    install(force=True)
    from PySide6.QtWidgets import QApplication

    from softspoken_tpu_torch.ui import qt_app

    wavs = []
    for i in range(2):
        wavs.append(str(tmp_path / f"g{i}.wav"))
        _field_wav(wavs[-1], 30.0 + 15 * i, 32000, seed=20 + i)
    QApplication.instance() or QApplication([])
    win = qt_app.SoftspokenApp(Config().with_paths(project_dir=str(tmp_path / "p")))
    win.pm.add_project("g")
    win.pm.set_active_project("g")
    win.pm.update_file_list(wavs)
    before = KERNEL_LAUNCHES[fm.NAME]
    win.detector.start_btn.click()
    assert win.detector.log.text().startswith("done: 2 file(s)"), win.detector.log.text()
    assert KERNEL_LAUNCHES[fm.NAME] > before
    out = str(tmp_path / "cli.csv")
    assert cli.main(["detect", "--files", *win.pm.get_unprocessed_list(), "--out", out]) == 0
    with open(win.pm.current_project["detections_file"], "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(out) > 0


def test_host_augmentations_on_the_card_match_the_cpu():
    """Every augmentation of train/augment.py on the card against the CPU
    on the same clips and parameters: change_pitch bit-equal (its source
    index divides by a tensor, as on the CPU), the others within float32
    rounding of the peak (cuFFT against pocketfft for the filters; the
    running phase sum for change_speed, on noise and a tone)."""
    _need_card()
    from softspoken_tpu_torch.train import augment as aug

    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.2, (2, 66150)).astype(np.float32)
    x[1] = 0.4 * np.sin(2 * np.pi * 500 * np.arange(66150) / 22050)
    g = torch.Generator()
    g.manual_seed(1)
    names = list(aug.PARAM_RANGES)
    for name, params in zip(names, aug.get_parameters(g, names)):
        cpu = aug.FUNC_MAP[name](torch.from_numpy(x), **params)
        card = aug.FUNC_MAP[name](torch.from_numpy(x).cuda(), **params).cpu()
        tol = {"change_pitch": 0.0, "change_speed": 2e-3, "bandpass_filter": 1e-4}.get(name, 1e-5)
        assert float((card - cpu).abs().max()) <= tol * float(cpu.abs().max()), name


def test_fit_from_recordings_on_the_card(tmp_path):
    """`train --speech-dir/--noise-dir` on the card: finite losses, and the
    .pth drives the port's Detector there."""
    _need_card()
    from softspoken_tpu_torch import cli
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.train import synth

    rng = np.random.default_rng(0)
    for d in ("s", "n"):
        (tmp_path / d).mkdir()
        for i in range(2):
            x = (synth.synth_speech(rng, 4 * 22050)[0] if d == "s"
                 else synth.synth_environment(rng, 4 * 22050))
            wavio.write(str(tmp_path / d / f"{i}.wav"), x, 22050)
    out = str(tmp_path / "w.pth")
    rc = cli.main(["train", "--speech-dir", str(tmp_path / "s"), "--noise-dir",
                   str(tmp_path / "n"), "--steps", "3", "--batch-size", "4", "--out", out,
                   "--augment", "add_reverb", "change_speed", "change_pitch"])
    assert rc == 0
    det = Detector(checkpoint_path=out)
    assert det.epoch == 3
    res = det.detect_waveform(np.zeros(22050 * 4, np.float32))
    assert res.num_windows > 0 and np.isfinite(res.avg_values).all()


# ---------------------------------------------------------------------------
# the kernels launch on their tensors' device

def _on_the_last_card_from_a_cuda0_thread(fn):
    """``fn(dev)`` on a thread whose current device is cuda:0, for the last
    visible card ``dev`` (cuda:0 itself with one card); returns its result."""
    import threading

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    out = {}

    def run():
        torch.cuda.set_device(0)
        try:
            out["value"] = fn(dev)
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(300)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return dev, out["value"]


@pytest.mark.parametrize("mode", ["highest", "high", "default"])
def test_frame_mel_kernel_on_the_last_card(mode):
    """K1 on the last card from a thread whose current device is cuda:0:
    the kernel runs on its tensors' card (the output lies there and equals
    the plain version on that card), whatever the thread's device."""
    _need_card()

    def run(dev):
        buf, starts = (t.to(dev) for t in _buf_and_starts())
        got = fm.log_mel_windows_fused(buf, starts, mode, torch.float32)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
        return got, fm.log_mel_windows_fused_ref(buf, starts, mode, torch.float32)

    dev, (got, ref) = _on_the_last_card_from_a_cuda0_thread(run)
    assert got.device == dev
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


def test_dft_mel_kernel_on_the_last_card():
    _need_card()

    def run(dev):
        rng = np.random.default_rng(5)
        frames = torch.from_numpy(rng.standard_normal((4, 64, 512)).astype(np.float32)).to(dev)
        got = dm.log_mel_from_frames_dft(frames)
        torch.cuda.synchronize(dev)
        return got, dm.log_mel_from_frames_dft_ref(frames)

    dev, (got, ref) = _on_the_last_card_from_a_cuda0_thread(run)
    assert got.device == dev
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-4)


def test_adpcm_kernel_on_the_last_card():
    from softspoken_tpu_torch.ops import adpcm

    _need_card()

    def run(dev):
        rng = np.random.default_rng(9)
        n = 37 * adpcm.SPB - 3
        pcm = (rng.standard_normal(n) * 8000).clip(-32768, 32767).astype(np.int16)
        wire = torch.from_numpy(adpcm.encode_i16(pcm)).to(dev)
        got = adpcm.decode_device(wire, n)
        torch.cuda.synchronize(dev)
        return got, adpcm.decode_device_ref(wire, n)

    dev, (got, ref) = _on_the_last_card_from_a_cuda0_thread(run)
    assert got.device == dev and torch.equal(got, ref)


def _seeded_mel_batch(det, seed=11, B=128):
    """K1's bf16 log-mel of B windows of a seeded field recording."""
    rng = np.random.default_rng(seed)
    n = (B - 1) * det.cfg.samples_per_step + det.cfg.samples_per_window
    t = np.arange(n) / 32000
    x = 0.02 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 700 * t) * (
        np.sin(2 * np.pi * 0.2 * t) > 0)
    wave = torch.from_numpy(x.astype(np.float32)).cuda()
    starts = torch.arange(B, dtype=torch.int32, device="cuda") * det.cfg.samples_per_step
    with torch.inference_mode():
        return fm.log_mel_windows_fused(wave, starts, "default", out_dtype=torch.bfloat16)


def test_nhwc_mask_logits_on_the_card_agree_with_float32():
    """The channels-last fused forward (the fast detector's) against the
    float32 NCHW forward with TF32 off, on the trained weights at B = 128:
    its relative L2 error is at most 1.5× that of the NCHW bfloat16 forward
    of the same model, measured here; the spec head agrees as well."""
    _need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector

    det = Detector(Config())
    model = det.model
    ref = Detector(Config().with_engine(precision="parity")).model
    assert model.conv1_1.nhwc_ready and not ref.conv1_1.nhwc_ready
    mel = _seeded_mel_batch(det)
    with torch.inference_mode():
        with melops.fp32_matmul():
            want_spec, want = ref(mel.float())
        got = model.mask_logits(mel)
        nchw = model._mask_head(model._trunk(mel))
        spec, mask = model(mel)

    def rel(a, b):
        return float((a.float() - b).norm() / b.norm())

    assert got.shape == (128, 256) and got.dtype == torch.float32
    assert rel(got, want) <= 1.5 * rel(nchw, want)
    assert torch.equal(mask, got)
    assert spec.shape == (128, 2, 128, 256) and spec.is_contiguous()
    assert rel(spec, want_spec) <= 0.02


def test_nhwc_forward_has_no_layout_transposes():
    """One profiled fast forward runs no cuDNN NCHW↔NHWC transpose."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector

    det = Detector(Config())
    mel = _seeded_mel_batch(det)
    with torch.inference_mode():
        det.model.mask_logits(mel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            det.model.mask_logits(mel)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("fprop" in n or "conv" in n.lower() for n in names), names
    assert not [n for n in names if "nchwToNhwc" in n or "nhwcToNchw" in n]


def test_batches_nhwc_counts_every_fused_batch_on_the_card(tmp_path):
    """``count.batches_nhwc`` equals ``count.batches`` in a fast detect on
    the card, and is absent in parity mode."""
    _need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.runtime.metrics import StageTimers

    p = str(tmp_path / "c.wav")
    _field_wav(p, 40.0, 32000, seed=4)
    for precision in ("fast", "parity"):
        det = Detector(Config().with_engine(precision=precision, device_batch=32,
                                            chunk_seconds=15.0))
        timers = StageTimers()
        det.detect_file_streaming(p, timers=timers)
        counted = timers.counted()
        assert counted["batches"] >= 2
        assert counted.get("batches_nhwc", 0) == (counted["batches"] if precision == "fast" else 0)
