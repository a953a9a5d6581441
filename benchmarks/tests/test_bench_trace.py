"""The trace readers on a hand-made Chrome trace, and the frozen counts
against the reference's tables and the program's own arithmetic."""

import json

import numpy as np
import pytest

import benchcopy  # noqa: F401

from benchmarks.harness import registry
from benchmarks.harness.trace import SLICE_SPAN, Trace
from benchmarks.reference import mel as ref_mel

K1_NAME = "void mel_core_kernel<WindowLoader<true>, 1>(WindowLoader<true>, void*)"


def _ev(name, cat, ts, dur, tid, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": pid}


def _trace(tmp_path, k1_dur=150.0):
    events = [
        _ev(SLICE_SPAN, "user_annotation", 1000.0, 1000.0, 1),
        _ev("bench.file", "user_annotation", 1000.0, 1000.0, 1),
        # the launching thread: runtime calls and the host op over the gap
        _ev("cudaLaunchKernel", "cuda_runtime", 1090.0, 5.0, 2),
        _ev("cudaLaunchKernel", "cuda_runtime", 1240.0, 5.0, 2),
        # a thread that polls events but launches nothing
        _ev("cudaEventQuery", "cuda_runtime", 1300.0, 1.0, 3),
        _ev("cudaEventQuery", "cuda_runtime", 1310.0, 1.0, 3),
        _ev("cudaEventQuery", "cuda_runtime", 1320.0, 1.0, 3),
        _ev("aten::conv2d", "cpu_op", 1400.0, 200.0, 2),
        _ev("aten::relu", "cpu_op", 1450.0, 20.0, 2),      # not over the gap's middle
        # device work: two overlapping kernels, a copy, K1; one event outside
        _ev("conv_kernel", "kernel", 1100.0, 200.0, 7, 0),
        _ev("relu_kernel", "kernel", 1250.0, 150.0, 7, 0),
        _ev("Memcpy HtoD", "gpu_memcpy", 1600.0, 100.0, 8, 0),
        _ev(K1_NAME, "kernel", 1800.0, k1_dur, 7, 0),
        _ev("late_kernel", "kernel", 2500.0, 50.0, 7, 0),
        {"ph": "i", "name": "marker", "ts": 1500.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.load(str(path))


def test_busy_idle_and_gaps(tmp_path):
    tr = _trace(tmp_path)
    assert tr.window_s == pytest.approx(1000e-6)
    # busy: [1100, 1400] + [1600, 1700] + [1800, 1950] = 550 us
    assert tr.busy_s() == pytest.approx(550e-6)
    idle = registry.load_module("metrics", "device.idle_pct.detect")
    assert idle.read({"trace": tr}) == pytest.approx(45.0)
    gaps = dict(tr.idle_by_host(10))
    # [1400, 1600] lies under aten::conv2d on the launching thread
    assert gaps["aten::conv2d"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(450e-6)
    ops = tr.device_ops(10)
    assert ops[0] == ["conv_kernel", pytest.approx(200e-6)]
    assert "late_kernel" not in dict(ops)


def test_k1_roofline_reader(tmp_path):
    k1 = registry.load_module("counts", "k1")
    least = k1.least_seconds(128)
    tr = _trace(tmp_path, k1_dur=least * 1e6 / 0.4)
    read = registry.load_module("metrics", "k1.roofline_pct").read
    assert read({"trace": tr, "slice": {"device_batch": 128}}) == pytest.approx(40.0)
    # no K1 launch in the slice: nothing is read (never a 0)
    empty = Trace([])
    assert read({"trace": empty, "slice": {"device_batch": 128}}) is None
    assert registry.load_module("metrics", "device.idle_pct.detect").read({"trace": empty}) is None


def test_k1_count_is_compute_bound_at_the_cell_batch():
    k1 = registry.load_module("counts", "k1")
    assert k1.flops(128) / k1.PEAK_FLOPS > k1.bytes_moved(128) / k1.PEAK_BYTES_PER_S
    assert k1.least_seconds(128) == pytest.approx(k1.flops(128) / k1.PEAK_FLOPS)


def test_frozen_counts_match_the_tables_and_the_program():
    c = registry.load_module("counts", "specunet2d")
    fb = ref_mel.mel_fbank()
    weighed = np.nonzero(fb.any(axis=1))[0]
    assert c.MEL_BINS == weighed.max() + 1
    assert c.FB_NONZERO == int((fb > 0).sum())
    # the U-Net part is the program's analytic count without its frontend
    from softspoken_tpu_torch.runtime.metrics import analytic_flops_per_window

    frontend = 2 * 256 * 512 * 2050 + 3 * 256 * 1025 + 2 * 256 * 1025 * 128
    assert c.unet_flops_per_window() == analytic_flops_per_window() - frontend
    assert c.unet_flops_per_window(spec_head=True) == (
        analytic_flops_per_window(include_spec_head=True) - frontend)


@pytest.mark.parametrize("seconds,sr", [(1800.0, 32000), (60.0, 48000), (8.0, 48000),
                                        (61.3, 44100), (10.0, 22050)])
def test_window_count_is_the_planners(seconds, sr):
    from softspoken_tpu_torch.config import Config
    from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
    from softspoken_tpu_torch.io.resample import resampled_length

    c = registry.load_module("counts", "specunet2d")
    frames = int(round(seconds * sr))
    padded = resampled_length(frames + 2 * int(round(3.0 * sr)), sr, 22050)
    assert c.windows(frames, sr) == num_windows_for_padded_length(padded, Config())
