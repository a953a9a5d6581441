"""The port's FLOP count and MFU against the JAX package's
(softspoken_tpu/runtime/metrics.py): the same numbers for the same
arguments, ``per_chip`` the same, and a peak that comes from the card the
caller runs on, never a TPU's."""

import ast
import os

import pytest
import torch

from softspoken_tpu.runtime import metrics as jmetrics
from softspoken_tpu_torch.runtime import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("spec_head", [False, True])
def test_flops_per_window_equals_the_jax_count(spec_head):
    assert metrics.analytic_flops_per_window(spec_head) == \
        jmetrics.analytic_flops_per_window(spec_head)
    assert metrics.analytic_flops_per_window(include_spec_head=spec_head) == \
        jmetrics.analytic_flops_per_window(include_spec_head=spec_head)


@pytest.mark.parametrize("step", [0.6, 0.3, 1.5])
@pytest.mark.parametrize("spec_head", [False, True])
def test_flops_per_audio_second_equals_the_jax_count(step, spec_head):
    assert metrics.flops_per_audio_second(step, spec_head) == \
        jmetrics.flops_per_audio_second(step, spec_head)
    assert metrics.flops_per_audio_second() == jmetrics.flops_per_audio_second()


@pytest.mark.parametrize("rate,peak,step", [(600.0, 197e12, 0.6), (4000.0, 989.4e12, 0.6),
                                            (1234.5, 1e15, 0.3)])
def test_mfu_with_a_peak_equals_the_jax_mfu(rate, peak, step):
    assert metrics.mfu(rate, peak_flops=peak, step_seconds=step) == \
        jmetrics.mfu(rate, peak_flops=peak, step_seconds=step)
    assert metrics.mfu(rate, peak) == jmetrics.mfu(rate, peak)


def test_per_chip_equals_the_jax_meter():
    for n in (0, 1, 2, 4):
        ours, theirs = metrics.ThroughputMeter(n_chips=n), jmetrics.ThroughputMeter(n_chips=n)
        ours._t0 = theirs._t0 = 0.0  # one start for both clocks
        ours.add_audio(90.0)
        theirs.add_audio(90.0)
        wall = ours.wall_seconds
        rate = ours.per_chip
        assert rate > 0
        assert rate == pytest.approx(90.0 / wall / max(1, n), rel=1e-3)
        assert theirs.per_chip == pytest.approx(rate, rel=1e-3)
        ours.reset()
        assert ours.per_chip == 0.0


def test_mfu_without_a_peak_needs_a_listed_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.mfu(4000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.device_peak_flops()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Some Other GPU")
    with pytest.raises(KeyError, match="Some Other GPU"):
        metrics.mfu(4000.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert metrics.mfu(4000.0) == metrics.mfu(4000.0, peak_flops=989.4e12)


def test_no_tpu_peak_in_the_port():
    assert 197e12 not in metrics.PEAK_BF16_FLOPS.values()
    assert metrics.PEAK_BF16_FLOPS == {"NVIDIA H100 80GB HBM3": 989.4e12}
    src = open(os.path.join(ROOT, "softspoken_tpu_torch", "runtime", "metrics.py")).read()
    numbers = {n.value for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Constant)
               and isinstance(n.value, (int, float))}
    assert 197e12 not in numbers and "TPU" not in src
