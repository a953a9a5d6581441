"""The labeled field recordings and the detection metrics of the port
(``train/synth.synth_field_recording``, ``train/evaluate.py``) are
bit-identical to the JAX package's for the same seeds and intervals."""

import numpy as np
import pytest

from softspoken_tpu.engine import regions as jregions
from softspoken_tpu.train import evaluate as jevaluate
from softspoken_tpu.train import synth as jsynth
from softspoken_tpu_torch.engine import regions
from softspoken_tpu_torch.train import evaluate, synth


@pytest.mark.parametrize("seed,seconds,sr", [(0, 20.0, 32000), (1, 12.0, 22050),
                                             (2, 5.0, 48000), (7, 30.0, 16000)])
def test_synth_field_recording_is_bit_identical(seed, seconds, sr):
    a, la = synth.synth_field_recording(np.random.default_rng(seed), seconds, sr=sr)
    b, lb = jsynth.synth_field_recording(np.random.default_rng(seed), seconds, sr=sr)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert la == lb and la


def test_synth_field_recording_options_are_bit_identical():
    kw = dict(sr=22050, speech_events=(3, 3), snr_db=(10.0, 20.0))
    a, la = synth.synth_field_recording(np.random.default_rng(99), 30.0, **kw)
    b, lb = jsynth.synth_field_recording(np.random.default_rng(99), 30.0, **kw)
    np.testing.assert_array_equal(a, b)
    assert la == lb


def _intervals(rng, n, duration):
    s = np.sort(rng.uniform(0, duration, n))
    return [(float(x), float(x + rng.uniform(0.05, 4.0))) for x in s]


@pytest.mark.parametrize("seed", range(5))
def test_metrics_are_bit_identical(seed):
    rng = np.random.default_rng(seed)
    truth = _intervals(rng, 6, 60.0)
    pred = _intervals(rng, 8, 60.0) + truth[:3]
    for p, t in [(pred, truth), ([], truth), (pred, []), ([], [])]:
        assert evaluate.frame_metrics(p, t, 64.0) == jevaluate.frame_metrics(p, t, 64.0)
        for iou in (0.1, 0.5, 0.9):
            assert (evaluate.event_metrics(p, t, iou=iou)
                    == jevaluate.event_metrics(p, t, iou=iou))
    assert evaluate._iou(pred[0], truth[0]) == jevaluate._iou(pred[0], truth[0])
    np.testing.assert_array_equal(evaluate._grid_mask(truth, 5000, 3 / 256),
                                  jevaluate._grid_mask(truth, 5000, 3 / 256))
    assert regions.merge_intervals(pred) == jregions.merge_intervals(pred)


def test_metrics_on_known_cases():
    truth = [(1.0, 2.0), (5.0, 6.0)]
    assert evaluate.frame_metrics(truth, truth, 10.0)["f1"] == 1.0
    assert evaluate.event_metrics(truth, truth)["f1"] == 1.0
    assert evaluate.event_metrics([(1.0, 1.2)], truth)["tp"] == 0.0
    assert evaluate.frame_metrics([], truth, 10.0)["f1"] == 0.0
