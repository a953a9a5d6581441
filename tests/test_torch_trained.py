"""The committed trained checkpoint, carried across to the port, against the
JAX package on a planted-speech field (the fixture of test_trained_ckpt.py).

The trained model's sharp logits make grid and carry bookkeeping errors
visible where the random fixture's near-uniform logits would hide them.
"""

import os

import jax
import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import detect_file_fused as jax_detect_file_fused
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.train import synth
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import from_flax_variables
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import detect_file_fused

torch.set_num_threads(2)

CKPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "root", "models", "spec_unet_2d", "model_checkpoint",
)
ENG = dict(precision="parity", device_batch=8, pipeline="fused")


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    variables, _epoch = jckpt.load(CKPT)
    return jax.device_get(variables)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    """A 30 s labeled synthetic field recording at 22050 Hz."""
    rng = np.random.default_rng(99)
    audio, intervals = synth.synth_field_recording(
        rng, 30.0, sr=22050, speech_events=(3, 3), snr_db=(10.0, 20.0))
    p = str(tmp_path_factory.mktemp("trained") / "field.wav")
    jwavio.write(p, audio, 22050, subtype="PCM_16")
    return p, intervals


def _port(variables, path, **eng):
    det = Detector(Config().with_engine(**ENG, **eng),
                   state_dict=from_flax_variables(variables), device="cpu")
    return detect_file_fused(det, path)


def test_trained_intervals_equal_jax(trained, field):
    """float32 both sides: equal intervals; 1e-4 on the grid (measured
    ~1e-6; the trained logits reach |x| ~ 10)."""
    path, truth = field
    ref = jax_detect_file_fused(
        JDetector(JConfig().with_engine(**ENG, chunk_seconds=12.0), variables=trained), path)
    got = _port(trained, path, chunk_seconds=12.0)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals
    for s, e in truth:  # the planted speech is found
        assert any(ds < e and de > s for ds, de in got.intervals)


def test_trained_chunked_equals_unchunked(trained, field):
    path, _ = field
    multi = _port(trained, path, chunk_seconds=6.0)
    single = _port(trained, path, chunk_seconds=60.0)
    np.testing.assert_allclose(multi.avg_values, single.avg_values, atol=2e-5)
    assert multi.intervals == single.intervals
