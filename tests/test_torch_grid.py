"""The fused engine's deterministic overlap grid (``engine/fused.py``): at a
step that tiles (0.6 s, p = 5) p disjoint blocks added in group order, as
the JAX package does; at a step that does not (0.7 s) a per-bin gather of
the covering windows summed in window order.  Held to the JAX fused grid
with the trained weights in parity mode, and to the ``index_add_``
scatter it replaced."""

import os

import jax
import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import grid_tile_period as jgrid_tile_period
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.train import synth
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict, from_flax_variables
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine import regions as R
from softspoken_tpu_torch.engine.fused import FusedStreamingEngine, grid_tile_period

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")
STEPS = [0.6, 0.7]  # tiles with p = 5; does not tile


def test_tile_period_matches_jax():
    for step in (0.6, 0.7, 0.5, 0.3, 1.2, 0.45):
        assert grid_tile_period(step) == jgrid_tile_period(step), step
    assert grid_tile_period(0.6) == 5 and grid_tile_period(0.7) is None


def _engine(step, device_batch=4, chunk_seconds=6.0):
    cfg = Config().with_engine(precision="parity", device_batch=device_batch,
                               chunk_seconds=chunk_seconds, step_seconds=step)
    det = Detector(cfg, state_dict=fixture_state_dict(0), device="cpu")
    return FusedStreamingEngine(det, 22050, "i16")


def _index_add(eng, vals, bins):
    """The scatter the grid used before: one index_add_ over every lane."""
    idx = (torch.from_numpy(bins)[:, None] + torch.arange(256)).reshape(-1)
    out = torch.zeros(eng.glen, dtype=torch.float64)
    out.index_add_(0, idx, vals.double().reshape(-1))
    return out


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("n_real", ["full", "tail", "short-tail"])
def test_grid_matches_the_index_add_scatter(step, n_real):
    eng = _engine(step)
    cw = eng.chunk_w
    n = {"full": cw, "tail": cw - 7, "short-tail": 3}[n_real]
    first = 1234  # a chunk that starts mid-file: offsets relative to its base
    bins_g = R.window_bin_offset(np.arange(first, first + cw), step)
    bins = np.zeros(cw, np.int64)
    bins[:n] = bins_g[:n] - bins_g[0]
    valid = torch.zeros(cw)
    valid[:n] = 1.0
    vals = torch.from_numpy(np.random.default_rng(0).normal(0, 3, (cw, 256)).astype(np.float32))
    place = eng._placement(bins, n)
    both = torch.stack([vals * valid[:, None], valid[:, None].expand(cw, 256)])
    got, cnt = eng._accumulate(both, place)
    want = _index_add(eng, vals * valid[:, None], bins)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(cnt.double().numpy(),
                                  _index_add(eng, valid[:, None].expand(cw, 256), bins).numpy())
    # the same inputs give the same bits
    assert torch.equal(got, eng._accumulate(both, place)[0])


def test_placement_checks_every_block_on_the_host():
    for step in STEPS:
        eng = _engine(step)
        bins = R.window_bin_offset(np.arange(eng.chunk_w), step).astype(np.int64)
        with pytest.raises(RuntimeError, match="out of range"):
            eng._placement(bins + eng.glen, eng.chunk_w)
        with pytest.raises(RuntimeError, match="out of range"):
            eng._placement(bins - 300, eng.chunk_w)


@pytest.fixture(scope="module")
def trained():
    variables, _ = jckpt.load(ORBAX)
    return jax.device_get(variables)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    audio, _ = synth.synth_field_recording(np.random.default_rng(21), 20.0, sr=22050,
                                           speech_events=(3, 3), snr_db=(10.0, 20.0))
    p = str(tmp_path_factory.mktemp("grid") / "field.wav")
    jwavio.write(p, audio, 22050, subtype="PCM_16")
    return p


@pytest.mark.parametrize("step", STEPS)
def test_fused_grid_equals_jax_with_the_trained_weights(trained, field, step):
    """Several chunks, so the carry joins blocks across chunk borders:
    1e-4 on the grid (the trained logits reach |x| ~ 10), equal intervals,
    and two runs bit-equal."""
    eng = dict(precision="parity", device_batch=8, chunk_seconds=6.0,
               step_seconds=step, pipeline="fused")
    ref = JDetector(JConfig().with_engine(**eng), variables=trained).detect_file_fused(field)
    det = Detector(Config().with_engine(**eng), state_dict=from_flax_variables(trained),
                   device="cpu")
    got = det.detect_file_streaming(field)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals and got.intervals
    again = det.detect_file_streaming(field)
    np.testing.assert_array_equal(again.avg_values, got.avg_values)
