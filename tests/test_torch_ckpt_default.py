"""``Detector()`` without a checkpoint argument runs the trained weights: the
committed ``root/models/spec_unet_2d/model_checkpoint.pth`` (exported from
the orbax checkpoint beside it with the JAX CLI's ``convert-ckpt``), equal
to the JAX package's orbax load tensor for tensor.  Only a path that is
truly missing degrades to the random fixture, as the reference does."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu_torch import Config, cli
from softspoken_tpu_torch.ckpt import fixture_state_dict, from_flax_variables, load_pth
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.models import build_model

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")
PTH = ORBAX + ".pth"


@pytest.fixture(scope="module")
def orbax_sd():
    variables, epoch = jckpt.load(ORBAX)
    return from_flax_variables(jax.device_get(variables)), epoch


def test_default_path_is_the_committed_pth():
    paths = Config().paths
    assert os.path.samefile(os.path.join(paths.model_dir, paths.model_name), PTH)


def test_pth_equals_the_orbax_checkpoint(orbax_sd):
    want, epoch = orbax_sd
    got, got_epoch = load_pth(PTH)
    assert got_epoch == epoch == 48750
    assert sorted(got) == sorted(want) and len(got) == 186
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_default_detector_runs_the_trained_weights(orbax_sd, caplog):
    with caplog.at_level(logging.WARNING):
        det = Detector(device="cpu")
    assert det.epoch == 48750
    assert "random init" not in caplog.text
    ref = build_model(orbax_sd[0], folded=True).to(det.dtype)  # bf16 in fast mode
    got = det.model.state_dict()
    for k, v in ref.state_dict().items():
        assert torch.equal(got[k], v), k


def test_a_missing_checkpoint_still_degrades_to_random_init(tmp_path, caplog):
    cfg = Config().with_paths(model_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING):
        det = Detector(cfg, device="cpu")
    assert det.epoch == -1 and "random init" in caplog.text
    ref = build_model(fixture_state_dict(0), folded=True).to(det.dtype)
    for k, v in ref.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k


def test_cli_detect_defaults_to_the_trained_weights(tmp_path):
    """`detect` with neither --checkpoint nor --random-init writes the rows
    of the trained model given explicitly."""
    from softspoken_tpu.io import wavio as jwavio
    from softspoken_tpu.train import synth

    audio, _ = synth.synth_field_recording(np.random.default_rng(5), 8.0, sr=22050,
                                           speech_events=(1, 1), snr_db=(15.0, 15.0))
    p = str(tmp_path / "f.wav")
    jwavio.write(p, audio, 22050, subtype="PCM_16")
    common = ["--files", p, "--device", "cpu", "--device-batch", "4",
              "--precision", "parity"]
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert cli.main(["detect", *common, "--out", a]) == 0
    assert cli.main(["detect", *common, "--out", b, "--checkpoint", PTH]) == 0
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
