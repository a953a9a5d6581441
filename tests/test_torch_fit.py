"""The host trainer from recordings (``train/fit.py::fit``, ``ClipSampler``,
``list_wavs``) against the JAX package's, mirroring tests/test_fit.py on the
CPU: the full SpecUNet_2D at B = 2 for a few steps.

The JAX file marks its fit runs ``slow``; here they run in seconds.  One
``fit`` step on the committed trained weights (carried to the port with
``from_flax_variables``), dropout off on both sides, gives JAX's first
loss within 1e-5 relative, the float32 bound test_torch_train_step.py holds
``train_step`` to (measured 3e-7): the clips are equal, the mixes equal,
the mels within 2e-4 (test_torch_data.py).
"""

import functools
import importlib
import json
import os
import time

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import Config, cli
from softspoken_tpu_torch.ckpt import from_flax_variables, load_pth, save_pth
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.train import loop
from softspoken_tpu_torch.train.fit import ClipSampler, _DaemonJob, fit, list_wavs
from torch_train_ref import NoDropout

jfit = importlib.import_module("softspoken_tpu.train.fit")
tfit = importlib.import_module("softspoken_tpu_torch.train.fit")

torch.set_num_threads(2)

SR = 22050
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "root", "models", "spec_unet_2d", "model_checkpoint")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """tests/test_fit.py's corpora: two 4 s tones as speech, one 5 s noise
    file and one 1 s noise file (the tiling), plus a 44.1 kHz speech file in
    a subdirectory (the resampler and the recursive listing)."""
    root = tmp_path_factory.mktemp("corpora")
    rng = np.random.default_rng(0)
    speech, noise = root / "speech", root / "noise"
    (speech / "sub").mkdir(parents=True)
    noise.mkdir()
    t = np.arange(4 * SR) / SR
    for i in range(2):
        s = (0.4 * np.sin(2 * np.pi * (500 + 100 * i) * t)).astype(np.float32)
        jwavio.write(str(speech / f"s{i}.wav"), s, SR)
    t44 = np.arange(4 * 44100) / 44100
    jwavio.write(str(speech / "sub" / "s2.wav"),
                 (0.3 * np.sin(2 * np.pi * 350 * t44)).astype(np.float32), 44100)
    jwavio.write(str(noise / "n0.wav"), (0.1 * rng.normal(size=5 * SR)).astype(np.float32), SR)
    jwavio.write(str(noise / "n1.wav"), (0.1 * rng.normal(size=SR)).astype(np.float32), SR)
    return str(speech), str(noise)


def test_list_wavs(corpora):
    speech, noise = corpora
    assert len(list_wavs(speech)) == 3
    for d in corpora:
        assert list_wavs(d) == jfit.list_wavs(d)


def test_clip_sampler_draws_the_jax_clips(corpora):
    """The same seed draws the same files, offsets and tiling phases, and
    the clips are equal (the readers and the resampler are the JAX ones bit
    for bit)."""
    for d, tile in zip(corpora, (False, True)):
        files = list_wavs(d)
        got = ClipSampler(files, np.random.default_rng(4), tile_short=tile).batch(6)
        want = jfit.ClipSampler(files, np.random.default_rng(4), tile_short=tile).batch(6)
        assert got.shape == (6, 66150) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_clip_sampler_short_file_tiling_varies(tmp_path):
    """A sub-3 s noise file is tiled from a random phase, not always from
    offset 0."""
    short = tmp_path / "short.wav"
    jwavio.write(str(short), np.arange(SR, dtype=np.float32) / SR, SR, subtype="FLOAT")
    sampler = ClipSampler([str(short)], np.random.default_rng(0), tile_short=True)
    clips = [sampler.sample() for _ in range(4)]
    assert any(not np.array_equal(clips[0], c) for c in clips[1:])


def test_clip_sampler_needs_files():
    with pytest.raises(ValueError, match="empty file pool"):
        ClipSampler([], np.random.default_rng(0), tile_short=False)


def test_daemon_job_none_result_is_done():
    job = _DaemonJob(lambda: None)
    for _ in range(100):
        if job.done() or job.failed():
            break
        time.sleep(0.01)
    assert job.done() and not job.failed()


def test_fit_runs_and_saves(tmp_path, corpora):
    """Two steps logged every step, saved at the last; the .pth drives the
    port's Detector."""
    speech, noise = corpora
    out = str(tmp_path / "trained.pth")
    seen = []
    metrics = fit(speech, noise, steps=2, batch_size=2, ckpt_out=out,
                  augmentations=["reduce_volume", "change_speed"], save_every=2,
                  log_every=1, on_metrics=lambda s, m: seen.append(s), device="cpu")
    assert seen == [1, 2]
    assert set(metrics) == {"loss", "mask_loss", "spec_loss"}
    assert all(np.isfinite(v) for v in metrics.values())
    sd, epoch = load_pth(out)
    assert epoch == 2
    det = Detector(Config().with_engine(precision="parity", device_batch=4, chunk_seconds=12.0),
                   checkpoint_path=out, device="cpu")
    assert det.detect_waveform(np.zeros(SR * 4, np.float32)).num_windows > 0


def test_fit_resume_warm_starts(tmp_path, corpora):
    """--resume continues from a saved checkpoint: the weights start equal
    to the checkpoint's and the saved epoch accumulates across runs."""
    speech, noise = corpora
    out = str(tmp_path / "ck.pth")
    fit(speech, noise, steps=1, batch_size=2, ckpt_out=out, augmentations=[],
        save_every=1, log_every=1, device="cpu")
    saved, epoch = load_pth(out)
    assert epoch == 1
    state = loop.create_train_state(9, resume=out)
    assert state.step == 1
    sd = state.model.state_dict()
    for k, v in saved.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v))
    fit(speech, noise, steps=1, batch_size=2, ckpt_out=out, augmentations=[],
        save_every=1, log_every=1, resume=out, device="cpu")
    assert load_pth(out)[1] == 2


def test_fit_rejects_what_is_not_ported_or_valid(corpora):
    with pytest.raises(RuntimeError, match="torch.distributed initialized"):
        fit(*corpora, steps=1, mesh=object(), device="cpu")  # no process group
    with pytest.raises(ValueError, match="train_dtype"):
        fit(*corpora, steps=1, train_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="empty file pool"):
        fit(corpora[0], corpora[0] + "/none", steps=1, device="cpu")


def test_fit_defaults_to_the_card(corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(*corpora, steps=1)


def test_one_fit_step_matches_jax(tmp_path, corpora):
    """The same trained weights and seed, dropout off: the first step's
    loss and its two terms within 1e-5 relative of the JAX trainer's."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    init = str(tmp_path / "init.pth")
    save_pth(init, from_flax_variables(jax.device_get(jckpt.load(CKPT)[0])), epoch=0)
    kw = dict(steps=1, batch_size=2, augmentations=[], log_every=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", NoDropout)
        want = jfit.fit(*corpora, resume=CKPT, **kw)
        mp.setattr(tfit, "create_train_state",
                   functools.partial(loop.create_train_state, dropout_p=0.0))
        got = fit(*corpora, resume=init, device="cpu", **kw)
    for k in ("loss", "mask_loss", "spec_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_cli_train_from_directories(tmp_path, corpora, capsys):
    """`train --speech-dir S --noise-dir N --device cpu --steps 2
    --batch-size 2 --out w.pth`: one JSON line, the final metrics, as the
    JAX CLI prints, and a .pth the Detector loads."""
    out = str(tmp_path / "w.pth")
    speech, noise = corpora
    rc = cli.main(["train", "--speech-dir", speech, "--noise-dir", noise, "--device", "cpu",
                   "--steps", "2", "--batch-size", "2", "--out", out,
                   "--augment", "add_reverb", "bandpass_filter"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 1 and set(lines[0]) == {"loss", "mask_loss", "spec_loss"}
    assert all(np.isfinite(v) for v in lines[0].values())
    assert load_pth(out)[1] == 2
    Detector(Config(), checkpoint_path=out, device="cpu")
