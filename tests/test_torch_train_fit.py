"""The port's synthetic trainer end to end on the CPU: ``fit_synthetic``
writes a ``.pth`` that resumes, that the JAX package's ``ckpt.load_pth``
reads with exactly the port's weights, and that the port's ``Detector``
runs on; the ``train`` command line; the checkpoint writer and the loop's
safety nets."""

import json
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu_torch import cli
from softspoken_tpu_torch.ckpt import from_flax_variables, load_pth, model_keys, save_pth
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.ops import mel as tmel
from softspoken_tpu_torch.train import fit as tfit
from softspoken_tpu_torch.train import fit_synthetic
from softspoken_tpu_torch.train.loop import create_train_state

torch.set_num_threads(2)

SMALL = dict(batch_size=2, n_inner=1, pool_speech=2, pool_noise=2, device="cpu",
             augmentations=("add_reverb", "reduce_volume"))


@pytest.fixture(scope="module")
def trained_pth(tmp_path_factory):
    """Two steps of fit_synthetic on the CPU, logged every step."""
    path = str(tmp_path_factory.mktemp("fit") / "model.pth")
    seen = []
    metrics = fit_synthetic(steps=2, ckpt_out=path, log_every_outer=1,
                            on_metrics=lambda step, m: seen.append((step, m)), **SMALL)
    return path, metrics, seen


def test_fit_synthetic_trains_and_writes_a_pth(trained_pth):
    path, metrics, seen = trained_pth
    assert [s for s, _ in seen] == [1, 2]
    assert set(metrics) == {"loss", "mask_loss", "spec_loss", "wall_seconds"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert abs(metrics["loss"] - metrics["mask_loss"] - metrics["spec_loss"]) < 1e-5
    sd, epoch = load_pth(path)
    assert epoch == 2
    init = create_train_state(seed=0).model.state_dict()
    assert set(sd) == set(model_keys(init))
    moved = [k for k in sd if not torch.equal(torch.as_tensor(sd[k]), init[k])]
    assert len(moved) == len(sd)  # every weight and every BN statistic moved


def test_pth_carries_the_reference_extras(trained_pth):
    """BN counters and the torchaudio buffers, as JAX's export_pth writes
    them; every tensor a contiguous CPU tensor."""
    raw = torch.load(trained_pth[0], map_location="cpu", weights_only=True)
    assert set(raw) == {"model_state_dict", "epoch"}
    sd = raw["model_state_dict"]
    assert int(sd["conv1_1.residual.1.num_batches_tracked"]) == 2
    np.testing.assert_array_equal(sd["mel_spectrogram.spectrogram.window"].numpy(),
                                  tmel.hann_periodic(512).astype(np.float32))
    np.testing.assert_array_equal(sd["mel_spectrogram.mel_scale.fb"].numpy(), tmel.mel_filterbank())
    assert all(v.device.type == "cpu" and v.is_contiguous() for v in sd.values())
    jax_sd = set(jckpt.flax_to_torch_state_dict(jckpt.fixture_variables(seed=0)))
    assert set(sd) == jax_sd


def test_pth_loads_in_the_jax_package_exactly(trained_pth):
    variables, epoch = jckpt.load_pth(trained_pth[0])
    assert epoch == 2
    got = from_flax_variables(jax.device_get(variables))
    sd, _ = load_pth(trained_pth[0])
    assert set(got) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k], np.asarray(sd[k]), err_msg=k)


def test_detector_runs_on_the_trained_pth(trained_pth, tmp_path):
    wav = str(tmp_path / "x.wav")
    rng = np.random.default_rng(0)
    wavio.write(wav, (0.1 * rng.standard_normal(22050 * 5)).astype(np.float32), 22050)
    det = Detector(checkpoint_path=trained_pth[0], device="cpu")
    assert det.epoch == 2
    res = det.detect_file(wav)
    assert res.num_windows > 0 and np.isfinite(res.avg_values).all()


def test_resume_continues_the_step_count(trained_pth, tmp_path):
    """The step counter comes back from the epoch; the weights from the
    file; the optimizer moments start fresh."""
    state = create_train_state(seed=5, resume=trained_pth[0])
    sd, _ = load_pth(trained_pth[0])
    assert state.step == 2
    for k, v in model_keys(state.model.state_dict()).items():
        assert torch.equal(v, torch.as_tensor(sd[k])), k
    assert not state.optimizer.state
    out = str(tmp_path / "resumed.pth")
    fit_synthetic(steps=1, ckpt_out=out, resume=trained_pth[0], **SMALL)
    assert load_pth(out)[1] == 3


def test_resume_from_a_converted_pth_counts_from_zero(tmp_path):
    p = str(tmp_path / "conv.pth")
    jckpt.export_pth(p, jckpt.fixture_variables(seed=0), epoch=-1)
    assert create_train_state(resume=p).step == 0


def test_fit_synthetic_bfloat16_and_boundary_weight(tmp_path):
    m = fit_synthetic(steps=1, train_dtype="bfloat16", boundary_weight=2.0,
                      noise_extra_kinds=("crackle",), noise_extra_frac=0.5,
                      noise_extra_policy="protected", **SMALL)
    assert all(np.isfinite(v) for v in m.values())


def test_fit_synthetic_rejects_bad_options():
    with pytest.raises(ValueError, match="noise_extra_policy"):
        fit_synthetic(steps=1, noise_extra_policy="bogus", device="cpu")
    with pytest.raises(ValueError, match="noise_extra_frac"):
        fit_synthetic(steps=1, noise_extra_kinds=("music",), noise_extra_frac=1.0,
                      noise_extra_policy="protected", device="cpu")
    with pytest.raises(ValueError, match="train_dtype"):
        fit_synthetic(steps=1, train_dtype="float16", device="cpu")
    with pytest.raises(RuntimeError, match="mesh training needs torch.distributed"):
        fit_synthetic(steps=1, mesh=object(), device="cpu")  # no process group


def test_fit_synthetic_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_synthetic(steps=1, pool_speech=1, pool_noise=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--synthetic", "--steps", "1", "--pool-size", "1"])


def test_cli_train_synthetic_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "cli.pth")
    rc = cli.main(["train", "--synthetic", "--steps", "1", "--batch-size", "2",
                   "--pool-size", "2", "--n-inner", "1", "--device", "cpu", "--out", out,
                   "--augment", "reduce_volume", "--seed", "3"])
    assert rc == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(metrics["loss"])
    assert load_pth(out)[1] == 1


@pytest.mark.parametrize("argv,exc,match", [
    (["--speech-dir", "s"], SystemExit, "need --speech-dir and --noise-dir"),
    (["--mesh", "--speech-dir", "s"], SystemExit, "need --speech-dir and --noise-dir"),
    ([], SystemExit, "need --speech-dir and --noise-dir"),
], ids=["speech_dir", "mesh", "neither"])
def test_cli_train_unported_options(argv, exc, match):
    with pytest.raises(exc, match=match):
        cli.main(["train", "--device", "cpu", *argv])


# ---------------------------------------------------------------------------
# the checkpoint writer and the loop's safety nets

def test_save_pth_writes_atomically(tmp_path, monkeypatch):
    p = str(tmp_path / "sub" / "w.pth")
    sd = {"a.weight": torch.arange(12.0).reshape(3, 4).t()}        # not contiguous
    save_pth(p, sd, epoch=4)
    raw = torch.load(p, map_location="cpu", weights_only=True)
    assert raw["epoch"] == 4 and torch.equal(raw["model_state_dict"]["a.weight"], sd["a.weight"])

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(OSError):
        save_pth(p, {"a.weight": torch.zeros(1)}, epoch=5)
    assert torch.load(p, map_location="cpu", weights_only=True)["epoch"] == 4
    assert os.listdir(os.path.dirname(p)) == ["w.pth"]


def test_mid_run_save_failure_is_logged_and_the_final_one_raises(monkeypatch, caplog):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tfit.ckpt_mod, "save_pth", boom)
    state = create_train_state(seed=0)
    with caplog.at_level(logging.ERROR):
        tfit._save_checkpoint("x.pth", state, 10, fatal=False)
    assert any("checkpoint save failed" in r.message for r in caplog.records)
    with pytest.raises(OSError):
        tfit._save_checkpoint("x.pth", state, 20, fatal=True)


def test_stall_watchdog_aborts_with_86_and_stops():
    codes = []
    wd = tfit._StallWatchdog(0.2, abort=codes.append)
    deadline = time.monotonic() + 10
    while not codes and time.monotonic() < deadline:
        time.sleep(0.05)
    assert codes == [86]
    quiet = tfit._StallWatchdog(0.2, abort=codes.append)
    quiet.stop()
    time.sleep(0.5)
    assert codes == [86]
    wd.stop()


def test_daemon_job_reports_done_and_failed():
    ok = tfit._DaemonJob(lambda: None)
    bad = tfit._DaemonJob(lambda: 1 / 0)
    deadline = time.monotonic() + 10
    while not (ok.done() and bad.failed()) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ok.done() and not ok.failed() and ok.result is None
    assert bad.failed() and isinstance(bad.error, ZeroDivisionError)


def test_pool_refresh_swaps_in_fresh_pools(monkeypatch):
    """A refresh generation starts on the daemon thread at outer steps that
    are multiples of pool_refresh_outer; its pools are swapped in once done."""
    from softspoken_tpu_torch.train import synth

    calls, real = [], synth.make_pools

    def counted(*a, **k):
        calls.append(time.monotonic())
        return real(*a, **k)

    monkeypatch.setattr(synth, "make_pools", counted)
    fit_synthetic(steps=3, pool_refresh_outer=1, **SMALL)
    assert len(calls) >= 2  # the initial pools and at least one refresh
