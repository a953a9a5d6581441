"""The port's real-audio probe (``softspoken_tpu_torch.tools.real_audio_check``)
against the JAX package's ``scripts/real_audio_check.py`` on the CPU, on the
same pygame clips: the beds and mixes it writes are byte-equal, and the
probe numbers agree within the stated tolerances.  The runs on the clips
skip where pygame is absent, as ``tests/test_real_audio.py`` does; the
records' comparisons need no clips."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import softspoken_tpu
import softspoken_tpu.config as jcfg
from softspoken_tpu_torch import config as tcfg
from softspoken_tpu_torch.tools import real_audio_check as RA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import real_audio_check as JRA  # noqa: E402

torch.set_num_threads(2)

CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")
# an engine small enough for the CPU, the same in both packages, in float32
# ("parity"): the default bf16 convolutions of the two packages round
# differently on the CPU (grid maxima ~4e-2 apart), which would hide the
# tool's own differences under the model's
SMALL_ENGINE = dict(device_batch=8, chunk_seconds=4.8, precision="parity")
SMALL = ["--seconds", "8", "--files", "1", "--snrs", "10"]


@pytest.fixture
def clips():
    """pygame's example data, where pygame is installed."""
    pytest.importorskip("pygame")
    return RA.pygame_data_dir()


def test_the_clips_and_the_bed_are_the_jax_scripts(clips):
    assert RA.SOURCES == JRA.SOURCES
    assert clips == JRA._pygame_data_dir()
    assert RA.missing_clips(clips) == []
    toy = [np.linspace(-1, 1, 3000, dtype=np.float32), np.ones(500, np.float32)]
    a = RA.make_bed(toy, 2.0, 8000, np.random.default_rng(3))
    b = JRA.make_bed(toy, 2.0, 8000, np.random.default_rng(3))
    assert a.tobytes() == b.tobytes()


def test_missing_clips_exit_naming_them_and_write_nothing(tmp_path):
    (tmp_path / "clips").mkdir()
    (tmp_path / "clips" / "boom.wav").write_bytes(b"")
    out = tmp_path / "r.json"
    with pytest.raises(SystemExit, match="house_lo.wav, secosmic_lo.wav, car_door.wav") as e:
        RA.main(["--data-dir", str(tmp_path / "clips"), "--out", str(out), "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert not out.exists()


def test_the_probe_needs_the_card_unless_asked_for_the_cpu(tmp_path, clips):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RA.main([*SMALL, "--out", str(tmp_path / "r.json")])


def test_real_audio_check_equals_the_jax_script(tmp_path, monkeypatch, clips):
    """8 s beds, one 8 s file at 10 dB, the committed weights (.pth here, the
    orbax original there): the beds and the mix byte-equal; per class the
    grid maximum within 1e-4, the false events, seconds and fraction equal
    or one 0.01 s grid bin apart; frame/event F1 within 0.01/0.03; the same
    JSON keys, and the port's backend tag."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")

    class TSmall(tcfg.Config):
        def with_engine(self, **kw):
            return tcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    class JSmall(jcfg.Config):
        def with_engine(self, **kw):
            return jcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    monkeypatch.setattr(RA, "Config", TSmall)
    monkeypatch.setattr(softspoken_tpu, "Config", JSmall)
    wp, wj = tmp_path / "port", tmp_path / "jax"
    ours = RA.main([*SMALL, "--device", "cpu", "--out", str(tmp_path / "p.json"),
                    "--workdir", str(wp)])
    monkeypatch.setattr(sys, "argv", ["real_audio_check.py", *SMALL, "--ckpt", CKPT,
                                      "--out", str(tmp_path / "j.json"), "--workdir", str(wj)])
    JRA.main()
    theirs = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(json.dumps(ours))

    written = sorted(os.path.relpath(os.path.join(d, f), wj)
                     for d, _, fs in os.walk(wj) for f in fs if f.endswith(".wav"))
    assert {"fp_music_house.wav", "fp_music_adpcm.wav", "fp_impacts.wav"} <= set(written)
    assert any(w.startswith("mix_snr10") for w in written)
    for rel in written:
        assert (wp / rel).read_bytes() == (wj / rel).read_bytes(), rel

    assert set(ours) == set(theirs)
    assert ours["backend"] == "torch-cpu" and ours["epoch"] == theirs["epoch"] == 48750
    assert ours["operating_point"] == theirs["operating_point"]
    fp, jfp = ours["false_positives_on_real_audio"], theirs["false_positives_on_real_audio"]
    assert set(fp) == set(jfp) == set(RA.SOURCES)
    for cls in fp:
        got, want = fp[cls], jfp[cls]
        assert set(got) == set(want)
        assert abs(got["grid_max"] - want["grid_max"]) <= 1e-4 + 1e-9, cls
        assert got["false_events"] == want["false_events"], cls
        assert abs(got["false_seconds"] - want["false_seconds"]) <= 0.01 + 1e-9, cls
        assert abs(got["false_fraction"] - want["false_fraction"]) <= 0.01 / 8 + 1e-4, cls
    rec, jrec = ours["recall_over_real_noise_beds"], theirs["recall_over_real_noise_beds"]
    assert set(rec) == set(jrec) == {"snr10"}
    got, want = rec["snr10"]["parity"], jrec["snr10"]["parity"]
    assert abs(got["frame_f1"] - want["frame_f1"]) <= 0.01
    assert abs(got["event_f1"] - want["event_f1"]) <= 0.03


def test_the_ports_probe_record_holds_to_the_jax_record():
    """docs/QUALITY_torch_realaudio.json (the port's probe of the committed
    weights at the default sizes) against docs/QUALITY_r03_realaudio.json
    (the JAX package's): false_fraction per class within 0.01, frame/event
    F1 within 0.01/0.03 at every SNR, the script's keys and operating
    point."""
    with open(os.path.join(ROOT, "docs", "QUALITY_torch_realaudio.json")) as f:
        ours = json.load(f)
    with open(os.path.join(ROOT, "docs", "QUALITY_r03_realaudio.json")) as f:
        theirs = json.load(f)
    # the JAX record adds, by hand, a "music_filter" section (a second run
    # with --music-filter 0.85) and lacks the script's operating_point key
    # music_filter (None: off)
    assert set(ours) == set(theirs) - {"music_filter"} and ours["backend"].startswith("torch-")
    assert ours["epoch"] == theirs["epoch"]
    assert ours["operating_point"] == dict(theirs["operating_point"], music_filter=None)
    fp, jfp = ours["false_positives_on_real_audio"], theirs["false_positives_on_real_audio"]
    assert set(fp) == set(jfp)
    for cls in fp:
        assert fp[cls]["bed_seconds"] == jfp[cls]["bed_seconds"] == 60.0
        assert abs(fp[cls]["false_fraction"] - jfp[cls]["false_fraction"]) <= 0.01, cls
    rec, jrec = ours["recall_over_real_noise_beds"], theirs["recall_over_real_noise_beds"]
    assert set(rec) == set(jrec) == {"snr0", "snr5", "snr10", "snr20"}
    for snr in rec:
        got, want = rec[snr]["parity"], jrec[snr]["parity"]
        assert rec[snr]["n_files"] == jrec[snr]["n_files"] == 4
        assert abs(got["frame_f1"] - want["frame_f1"]) <= 0.01, snr
        assert abs(got["event_f1"] - want["event_f1"]) <= 0.03, snr


def test_the_ports_filtered_probe_record_holds_to_the_jax_record():
    """docs/QUALITY_torch_realaudio_musicfilter.json (the same probe with
    --music-filter 0.85) against the JAX record's ``music_filter`` section:
    false_fraction per class within 0.01, and the recall over the beds the
    unfiltered run's, as the JAX record states ("identical to no-filter
    run")."""
    with open(os.path.join(ROOT, "docs", "QUALITY_torch_realaudio_musicfilter.json")) as f:
        ours = json.load(f)
    with open(os.path.join(ROOT, "docs", "QUALITY_torch_realaudio.json")) as f:
        unfiltered = json.load(f)
    with open(os.path.join(ROOT, "docs", "QUALITY_r03_realaudio.json")) as f:
        theirs = json.load(f)["music_filter"]
    assert ours["operating_point"] == theirs["operating_point"]
    fp, jfp = ours["false_positives_on_real_audio"], theirs["false_positives_with_filter"]
    assert set(fp) == set(jfp)
    for cls in fp:
        assert abs(fp[cls]["false_fraction"] - jfp[cls]["false_fraction"]) <= 0.01, cls
    assert theirs["effect"]["recall_over_real_noise_beds"].startswith("identical to no-filter")
    assert ours["recall_over_real_noise_beds"] == unfiltered["recall_over_real_noise_beds"]
