"""The port's quality grid (``softspoken_tpu_torch.tools.quality_grid`` and
``compare_grids``) against the JAX package's ``scripts/quality_grid.py`` on
the CPU: the same metrics from the same score grids, caches each reads from
the other, and a tiny end-to-end grid of both with the same trained weights.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import softspoken_tpu
import softspoken_tpu.config as jcfg
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import config as tcfg
from softspoken_tpu_torch import tools
from softspoken_tpu_torch.tools import compare_grids as TCG
from softspoken_tpu_torch.tools import quality_grid as QT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import compare_grids as JCG  # noqa: E402
import quality_grid as JQ  # noqa: E402

torch.set_num_threads(2)

CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")
TOL = 1e-9
# an engine small enough for the CPU; the same in both packages
SMALL_ENGINE = dict(device_batch=8, chunk_seconds=9.0)


def assert_same(a, b, path="$"):
    """Equal nested dicts/lists; floats within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


class _Res:
    def __init__(self, avg, dur, intervals):
        self.avg_values = avg
        self.audio_seconds = dur
        self.intervals = intervals


class _StubDet:
    """Score grids keyed by path, the same for both packages."""

    def __init__(self, grids):
        self.grids = grids

    def detect_file_streaming(self, path):
        return _Res(*self.grids[path])


def _per_file_pair(seed, tmp_path=None, n=3, seconds=30.0):
    """Seeded synthetic score grids with bursts near truth events, through
    both packages' ``detect_set``; with ``tmp_path``, each file's audio (a
    noise floor with tone bursts and a beat) is written for the post-filter."""
    rng = np.random.default_rng(seed)
    grids, labeled = {}, []
    for i in range(n):
        nb = int((seconds + 6.0) / (3.0 / 256))
        avg = rng.uniform(0.0, 0.09, size=nb).astype(np.float32)
        truth = []
        for _ in range(rng.integers(2, 5)):
            s = float(rng.uniform(1.0, seconds - 4.0))
            e = s + float(rng.uniform(0.3, 3.0))
            truth.append((round(s, 3), round(e, 3)))
            b0 = int((s + 3.0 + rng.uniform(-0.3, 0.3)) / (3.0 / 256))
            b1 = int((e + 3.0 + rng.uniform(-0.3, 0.3)) / (3.0 / 256))
            avg[b0:b1] = rng.uniform(0.05, 0.9, size=max(0, b1 - b0))
        name = f"f{seed}_{i}.wav"
        path = str(tmp_path / name) if tmp_path is not None else name
        if tmp_path is not None:
            sr = 32000
            t = np.arange(int(seconds * sr)) / sr
            x = 0.01 * rng.standard_normal(t.size)
            for s, e in truth:
                m = (t >= s) & (t < e)
                x[m] += 0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t[m])
            if i == 0:  # a 2 Hz kick under the whole file: music-like
                x += 0.2 * np.sin(2 * np.pi * 55 * t) * (np.mod(t, 0.5) < 0.08)
            jwavio.write(path, x.astype(np.float32), sr, subtype="PCM_16")
        grids[path] = (avg, seconds, ((1.0, 3.0),))
        labeled.append((path, sorted(truth)))
    det = _StubDet(grids)
    return QT.detect_set(det, labeled), JQ.detect_set(det, labeled)


def test_the_grid_definition_is_the_jax_scripts():
    assert QT.CONDITIONS == JQ.CONDITIONS
    assert (QT.THRESHOLDS, QT.HYST_EXITS, QT.PARITY, QT.TUNED) == (
        JQ.THRESHOLDS, JQ.HYST_EXITS, JQ.PARITY, JQ.TUNED)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("pad", [3.0, 0.0])
def test_metrics_from_equals_jax(seed, pad):
    ours, theirs = _per_file_pair(seed)
    got = QT.metrics_from(ours, pad)
    assert got["parity"]["event_error_taxonomy"]
    assert_same(got, JQ.metrics_from(theirs, pad))


@pytest.mark.parametrize("threshold", [0.3, 0.85])
def test_postfilter_parity_metrics_equals_jax(tmp_path, threshold):
    ours, theirs = _per_file_pair(11, tmp_path, n=2, seconds=20.0)
    got = QT.postfilter_parity_metrics(ours, 3.0, threshold)
    assert got["files_scored"] == 2 and got["regions_total"] > 0
    assert_same(got, JQ.postfilter_parity_metrics(theirs, 3.0, threshold))


def test_postfilter_parity_metrics_skips_missing_audio(tmp_path):
    ours, theirs = _per_file_pair(5)
    for pf in ours + theirs:
        pf["path"] = str(tmp_path / "gone.wav")
    got = QT.postfilter_parity_metrics(ours, 3.0, 0.85)
    assert got == JQ.postfilter_parity_metrics(theirs, 3.0, 0.85)
    assert got["skipped_files"] == 3


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_cache(tmp_path, writer):
    ours, theirs = _per_file_pair(7)
    save, load = (QT.save_cache, JQ.load_cache) if writer == "port" else (
        JQ.save_cache, QT.load_cache)
    p = str(tmp_path / "v1_clean.npz")
    save(p, ours if writer == "port" else theirs)
    back = load(p)
    assert len(back) == 3
    for a, b in zip(ours, back):
        np.testing.assert_array_equal(a["avg"], b["avg"])
        assert (a["dur"], a["truth"], a["intervals"], a["path"]) == (
            b["dur"], [tuple(t) for t in b["truth"]], b["intervals"], b["path"])
    assert_same(QT.metrics_from(back, 3.0), JQ.metrics_from(theirs, 3.0))


def test_no_default_out_names_a_file_under_docs():
    """The defaults of every tool that writes, and --quick's redirect."""
    from softspoken_tpu_torch.tools import codec_gate, music_filter_gate, profile_chunk

    for mod in (QT, codec_gate, music_filter_gate, profile_chunk):
        path = tools.resolve_out(mod.DEFAULT_OUT)
        assert os.path.commonpath([path, tools.DOCS]) != tools.DOCS, path
    with pytest.raises(SystemExit, match="committed evidence"):
        tools.resolve_out("docs/QUALITY_r05.json")
    with pytest.raises(SystemExit, match="committed evidence"):
        QT.main(["--quick", "--out", "docs/QUALITY_r04.json", "--device", "cpu"])
    # a new file under docs/ may be written, once
    assert tools.resolve_out("docs/QUALITY_new_grid.json") == os.path.join(
        tools.DOCS, "QUALITY_new_grid.json")


def test_random_init_and_a_foreign_cache_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="epoch<0"):
        QT.main(["--ckpt", str(tmp_path / "none.pth"), "--device", "cpu",
                 "--out", str(tmp_path / "g.json")])
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "cache_ckpt.json").write_text(json.dumps({"ckpt": "other"}))
    with pytest.raises(SystemExit, match="different run"):
        QT.main(["--cache-dir", str(cache), "--device", "cpu",
                 "--out", str(tmp_path / "g.json")])


def test_the_upload_wire_reaches_the_detector_and_keys_the_cache(tmp_path, monkeypatch):
    """``--upload-codec`` (the TPU's records ran on its "auto" wire, mu-law
    decimated to 16 kHz; on the card "auto" is pcm16) sets the detector's
    wire, and a cache of one wire is never reused under another."""
    seen = []

    class Stop(Exception):
        pass

    def stop(det, labeled):
        seen.append(det.cfg.engine.upload_codec)
        raise Stop

    monkeypatch.setattr(QT, "detect_set", stop)
    cache = tmp_path / "cache"
    argv = ["--cache-dir", str(cache), "--device", "cpu", "--files", "1", "--seconds", "2",
            "--out", str(tmp_path / "g.json"), "--workdir", str(tmp_path / "w")]
    with pytest.raises(Stop):
        QT.main([*argv, "--upload-codec", "mulaw8"])
    with pytest.raises(Stop):
        QT.main(argv[2:])
    assert seen == ["mulaw8", "auto"]
    assert json.loads((cache / "cache_ckpt.json").read_text())["upload_codec"] == "mulaw8"
    with pytest.raises(SystemExit, match="different run"):
        QT.main(argv)


def test_the_grid_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QT.main(["--out", str(tmp_path / "g.json")])


def test_tiny_grid_of_both_packages(tmp_path, monkeypatch, capsys):
    """2 conditions x 2 generators, 1 file x 10 s, the committed weights
    (.pth here, the orbax original there): the same JSON keys, every
    condition's F1 within 0.01 frame / 0.03 event with and without the
    post-filter; each package rescores the other's --cache-dir to the
    writer's metrics; compare_grids of either package prints the same."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")

    class TSmall(tcfg.Config):
        def with_engine(self, **kw):
            return tcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    class JSmall(jcfg.Config):
        def with_engine(self, **kw):
            return jcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    monkeypatch.setattr(QT, "Config", TSmall)
    monkeypatch.setattr(softspoken_tpu, "Config", JSmall)
    monkeypatch.setattr(QT, "CONDITIONS", QT.CONDITIONS[:2])
    monkeypatch.setattr(JQ, "CONDITIONS", JQ.CONDITIONS[:2])
    small = ["--files", "1", "--seconds", "10"]
    ours_out, theirs_out = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    cache = str(tmp_path / "cache")
    ours = QT.main([*small, "--device", "cpu", "--out", ours_out, "--cache-dir", cache,
                    "--workdir", str(tmp_path / "wp")])
    jcache = str(tmp_path / "jcache")
    monkeypatch.setattr(sys, "argv", ["quality_grid.py", *small, "--out", theirs_out,
                                      "--ckpt", CKPT, "--workdir", str(tmp_path / "wj"),
                                      "--cache-dir", jcache])
    JQ.main()
    with open(theirs_out) as f:
        theirs = json.load(f)
    with open(ours_out) as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    assert set(ours) == set(theirs)
    assert set(ours["conditions"]) == set(theirs["conditions"]) == {
        "v1_clean", "v1_snr0", "v2_clean", "v2_snr0"}
    for tag, got in ours["conditions"].items():
        want = theirs["conditions"][tag]
        assert set(got) == set(want)
        for key in ("parity", "parity_postfilter"):
            assert abs(got[key]["frame_f1"] - want[key]["frame_f1"]) <= 0.01, (tag, key)
            assert abs(got[key]["event_f1"] - want[key]["event_f1"]) <= 0.03, (tag, key)
    assert ours["summary"]["worst_out_of_family"]["condition"].startswith("v2_")

    # the JAX script rescores the port's cache to the port's metrics
    rescored = str(tmp_path / "rescored.json")
    monkeypatch.setattr(sys, "argv", ["quality_grid.py", *small, "--out", rescored,
                                      "--rescore", cache, "--no-postfilter-ab"])
    JQ.main()
    with open(rescored) as f:
        back = json.load(f)["conditions"]
    for tag, got in ours["conditions"].items():
        assert back[tag]["parity"] == got["parity"], tag
        assert back[tag]["threshold_sweep"] == got["threshold_sweep"], tag
    # and the port rescores the JAX script's cache to the JAX metrics
    back = QT.main([*small, "--out", str(tmp_path / "rescored2.json"), "--rescore", jcache,
                    "--no-postfilter-ab"])["conditions"]
    for tag, want in theirs["conditions"].items():
        assert back[tag]["parity"] == want["parity"], tag
        assert back[tag]["smooth_sweep"] == want["smooth_sweep"], tag

    capsys.readouterr()
    TCG.main([theirs_out, ours_out])
    ours_text = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["compare_grids.py", theirs_out, ours_out])
    JCG.main()
    assert ours_text == capsys.readouterr().out
    assert "conditions better/worse (frame):" in ours_text
