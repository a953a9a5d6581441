"""The port's round-5 tools (``softspoken_tpu_torch.tools.train_r05``,
``retrain_gate_r05``, ``probe_agc_r05``, ``probe_scratch_channels``) against
the JAX package's scripts of the same names on the CPU: the supervisor's
recipe, trainer commands and retry rules (a fake trainer stands in for
training); the gate's verdict held to ``docs/RETRAIN_GATE_r05.json`` and to
the JAX gate on a prepared workdir; the AGC's written samples and one
condition of the AGC probe end to end through both packages; the scratch
probe's eval-set fingerprints and record."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import softspoken_tpu
import softspoken_tpu.config as jcfg
import softspoken_tpu.engine as jengine
import softspoken_tpu.train.evaluate as JE
from softspoken_tpu_torch import cli
from softspoken_tpu_torch import config as tcfg
from softspoken_tpu_torch.ckpt import fixture_state_dict, save_pth
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.tools import probe_agc_r05 as PA
from softspoken_tpu_torch.tools import probe_scratch_channels as PS
from softspoken_tpu_torch.tools import quality_grid as QT
from softspoken_tpu_torch.tools import real_audio_check as RA
from softspoken_tpu_torch.tools import retrain_gate_r05 as RG
from softspoken_tpu_torch.tools import train_r05 as TR
from softspoken_tpu_torch.train import evaluate as TE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_agc_r05 as JPA  # noqa: E402
import probe_scratch_channels as JPS  # noqa: E402
import quality_grid as JQ  # noqa: E402
import retrain_gate_r05 as JRG  # noqa: E402
import train_r05 as JTR  # noqa: E402

torch.set_num_threads(2)

# the committed weights as a .pth, which both packages read (the JAX
# package's orbax original would cost its reader's ~8 s import here)
CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint.pth")
# an engine small enough for the CPU, the same in both packages, in float32
# ("parity"): the two packages' bf16 CPU convolutions round differently
SMALL_ENGINE = dict(device_batch=8, chunk_seconds=4.8, precision="parity")


def _load(name):
    with open(os.path.join(DOCS, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# train_r05: the supervisor

def test_the_recipe_and_the_quick_recipe_json_are_the_jax_scripts(tmp_path, monkeypatch):
    assert TR.RECIPE == JTR.RECIPE
    wd_t, wd_j = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(TR, "ckpt_epoch", lambda path: 80)
    monkeypatch.setattr(JTR, "ckpt_epoch", lambda path: 80)
    out = TR.main(["--quick", "--workdir", str(wd_t)])
    monkeypatch.setattr(sys, "argv", ["train_r05.py", "--quick", "--workdir", str(wd_j)])
    JTR.main()
    assert (wd_t / "recipe.json").read_bytes() == (wd_j / "recipe.json").read_bytes()
    assert out["steps"] == 80 and out["recipe"]["quick"] is True
    assert not (wd_t / "train_r05.log").exists()  # a finished run launches no trainer


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("done", [0, 50])
def test_each_trainer_command_is_the_jax_scripts_on_the_ports_cli(tmp_path, monkeypatch,
                                                                  done, quick):
    """The command the JAX supervisor launches at ``done`` steps, with the
    port's module, its .pth in place of the orbax directory and --device:
    from scratch at first, then ``--steps total-done --resume`` its own
    checkpoint; it parses under the port's ``train``."""
    flag = ["--quick"] if quick else []
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        raise KeyboardInterrupt  # one command is all this test needs

    monkeypatch.setattr(JTR, "ckpt_epoch", lambda path: done)
    monkeypatch.setattr(JTR.subprocess, "run", fake_run)
    wd = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", ["train_r05.py", *flag, "--workdir", str(wd)])
    with pytest.raises(KeyboardInterrupt):
        JTR.main()
    args = TR.parser().parse_args([*flag, "--device", "cpu"])
    total = 80 if quick else 48000
    ckpt = str(tmp_path / "ckpt_r05.pth")
    ours = TR.trainer_cmd(args, total, done, ckpt)
    theirs = [ckpt if a == str(wd / "ckpt_r05") else a for a in ran[0]]
    theirs[2] = "softspoken_tpu_torch.cli"
    assert ours == theirs + ["--device", "cpu"]

    t = cli.build_parser().parse_args(ours[3:])
    assert t.func is cli.cmd_train and t.synthetic and t.device == "cpu"
    assert (t.out, t.resume) == (ckpt, ckpt if done else None)
    assert (t.steps, t.batch_size, t.lr, t.seed) == (total - done, 2 if quick else 128,
                                                     1e-3, 31337)
    assert t.augment == ["add_reverb", "reduce_volume", "gain_ramp"]
    assert t.noise_extra == ["granular", "drone", "impact_chain", "crackle"]
    assert (t.noise_extra_frac, t.noise_extra_policy, t.snr_min, t.snr_max, t.stall_abort) \
        == (0.2, "protected", -5.0, 20.0, 900.0)
    assert (t.n_inner, t.pool_size) == ((2, 16) if quick else (10, 768))


def test_ckpt_epoch_reads_the_pth_and_gives_0_without_one(tmp_path):
    path = str(tmp_path / "ckpt_r05.pth")
    assert TR.ckpt_epoch(path) == 0
    (tmp_path / "ckpt_r05.pth.abc123.tmp").write_bytes(b"half a checkpoint")
    assert TR.ckpt_epoch(path) == 0  # a stray .tmp of an interrupted save
    save_pth(path, fixture_state_dict(seed=0), epoch=50)
    assert TR.ckpt_epoch(path) == 50
    save_pth(path, fixture_state_dict(seed=0))  # a converted file: epoch -1
    assert TR.ckpt_epoch(path) == 0
    for junk in (b"", b"not a zip archive"):
        (tmp_path / "ckpt_r05.pth").write_bytes(junk)
        assert TR.ckpt_epoch(path) == 0


FAKE_TRAINER = """\
import json, shutil, sys
argv = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(argv) + "\\n")
calls = sum(1 for _ in open({log!r}))
out = argv[argv.index("--out") + 1]
mode = {mode!r}
if mode == "stall_then_finish":
    if calls == 1:
        shutil.copy({pth50!r}, out)  # saved at step 50, then stalled
        sys.exit(86)
    shutil.copy({pth80!r}, out)
    sys.exit(0)
sys.exit(1)  # "crash": fails before any checkpoint
"""


def _fake_trainer(tmp_path, monkeypatch, mode):
    """Replaces the trainer by a script that logs its arguments and, per
    ``mode``, writes the run's checkpoint and exits 86, then 0; or exits 1
    without progress."""
    pth = {}
    for epoch in (50, 80):
        pth[epoch] = str(tmp_path / f"epoch{epoch}.pth")
        torch.save({"model_state_dict": {}, "epoch": epoch}, pth[epoch])
    log = str(tmp_path / "trainer_calls.jsonl")
    script = tmp_path / "fake_trainer.py"
    script.write_text(FAKE_TRAINER.format(log=log, mode=mode, pth50=pth[50], pth80=pth[80]))
    real = TR.trainer_cmd
    monkeypatch.setattr(TR, "trainer_cmd", lambda *a: [sys.executable, str(script),
                                                       *real(*a)[3:]])
    return log


def _calls(log):
    with open(log) as f:
        return [json.loads(ln) for ln in f]


def test_the_supervisor_resumes_after_a_stall(tmp_path, monkeypatch, capsys):
    log = _fake_trainer(tmp_path, monkeypatch, "stall_then_finish")
    wd = tmp_path / "wd"
    out = TR.main(["--quick", "--workdir", str(wd), "--device", "cpu"])
    calls = _calls(log)
    assert len(calls) == 2
    ckpt = str(wd / "ckpt_r05.pth")
    first, second = calls
    assert first[first.index("--steps") + 1] == "80" and "--resume" not in first
    assert second[second.index("--steps") + 1] == "30"
    assert second[second.index("--resume") + 1] == ckpt == second[second.index("--out") + 1]
    printed = capsys.readouterr().out
    assert "trainer exited rc=86; retry 1/12" in printed
    assert "resuming from step 50 (30 to go)" in printed
    assert out["steps"] == 80 and TR.ckpt_epoch(ckpt) == 80
    # a rerun of a finished run launches nothing
    TR.main(["--quick", "--workdir", str(wd), "--device", "cpu"])
    assert len(_calls(log)) == 2
    with open(wd / "train_r05.log") as f:
        assert f.read().count("=== attempt") == 2


def test_the_supervisor_stops_on_a_failure_without_progress(tmp_path, monkeypatch):
    log = _fake_trainer(tmp_path, monkeypatch, "crash")
    with pytest.raises(SystemExit, match="rc=1 without progress"):
        TR.main(["--quick", "--workdir", str(tmp_path / "wd"), "--device", "cpu"])
    assert len(_calls(log)) == 1


def test_a_workdir_of_another_recipe_is_refused(tmp_path):
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "recipe.json").write_text(json.dumps(dict(TR.RECIPE, steps=80, quick=False)))
    with pytest.raises(SystemExit, match="different recipe"):
        TR.main(["--quick", "--workdir", str(wd)])


# ---------------------------------------------------------------------------
# retrain_gate_r05: the adoption gate

def test_the_verdict_reproduces_retrain_gate_r05():
    """The candidate rebuilt from the record's per_condition and music
    candidate, against the committed QUALITY_r04 and QUALITY_r03_realaudio:
    every key of the record, exactly."""
    doc = _load("RETRAIN_GATE_r05.json")
    grid_0 = _load("QUALITY_r04.json")
    grid_c = {"conditions": {t: {"parity": {"frame_f1": row["candidate"]}}
                             for t, row in doc["per_condition"].items()}}
    assert {t: row["committed"] for t, row in doc["per_condition"].items()} == {
        t: r["parity"]["frame_f1"] for t, r in grid_0["conditions"].items()}
    real_c = {"false_positives_on_real_audio": {"music_house": {
        "false_fraction": doc["music_false_fraction"]["candidate"]}}}
    got = RG.verdict(grid_c, real_c, grid_0, _load("QUALITY_r03_realaudio.json"),
                     doc["recipe"], doc["grid_artifact"], doc["real_artifact"])
    for k in ("adopt", "gate_no_regression_ok", "gate_fading_improves_ok", "gate_music_ok",
              "regressed_conditions", "conditions_better_worse",
              "worst_candidate_condition"):
        assert got[k] == doc[k], k
    assert json.loads(json.dumps(got)) == doc


def test_a_partial_grid_is_refused_outside_quick():
    grid_0 = _load("QUALITY_r04.json")
    grid_c = {"conditions": {t: r for t, r in grid_0["conditions"].items()
                             if t != "v2_fading"}}
    real = _load("QUALITY_r03_realaudio.json")
    with pytest.raises(SystemExit, match="missing 1 committed conditions"):
        RG.verdict(grid_c, real, grid_0, real, {"quick": False}, "g", "r")
    got = RG.verdict(grid_c, real, grid_0, real, {"quick": True}, "g", "r")
    assert got["v2_fading"]["candidate"] is None and not got["gate_fading_improves_ok"]


def _prepare(done: dict, recipe: dict, outputs: dict):
    """Every stage's output, fingerprinted with the recipe, so that the gate
    goes straight to its verdict."""
    for key, path in done.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(outputs[key], f)
        with open(path + ".fp.json", "w") as f:
            json.dump(recipe, f)


@pytest.mark.parametrize("adopt", [True, False], ids=["adopts", "rejects"])
def test_the_gate_gives_the_jax_gates_verdict(tmp_path, monkeypatch, adopt):
    """--quick on prepared workdirs (the JAX gate writes into docs/ without
    it): the same verdict from the same grid and probe."""
    grid = _load("QUALITY_r05.json")
    real = _load("QUALITY_r03_realaudio.json")
    if adopt:
        for res in grid["conditions"].values():
            res["parity"]["frame_f1"] = min(1.0, round(res["parity"]["frame_f1"] + 0.3, 4))
        real["false_positives_on_real_audio"]["music_house"]["false_fraction"] = 0.0
    outputs = {"grid": grid, "real": real}
    wd_t, wd_j = str(tmp_path / "port"), str(tmp_path / "jax")
    recipe, stages = RG.plan(RG.parser().parse_args(["--quick", "--workdir", wd_t]))
    _prepare({k: p for k, (p, _c) in stages.items()}, recipe, outputs)
    recipe_j = dict(recipe, ckpt=os.path.join(wd_j, "ckpt_r05"))
    _prepare({"grid": os.path.join(wd_j, "quality_candidate.json"),
              "real": os.path.join(wd_j, "real_candidate.json")}, recipe_j, outputs)

    ours = RG.main(["--quick", "--workdir", wd_t])
    monkeypatch.setattr(sys, "argv", ["retrain_gate_r05.py", "--quick", "--workdir", wd_j])
    JRG.main()
    with open(os.path.join(wd_j, "RETRAIN_GATE_r05.json")) as f:
        theirs = json.load(f)
    with open(os.path.join(wd_t, "RETRAIN_GATE_r05.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    for side, wd in ((ours, wd_t), (theirs, wd_j)):
        assert side.pop("grid_artifact") == os.path.join(wd, "quality_candidate.json")
        assert side.pop("real_artifact") == os.path.join(wd, "real_candidate.json")
        side.pop("recipe")
    assert json.loads(json.dumps(ours)) == theirs
    assert ours["adopt"] is adopt and ours["per_condition"]


def test_each_gate_stage_parses_under_the_ports_own_parsers(tmp_path):
    wd = str(tmp_path / "wd")
    for quick in (False, True):
        flags = ["--workdir", wd, "--device", "cpu", "--data-dir", "/clips"]
        recipe, stages = RG.plan(RG.parser().parse_args(flags + (["--quick"] if quick else [])))
        ckpt = os.path.join(wd, "ckpt_r05.pth")
        assert recipe == {"ckpt": ckpt, "files": 2 if quick else 8,
                          "seconds": 30.0 if quick else 120.0, "quick": quick,
                          "plan": "docs/ROUND5_PLAN.md"}
        grid_json, grid = stages["grid"]
        assert grid[1:3] == ["-m", "softspoken_tpu_torch.tools.quality_grid"]
        g = QT.parser().parse_args(grid[3:])
        assert (g.ckpt, g.out, g.files, g.seconds, g.quick, g.device, g.workdir) == (
            ckpt, grid_json, recipe["files"], recipe["seconds"], quick, "cpu", None)
        assert g.cache_dir == os.path.join(wd, "grid_cache")
        real_json, real = stages["real"]
        assert real[1:3] == ["-m", "softspoken_tpu_torch.tools.real_audio_check"]
        r = RA.parser().parse_args(real[3:])
        assert (r.ckpt, r.out, r.quick, r.device, r.data_dir, r.workdir) == (
            ckpt, real_json, quick, "cpu", "/clips", os.path.join(wd, "real_wd"))


def test_the_gate_stops_after_the_grid_naming_missing_clips(tmp_path):
    wd = str(tmp_path / "wd")
    args = ["--quick", "--workdir", wd, "--data-dir", str(tmp_path / "no_clips")]
    recipe, stages = RG.plan(RG.parser().parse_args(args))
    _prepare({"grid": stages["grid"][0]}, recipe, {"grid": _load("QUALITY_r05.json")})
    with pytest.raises(SystemExit, match="house_lo.wav, secosmic_lo.wav, boom.wav"):
        RG.main(args)
    assert not os.path.exists(os.path.join(wd, "RETRAIN_GATE_r05.json"))


# ---------------------------------------------------------------------------
# probe_agc_r05: the host AGC A/B

def test_agc_writes_the_jax_scripts_samples(tmp_path):
    """A 30 s fading v2 file (the probe's first eval set): the PCM_16 file
    the port's O(N) AGC writes is byte-equal to the one the JAX script's
    direct convolution writes; the moving average agrees with
    ``np.convolve(mode="same")`` at odd and even windows to 1e-12 of the
    largest output (a difference of cumulative sums errs by an absolute
    amount, a few ulps of the running sum)."""
    labels = TE.make_eval_set(str(tmp_path / "set"), n_files=1, seconds=30.0, seed=9500,
                              generator="v2", degradations=["fading"])
    [(path, _truth)] = TE.load_labels(labels)
    x, sr = wavio.read(path)
    assert sr == 32000 and len(x) == 960000
    wavio.write(str(tmp_path / "port.wav"), PA.agc(x, sr), sr, subtype="PCM_16")
    # the JAX script's direct convolution runs on OpenBLAS's threads, which
    # thrash beside the other test workers: one thread (~17-28 s here)
    with threadpool_limits(1):
        wavio.write(str(tmp_path / "jax.wav"), JPA.agc(x, sr), sr, subtype="PCM_16")
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    v = np.random.default_rng(0).random(5001) ** 4
    for win in (1, 7, 8, 5000, 5001):
        want = np.convolve(v, np.ones(win) / win, mode="same")
        got = PA.moving_average_same(v, win)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * want.max())
    with pytest.raises(ValueError, match="longer than the signal"):
        PA.moving_average_same(v, 5002)


class _StubDetector:
    epoch = 1

    def __init__(self, *a, **k):
        pass


def _stub_probe(monkeypatch, module_E, module_QG, calls):
    """make_eval_set records its arguments and writes an empty set;
    detection returns nothing; the metrics are a function of the set."""
    def make_eval_set(outdir, **kw):
        calls.append((os.path.basename(outdir), kw))
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, "labels.csv")
        with open(path, "w") as f:
            f.write("file,start_time,end_time\n")
        return path

    def metrics_from(per_file, pad):
        n = len(calls) / 100
        return {"parity": {"frame_f1": 0.5 + n, "event_f1": 0.25 + n,
                           "event_error_taxonomy": {"miss": 1.0, "merged": 2.0,
                                                    "false_alarm": 3.0, "other": 4.0}}}

    monkeypatch.setattr(module_E, "make_eval_set", make_eval_set)
    monkeypatch.setattr(module_QG, "detect_set", lambda det, labeled: [])
    monkeypatch.setattr(module_QG, "metrics_from", metrics_from)


def test_the_agc_probes_eval_sets_and_record_are_the_jax_scripts(tmp_path, monkeypatch):
    """With synthesis and detection stubbed: the same eval sets (directory,
    seed 9500+i, generator, degradation per condition) in the same order,
    and the same record."""
    calls_t, calls_j = [], []
    _stub_probe(monkeypatch, TE, QT, calls_t)
    monkeypatch.setattr(PA, "Detector", _StubDetector)
    PA.main(["--workdir", str(tmp_path / "port"), "--out", str(tmp_path / "port.json"),
             "--device", "cpu"])
    _stub_probe(monkeypatch, JE, JQ, calls_j)
    monkeypatch.setattr(jengine, "Detector", _StubDetector)
    (tmp_path / "docs").mkdir()
    monkeypatch.setattr(JPA, "REPO_ROOT", str(tmp_path))  # its record is docs/PROBE_AGC_r05.json
    monkeypatch.setattr(sys, "argv", ["probe_agc_r05.py", "--workdir", str(tmp_path / "jax"),
                                      "--ckpt", "unused"])
    JPA.main()
    assert calls_t == calls_j and len(calls_t) == 8
    assert [kw["seed"] for _d, kw in calls_t] == [9500, 9501, 9502, 9503] * 2
    assert PA.CONDS == JPA.CONDS
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "docs" / "PROBE_AGC_r05.json").read_text()))


def test_the_agc_probe_takes_a_config_and_a_wire(tmp_path, monkeypatch):
    """--config replaces the defaults (as the CLI's), --upload-codec picks the
    wire over it; without either the engine is ``Config()``'s."""
    seen = []

    class Det(_StubDetector):
        def __init__(self, cfg, **kw):
            seen.append(cfg.engine)

    monkeypatch.setattr(PA, "Detector", Det)
    monkeypatch.setattr(PA, "CONDS", [])
    conf = tmp_path / "parity.json"
    conf.write_text(json.dumps({"engine": {"precision": "parity", "pipeline": "fused",
                                           "upload_codec": "adpcm4"}}))
    for argv in ([], ["--config", str(conf)], ["--config", str(conf), "--upload-codec",
                                               "mulaw8"]):
        PA.main([*argv, "--workdir", str(tmp_path / "wd"), "--out", str(tmp_path / "o.json"),
                 "--device", "cpu"])
    default = tcfg.Config().engine
    assert seen[0] == default
    assert (seen[1].precision, seen[1].pipeline, seen[1].upload_codec) == (
        "parity", "fused", "auto")
    assert seen[2].upload_codec == "mulaw8" and seen[2].precision == "parity"


def test_one_agc_condition_end_to_end_equals_the_jax_script(tmp_path, monkeypatch):
    """Fading in both generators, 1 file x 8 s, the committed weights (the
    .pth in both packages), each package's own Detector on the CPU: the eval files
    byte-equal, frame and event F1 within 0.01 / 0.03 per arm, the
    taxonomy's keys.  The JAX script finds the port's AGC twins in place and
    reuses them (it writes each twin once), so its ``np.convolve`` (~20 s on
    one thread) does not run again: the test above holds a twin's bytes to
    it."""
    if not os.path.isfile(CKPT):
        pytest.skip("trained checkpoint not present")

    class TSmall(tcfg.Config):
        def with_engine(self, **kw):
            return tcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    monkeypatch.setattr(PA, "Config", TSmall)
    monkeypatch.setattr(softspoken_tpu, "Config",
                        lambda: jcfg.Config().with_engine(**SMALL_ENGINE))
    monkeypatch.setattr(PA, "CONDS", PA.CONDS[:1])
    monkeypatch.setattr(JPA, "CONDS", JPA.CONDS[:1])
    monkeypatch.setattr(JPA, "REPO_ROOT", str(tmp_path))
    (tmp_path / "docs").mkdir()
    small = ["--files", "1", "--seconds", "8"]
    wp, wj = tmp_path / "port", tmp_path / "jax"
    ours = PA.main([*small, "--device", "cpu", "--workdir", str(wp),
                    "--out", str(tmp_path / "p.json")])
    twins = [os.path.join(f"eval_{gen}_fading", "eval_000_agc.wav") for gen in ("v1", "v2")]
    for twin in twins:
        os.makedirs(wj / os.path.dirname(twin))
        shutil.copy(wp / twin, wj / twin)
    monkeypatch.setattr(sys, "argv", ["probe_agc_r05.py", *small, "--ckpt", CKPT,
                                      "--workdir", str(wj)])
    JPA.main()
    theirs = json.loads((tmp_path / "docs" / "PROBE_AGC_r05.json").read_text())
    written = sorted(os.path.relpath(os.path.join(d, f), wj)
                     for d, _, fs in os.walk(wj) for f in fs if f.endswith(".wav"))
    files = [os.path.join(os.path.dirname(twin), "eval_000.wav") for twin in twins]
    assert written == sorted(files + twins)
    for rel in files:
        assert (wp / rel).read_bytes() == (wj / rel).read_bytes(), rel
    assert set(ours) == set(theirs) and set(ours["conditions"]) == set(theirs["conditions"])
    for tag, row in ours["conditions"].items():
        assert set(row) == set(theirs["conditions"][tag])
        for arm in ("baseline", "agc"):
            got, want = row[arm], theirs["conditions"][tag][arm]
            assert set(got["taxonomy"]) == set(want["taxonomy"])
            assert abs(got["frame_f1"] - want["frame_f1"]) <= 0.01, (tag, arm)
            assert abs(got["event_f1"] - want["event_f1"]) <= 0.03, (tag, arm)


def test_the_ports_agc_record_holds_to_the_jax_record():
    """docs/PROBE_AGC_torch.json (the port's probe on the card at the
    defaults, on the mulaw8 wire: the JAX package's "auto" wire on its TPU)
    against docs/PROBE_AGC_r05.json: the same keys and parameters, frame and
    event F1 within 0.01 / 0.03 per condition and arm."""
    ours, theirs = _load("PROBE_AGC_torch.json"), _load("PROBE_AGC_r05.json")
    assert {k: v for k, v in ours.items() if k != "conditions"} == {
        k: v for k, v in theirs.items() if k != "conditions"}
    assert list(ours["conditions"]) == list(theirs["conditions"])
    for tag, row in ours["conditions"].items():
        assert set(row) == set(theirs["conditions"][tag])
        for arm in ("baseline", "agc"):
            got, want = row[arm], theirs["conditions"][tag][arm]
            assert abs(got["frame_f1"] - want["frame_f1"]) <= 0.01, (tag, arm)
            assert abs(got["event_f1"] - want["event_f1"]) <= 0.03, (tag, arm)
            assert set(got["taxonomy"]) == set(want["taxonomy"])


# ---------------------------------------------------------------------------
# probe_scratch_channels: the two-arm from-scratch probe

def _stub_sets(monkeypatch, module_E, calls):
    def make_eval_set(outdir, **kw):
        calls.append(kw)
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, "labels.csv")
        with open(path, "w") as f:
            f.write("file,start_time,end_time\n")
        return path

    monkeypatch.setattr(module_E, "make_eval_set", make_eval_set)


def test_build_eval_sets_reuses_and_rebuilds_as_the_jax_script(tmp_path, monkeypatch):
    """Six sets built once with seeds 7600+i; the fingerprint files
    byte-equal; a rerun with the same parameters reuses every set, one with
    other seconds rebuilds every set, a set without its fingerprint is
    rebuilt."""
    calls_t, calls_j = [], []
    _stub_sets(monkeypatch, TE, calls_t)
    _stub_sets(monkeypatch, JE, calls_j)
    wd_t, wd_j = str(tmp_path / "port"), str(tmp_path / "jax")
    for n, seconds in ((1, 30.0), (1, 30.0), (1, 60.0)):
        sets_t = PS.build_eval_sets(wd_t, n, seconds)
        sets_j = JPS.build_eval_sets(wd_j, n, seconds)
        assert {t: os.path.relpath(p, wd_t) for t, p in sets_t.items()} == {
            t: os.path.relpath(p, wd_j) for t, p in sets_j.items()}
        assert calls_t == calls_j
    assert len(calls_t) == 12 and [kw["seed"] for kw in calls_t[:6]] == [7600, 7601, 7602] * 2
    for tag, path in sets_t.items():
        with open(path + ".fp.json", "rb") as a, open(sets_j[tag] + ".fp.json", "rb") as b:
            assert a.read() == b.read(), tag
    os.remove(sets_t["v2_fading"] + ".fp.json")
    os.remove(sets_j["v2_fading"] + ".fp.json")
    PS.build_eval_sets(wd_t, 1, 60.0)
    JPS.build_eval_sets(wd_j, 1, 60.0)
    assert calls_t == calls_j and len(calls_t) == 13


def test_the_scratch_probes_commands_and_record_are_the_jax_scripts(tmp_path, monkeypatch):
    """--quick with training, synthesis and scoring stubbed: each arm's
    train command is the JAX script's on the port's CLI (its .pth in place of
    the orbax directory), and the record, delta_B_minus_A included, equals
    the JAX script's on the same scores."""
    tags = [f"{g}_{c}" for g in ("v1", "v2") for c, _ in PS.CONDS]
    rng = np.random.default_rng(5)
    scores = {arm: {t: {"frame_f1": round(float(rng.random()), 4),
                        "event_f1": round(float(rng.random()), 4)} for t in tags}
              for arm in PS.ARMS}
    cmds = {"port": [], "jax": []}

    def patch(mod, side, ext):
        monkeypatch.setattr(mod, "stage", lambda name, done, fp, fn: fn())
        monkeypatch.setattr(mod, "run", lambda cmd, log, retries=0: cmds[side].append(cmd))
        monkeypatch.setattr(mod, "build_eval_sets",
                            lambda wd, n, s: {t: os.path.join(wd, t) for t in tags})
        monkeypatch.setattr(mod, "score", lambda ckpt, sets, *a: scores[
            os.path.basename(ckpt).removesuffix(ext).removeprefix("ckpt_")])

    patch(PS, "port", ".pth")
    patch(JPS, "jax", "")
    wd_t, wd_j = tmp_path / "port", tmp_path / "jax"
    ours = PS.main(["--quick", "--workdir", str(wd_t), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["probe_scratch_channels.py", "--quick",
                                      "--workdir", str(wd_j)])
    JPS.main()
    theirs = json.loads((wd_j / "probe_quick.json").read_text())
    assert json.loads((wd_t / "probe_quick.json").read_text()) == theirs
    assert json.loads(json.dumps(ours)) == theirs
    assert PS.summarize(scores, 8, 1, 30.0, True) == ours
    for tag, row in ours["per_condition"].items():
        assert row["delta_B_minus_A"] == round(
            scores["B_channels"][tag]["frame_f1"] - scores["A_lineage"][tag]["frame_f1"], 4)

    assert len(cmds["port"]) == len(cmds["jax"]) == 2
    for arm, c_t, c_j in zip(PS.ARMS, cmds["port"], cmds["jax"]):
        ckpt = str(wd_t / f"ckpt_{arm}.pth")
        c_j = [ckpt if a == str(wd_j / f"ckpt_{arm}") else a for a in c_j]
        c_j[2] = "softspoken_tpu_torch.cli"
        assert c_t == c_j + ["--device", "cpu"]
        t = cli.build_parser().parse_args(c_t[3:])
        assert (t.out, t.resume, t.steps, t.batch_size, t.seed, t.augment, t.device) == (
            ckpt, None, 8, 2, 31337, PS.ARMS[arm], "cpu")
