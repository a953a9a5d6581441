"""The port's fine-tune harness (``softspoken_tpu_torch.tools.ftlib`` and the
five ``ft_*`` drivers) against the JAX package's ``scripts/ftlib.py`` and
drivers: the fingerprinted stages and the stall retry of
``tests/test_ftlib.py``; each driver's verdict equal to the JAX driver's on
prepared workdirs; each verdict function held to the committed evidence
(``docs/FT_*.json``); each driver's --quick stage commands parsed by the
port's own ``train``, ``quality_grid`` and ``real_audio_check``.  Nothing
here trains or detects."""

import copy
import json
import os
import sys

import pytest

from softspoken_tpu_torch import cli
from softspoken_tpu_torch.tools import ft_boundary, ft_hisnr, ft_music, ft_snrfloor, ft_synth3
from softspoken_tpu_torch.tools import ftlib
from softspoken_tpu_torch.tools import quality_grid as QT
from softspoken_tpu_torch.tools import real_audio_check as RA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import ft_boundary as j_ft_boundary  # noqa: E402
import ft_hisnr as j_ft_hisnr  # noqa: E402
import ft_music as j_ft_music  # noqa: E402
import ft_snrfloor as j_ft_snrfloor  # noqa: E402
import ft_synth3 as j_ft_synth3  # noqa: E402

DRIVERS = {"ft_music": (ft_music, j_ft_music), "ft_synth3": (ft_synth3, j_ft_synth3),
           "ft_hisnr": (ft_hisnr, j_ft_hisnr), "ft_boundary": (ft_boundary, j_ft_boundary),
           "ft_snrfloor": (ft_snrfloor, j_ft_snrfloor)}
REAL_AUDIO = ("ft_music", "ft_synth3", "ft_hisnr")


def _load(name):
    with open(os.path.join(DOCS, name)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# ftlib: the cases of tests/test_ftlib.py, against the port's module

def test_stage_runs_and_fingerprints(tmp_path):
    out = str(tmp_path / "result.json")
    calls = []

    def fn():
        calls.append(1)
        open(out, "w").write("{}")

    ftlib.stage("s", out, {"lr": 1e-4, "steps": 100}, fn)
    assert calls == [1]
    assert os.path.exists(out + ".fp.json")
    # same fingerprint → skip
    ftlib.stage("s", out, {"lr": 1e-4, "steps": 100}, fn)
    assert calls == [1]
    # different fingerprint → refuse loudly, never silently reuse
    with pytest.raises(SystemExit, match="different parameters"):
        ftlib.stage("s", out, {"lr": 3e-5, "steps": 100}, fn)
    assert calls == [1]


def test_stage_refuses_unfingerprinted_output(tmp_path):
    out = str(tmp_path / "old.json")
    open(out, "w").write("{}")
    with pytest.raises(SystemExit, match="different parameters"):
        ftlib.stage("s", out, {"steps": 4}, lambda: None)


def test_stage_missing_output_fails(tmp_path):
    out = str(tmp_path / "never.json")
    with pytest.raises(SystemExit, match="missing"):
        ftlib.stage("s", out, {}, lambda: None)
    assert not os.path.exists(out + ".fp.json")


def test_run_retries_stall_exit_code(tmp_path):
    """Exit code 86 (the trainer's stall-abort) is retryable; other codes
    are not."""
    marker = tmp_path / "attempts"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        "p = sys.argv[1]\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(86 if n < 2 else 0)\n")
    log = str(tmp_path / "run.log")
    ftlib.run([sys.executable, str(script), str(marker)], log, retries=2)
    assert marker.read_text() == "3"
    marker.unlink()
    with pytest.raises(SystemExit, match="stage failed"):
        ftlib.run([sys.executable, str(script), str(marker)], log, retries=1)
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    with pytest.raises(SystemExit, match="stage failed"):
        ftlib.run([sys.executable, str(bad), str(tmp_path / "attempts2")], log, retries=2)
    assert ftlib.STALL_EXIT == 86


# ---------------------------------------------------------------------------
# each driver's verdict against the JAX driver's, on prepared workdirs

def _candidate_grid(adopt):
    """docs/QUALITY_r05.json as the candidate; for the adopting case every
    condition's parity F1s raised by 0.3 (capped at 1), which passes every
    driver's grid gates against QUALITY_r03/r04."""
    grid = _load("QUALITY_r05.json")
    if adopt:
        for res in grid["conditions"].values():
            for k in ("frame_f1", "event_f1"):
                res["parity"][k] = min(1.0, round(res["parity"][k] + 0.3, 4))
    return grid


def _candidate_real(adopt):
    """docs/QUALITY_r03_realaudio.json as the candidate's probe; for the
    adopting case with the house-music false fraction at 0 (passes every
    music gate)."""
    real = _load("QUALITY_r03_realaudio.json")
    if adopt:
        real["false_positives_on_real_audio"]["music_house"]["false_fraction"] = 0.0
    return real


def _prepare(wd, done, recipe, grid, real):
    """A workdir where every stage's output exists with the recipe's
    fingerprint, so that the driver goes straight to its verdict."""
    os.makedirs(os.path.dirname(done["train"]), exist_ok=True)
    outputs = {"train": None, "grid": grid, "real": real}
    for key, path in done.items():
        if outputs[key] is None:
            open(path, "wb").close()
        else:
            with open(path, "w") as f:
                json.dump(outputs[key], f)
        with open(path.rstrip("/") + ".fp.json", "w") as f:
            json.dump(recipe, f)


@pytest.mark.parametrize("adopt", [True, False], ids=["adopts", "rejects"])
@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_each_driver_gives_the_jax_drivers_verdict(tmp_path, monkeypatch, capsys, name, adopt):
    port, jax_driver = DRIVERS[name]
    grid, real = _candidate_grid(adopt), _candidate_real(adopt)
    wd_t, wd_j = str(tmp_path / "port"), str(tmp_path / "jax")
    recipe, stages = port.plan(port.parser().parse_args(["--workdir", wd_t]))
    done_t = {k: path for k, (path, _cmd) in stages.items()}
    done_j = {"train": os.path.join(wd_j, "candidate_ckpt", "manifest.ocdbt"),
              "grid": os.path.join(wd_j, "grid_candidate.json")}
    if name in REAL_AUDIO:
        done_j["real"] = os.path.join(wd_j, "realaudio_candidate.json")
    assert set(done_t) == set(done_j)
    _prepare(wd_t, done_t, recipe, grid, real)
    _prepare(wd_j, done_j, recipe, grid, real)

    ours = port.main(["--workdir", wd_t])
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--workdir", wd_j])
    jax_driver.main()
    printed = capsys.readouterr().out
    assert "stage 1 (train) skipped" in printed
    with open(os.path.join(wd_j, f"VERDICT_{name}.json")) as f:
        theirs = json.load(f)
    with open(os.path.join(wd_t, f"VERDICT_{name}.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    assert ours.pop("candidate") == done_t["train"]
    assert theirs.pop("candidate") == os.path.dirname(done_j["train"])
    assert json.loads(json.dumps(ours)) == theirs
    assert ours["adopt"] is adopt


def test_ft_hisnr_refuses_a_partial_grid_as_the_jax_driver_does(tmp_path, monkeypatch):
    grid, real = _candidate_grid(True), _candidate_real(True)
    del grid["conditions"]["v2_fading"]
    wd_t, wd_j = str(tmp_path / "port"), str(tmp_path / "jax")
    recipe, stages = ft_hisnr.plan(ft_hisnr.parser().parse_args(["--workdir", wd_t]))
    _prepare(wd_t, {k: p for k, (p, _c) in stages.items()}, recipe, grid, real)
    _prepare(wd_j, {"train": os.path.join(wd_j, "candidate_ckpt", "manifest.ocdbt"),
                    "grid": os.path.join(wd_j, "grid_candidate.json"),
                    "real": os.path.join(wd_j, "realaudio_candidate.json")}, recipe, grid, real)
    with pytest.raises(SystemExit, match="missing 1 committed conditions"):
        ft_hisnr.main(["--workdir", wd_t])
    monkeypatch.setattr(sys, "argv", ["ft_hisnr.py", "--workdir", wd_j])
    with pytest.raises(SystemExit, match="missing 1 committed conditions"):
        j_ft_hisnr.main()
    assert not os.path.exists(os.path.join(wd_t, "VERDICT_ft_hisnr.json"))


# ---------------------------------------------------------------------------
# each verdict function against the committed evidence

def _grids_from(per_condition, nested=False):
    """(candidate, committed) grids rebuilt from a verdict's per_condition."""
    cand, comm = {}, {}
    for tag, row in per_condition.items():
        if nested:
            cand[tag] = {"parity": {"frame_f1": row["frame"]["candidate"],
                                    "event_f1": row["event"]["candidate"]}}
            comm[tag] = {"parity": {"frame_f1": row["frame"]["committed"],
                                    "event_f1": row["event"]["committed"]}}
        else:
            cand[tag] = {"parity": {"frame_f1": row["candidate"]}}
            comm[tag] = {"parity": {"frame_f1": row["committed"]}}
    return {"conditions": cand}, {"conditions": comm}


def _real(fraction):
    return {"false_positives_on_real_audio": {"music_house": {"false_fraction": fraction}}}


def test_ft_music_verdict_reproduces_ft_music_r03():
    doc = _load("FT_MUSIC_r03.json")
    cmp_ = doc["grid_comparison"]
    grid_c, grid_0 = _grids_from(cmp_["per_condition"])
    real = doc["real_audio"]
    got = ft_music.verdict(grid_c, {"false_positives_on_real_audio": real["candidate"]},
                           grid_0, {"false_positives_on_real_audio": real["committed"]}, {}, "c")
    for k in ("adopt", "gate_grid_ok", "gate_music_ok"):
        assert got[k] == doc["verdict"][k], k
    assert got["regressed_conditions"] == cmp_["regressed_conditions"]
    assert got["worst_out_of_family"] == cmp_["worst_out_of_family"]
    assert got["per_condition"] == cmp_["per_condition"]
    assert got["music_false_fraction"] == {"committed": 0.5023, "candidate": 0.6727}


@pytest.mark.parametrize("name,doc_name", [("ft_synth3", "FT_SYNTH3_r04.json"),
                                           ("ft_hisnr", "FT_HISNR_r04.json")])
def test_texture_verdicts_reproduce_their_records(name, doc_name):
    port = DRIVERS[name][0]
    doc = _load(doc_name)
    grid_c, grid_0 = _grids_from(doc["per_condition"])
    mff = doc["music_false_fraction"]
    got = port.verdict(grid_c, _real(mff["candidate"]), grid_0, _real(mff["committed"]),
                       {}, "c")
    gates = [k for k in doc if k.startswith("gate_")]
    assert len(gates) == 3
    for k in ["adopt", *gates, "regressed_conditions", "worst_out_of_family",
              "music_false_fraction", "per_condition", "rule", "extras"]:
        assert got[k] == doc[k], k
    assert set(got) - {"recipe", "candidate"} <= set(doc)


def test_ft_boundary_verdict_reproduces_ft_boundary_r04():
    doc = _load("FT_BOUNDARY_r04.json")
    grid_c, grid_0 = _grids_from(doc["per_condition"], nested=True)
    got = ft_boundary.verdict(grid_c, grid_0, {}, "c")
    for k in ("adopt", "gate_no_regression_ok", "gate_event_improves_ok", "gate_frame_mean_ok",
              "v2_worst_event_f1", "v2_mean_event_f1", "v2_worst_frame_f1", "v2_mean_frame_f1",
              "regressed_conditions", "per_condition", "rule"):
        assert got[k] == doc[k], k


def test_ft_snrfloor_verdict_reproduces_ft_snrfloor_r04():
    doc = _load("FT_SNRFLOOR_r04.json")
    grid_c, grid_0 = _grids_from(doc["per_condition"])
    got = ft_snrfloor.verdict(grid_c, grid_0, doc["recipe"], "c")
    for k in ("adopt", "gate_no_regression_ok", "gate_fading_improves_ok", "gate_v2_mean_ok",
              "fading", "v2_mean_frame_f1", "regressed_conditions", "per_condition", "recipe",
              "rule"):
        assert got[k] == doc[k], k


# ---------------------------------------------------------------------------
# the stages' commands

@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_each_quick_stage_parses_under_the_ports_own_parsers(tmp_path, name):
    """--quick --device cpu: the train command is the port's CLI with the
    JAX driver's flags and seed, resuming from the committed .pth into the
    workdir's candidate.pth; the grid and the real-audio probe read that
    candidate; every stage carries --device cpu."""
    port = DRIVERS[name][0]
    wd = str(tmp_path / "wd")
    recipe, stages = port.plan(port.parser().parse_args(
        ["--workdir", wd, "--quick", "--device", "cpu"]))
    assert recipe["quick"] is True and recipe["steps"] == 4 and recipe["batch_size"] == 2
    assert list(stages) == (["train", "grid", "real"] if name in REAL_AUDIO
                            else ["train", "grid"])
    cand, train = stages["train"]
    assert cand == os.path.join(wd, "candidate.pth")
    assert train[1:4] == ["-m", "softspoken_tpu_torch.cli", "train"]
    t = cli.build_parser().parse_args(train[3:])
    assert t.func is cli.cmd_train and t.synthetic and t.device == "cpu"
    assert (t.out, t.resume) == (cand, os.path.join(ROOT, "root", "models", "spec_unet_2d",
                                                    "model_checkpoint.pth"))
    assert (t.steps, t.batch_size, t.n_inner, t.pool_size, t.seed) == (
        4, 2, 2, 16, recipe["seed"])
    assert t.lr == recipe["lr"]
    if "extras" in recipe:
        assert t.noise_extra == recipe["extras"]
    if name == "ft_hisnr":
        assert (t.noise_extra_policy, t.noise_extra_snr_min, t.noise_extra_silent_prob) == (
            "protected", 10.0, 0.5)
    if name == "ft_boundary":
        assert t.boundary_weight == 2.0
    if name == "ft_snrfloor":
        assert t.snr_min == -12.0
    grid_json, grid = stages["grid"]
    assert grid[1:3] == ["-m", "softspoken_tpu_torch.tools.quality_grid"]
    g = QT.parser().parse_args(grid[3:])
    assert (g.ckpt, g.out, g.quick, g.device) == (cand, grid_json, True, "cpu")
    assert g.no_postfilter_ab == (name in ("ft_boundary", "ft_snrfloor"))
    assert (g.workdir is None) == (name == "ft_music")
    if name in REAL_AUDIO:
        real_json, real = stages["real"]
        assert real[1:3] == ["-m", "softspoken_tpu_torch.tools.real_audio_check"]
        r = RA.parser().parse_args(real[3:])
        assert (r.ckpt, r.out, r.quick, r.device) == (cand, real_json, True, "cpu")


def test_the_candidate_grid_fixture_moves_every_gate():
    """The adopting fixture passes each committed baseline's gates and the
    unmodified r05 grid and probe fail at least one (so both verdict cases
    above test a decision)."""
    for adopt in (True, False):
        grid, real = _candidate_grid(adopt), _candidate_real(adopt)
        r03, r04 = _load("QUALITY_r03.json"), _load("QUALITY_r04.json")
        real0 = _load("QUALITY_r03_realaudio.json")
        got = [ft_music.verdict(grid, real, r03, real0, {}, "c")["adopt"],
               ft_synth3.verdict(grid, real, r04, real0, {}, "c")["adopt"],
               ft_hisnr.verdict(copy.deepcopy(grid), real, r04, real0, {}, "c")["adopt"],
               ft_boundary.verdict(grid, r04, {}, "c")["adopt"],
               ft_snrfloor.verdict(grid, r04, {}, "c")["adopt"]]
        assert got == [adopt] * 5


def test_a_tools_kernel_launches_are_read_back_from_its_log(capsys, monkeypatch):
    """``print_launches`` writes the launches since a snapshot on one line;
    ``read_launches`` takes the last such line of a log (how a caller reads
    a stage subprocess's K1 launches)."""
    from softspoken_tpu_torch import ops, tools

    monkeypatch.setattr(ops, "KERNEL_LAUNCHES", ops.KERNEL_LAUNCHES.copy())
    monkeypatch.setattr(tools, "KERNEL_LAUNCHES", ops.KERNEL_LAUNCHES)
    before = dict(ops.KERNEL_LAUNCHES)
    ops.KERNEL_LAUNCHES["frame_mel"] += 3
    assert tools.print_launches(before) == {"frame_mel": 3}
    log = "noise\n" + capsys.readouterr().out + "more\n"
    assert tools.read_launches(log) == {"frame_mel": 3}
    assert tools.read_launches("kernel launches: {}\n" + log) == {"frame_mel": 3}
    with pytest.raises(ValueError, match="no 'kernel launches:' line"):
        tools.read_launches("nothing here\n")
