"""The port's CLI through the review-and-silence workflow, on the CPU,
against the JAX package's CLI (tests/test_cli.py's flow): ``project new``
→ ``detect`` → ``review`` → ``silence`` → ``project status``.  Both run parity mode with
the fixture weights on the same files; detections CSVs are equal row for
row (as tests/test_torch_host.py holds the host pipeline), and the review
CSV, the export files and the silenced WAVs byte-identical."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from softspoken_tpu import cli as jcli
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.project import manager as jmanager_mod
from softspoken_tpu.ui import review as jreview_mod
from softspoken_tpu_torch import cli
from softspoken_tpu_torch.project import manager as manager_mod
from softspoken_tpu_torch.ui import review as review_mod


class _Clock:
    class datetime:
        @staticmethod
        def now():
            import datetime

            return datetime.datetime(2026, 8, 16, 12, 0, 0)


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for mod in (review_mod, jreview_mod):
        monkeypatch.setattr(mod, "datetime", _Clock)
    for mod in (manager_mod, jmanager_mod):
        monkeypatch.setattr(mod, "_now_str", lambda: "2026-08-16 11:00:00")
    wavdir = tmp_path / "audio"
    wavdir.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i, sr in enumerate((22050, 32000)):
        p = str(wavdir / f"rec{i}.wav")
        jwavio.write(p, rng.uniform(-0.4, 0.4, sr * 4).astype(np.float32), sr)
        paths.append(p)
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"engine": {"precision": "parity", "device_batch": 4,
                                           "chunk_seconds": 6.0, "pipeline": "host"}}))
    return tmp_path, paths, str(conf)


def _run(main, pdir, conf, *argv, capsys):
    main(["--project-dir", pdir, "--config", conf, *argv])
    return capsys.readouterr().out


def _json_tail(out):
    return json.loads(out[out.index("{"):])


def _tree(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_workflow_matches_the_jax_cli(workspace, capsys):
    ws, paths, conf = workspace
    runs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        pdir = str(ws / name / "projects")
        r = runs[name] = {"pdir": pdir}
        r["new"] = _run(main, pdir, conf, "project", "new", "wf", *paths, capsys=capsys)
        det = ["detect", "--project", "wf", "--random-init", *extra]
        r["detect"] = _json_tail(_run(main, pdir, conf, *det, capsys=capsys))
        r["again"] = _json_tail(_run(main, pdir, conf, *det, capsys=capsys))
        r["list"] = _run(main, pdir, conf, "review", "list", "--project", "wf", capsys=capsys)
        n = json.loads(r["list"].strip().splitlines()[-1])["total"]
        r["erase"] = _run(main, pdir, conf, "review", "erase", "--project", "wf",
                          "--rows", *[str(i) for i in range(n)], capsys=capsys)
        r["add"] = _run(main, pdir, conf, "review", "add", "--project", "wf", "--file",
                        paths[1], "--start", "0.25", "--end", "0.75", capsys=capsys)
        added = r["add"].split()[-1]
        r["keep"] = _run(main, pdir, conf, "review", "keep", "--rows", added, capsys=capsys)
        r["export"] = _run(main, pdir, conf, "review", "export", capsys=capsys)
        r["silence"] = _json_tail(_run(main, pdir, conf, "silence", "--output-dir",
                                       str(ws / name / "out"), capsys=capsys))
        r["status"] = json.loads(_run(main, pdir, conf, "project", "status", "wf",
                                      capsys=capsys))
    port, jax = runs["port"], runs["jax"]
    assert port["detect"]["files_done"] == jax["detect"]["files_done"] == 2
    assert port["detect"]["rows_added"] == jax["detect"]["rows_added"]
    assert port["again"]["rows_added"] == jax["again"]["rows_added"] == 0
    assert port["again"]["files_skipped"] == 2
    for step in ("list", "erase", "add", "keep"):
        assert port[step] == jax[step], step
    assert port["silence"]["files_done"] == jax["silence"]["files_done"] >= 1
    assert port["status"] == jax["status"] == {
        "project": "wf", "detect": "Complete", "review": "Complete", "silence": "Complete"}
    a = _tree(port["pdir"])
    b = _tree(jax["pdir"])
    a.pop("projects.json")
    jreg = b.pop("projects.json")
    assert sorted(a) == sorted(b)
    assert a == b  # detections, review CSV, the three exporters, the status file
    assert _tree(ws / "port" / "out") == _tree(ws / "jax" / "out")
    assert json.loads(open(os.path.join(port["pdir"], "projects.json")).read().replace(
        port["pdir"], "P")) == json.loads(jreg.decode().replace(jax["pdir"], "P"))


@pytest.mark.parametrize("fade", ["0", "20"])
def test_silence_commands_byte_identical_on_one_review_csv(workspace, capsys, fade):
    """A hand-written review.csv given to both CLIs' ``silence``."""
    ws, paths, conf = workspace
    review = ws / "review.csv"
    review.write_text(
        "ID,file_path,file_name,start_time,end_time,erase,user_comment,review_datetime\n"
        f"1,{os.path.dirname(paths[0])},rec0.wav,0.5,1.25,1,,\n"
        f"2,{os.path.dirname(paths[0])},rec0.wav,2.0,2.5,0,,\n"
        f"3,{os.path.dirname(paths[1])},rec1.wav,-3.0,0.75,1.0,,\n"
        f"4,{os.path.dirname(paths[1])},rec1.wav,3.5,9.0,1,x,\n")
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        pdir = str(ws / name / "projects")
        _run(main, pdir, conf, "project", "new", "s", capsys=capsys)
        proj = json.load(open(os.path.join(pdir, "projects.json")))[0]
        shutil.copy(review, proj["review_file"])
        _run(main, pdir, conf, "silence", "--output-dir", str(ws / name / "out"),
             "--fade-ms", fade, "--subtype", "PCM_24", capsys=capsys)
    out = _tree(ws / "port" / "out")
    assert sorted(out) == ["rec0_silenced.wav", "rec1_silenced.wav"]
    assert out == _tree(ws / "jax" / "out")


def test_segment_and_grade_loop(workspace, capsys, monkeypatch):
    ws, paths, conf = workspace
    pdir = str(ws / "projects")
    _run(cli.main, pdir, conf, "project", "new", "g", paths[0], capsys=capsys)
    proj = json.load(open(os.path.join(pdir, "projects.json")))[0]
    with open(proj["detections_file"], "w") as f:
        f.write("ID,file_path,file_name,start_time,end_time,erase,user_comment,"
                f"review_datetime\n1,{os.path.dirname(paths[0])},rec0.wav,0.5,1.0,0,,\n"
                f"2,{os.path.dirname(paths[0])},rec0.wav,2.0,3.0,0,,\n")
    seg = str(ws / "seg.wav")
    out = _run(cli.main, pdir, conf, "review", "segment", "--row", "1", "--out", seg,
               capsys=capsys)
    assert out.strip() == seg and os.path.getsize(seg) > 44
    answers = iter(["e", "k"])
    monkeypatch.setattr("builtins.input", lambda _prompt: next(answers))
    out = _run(cli.main, pdir, conf, "review", "grade", capsys=capsys)
    assert "(end of detections)" in out
    assert json.loads(out.strip().splitlines()[-1]) == {
        "total": 2, "reviewed": 2, "erased": 1, "kept": 1}


def test_merge_detections_is_not_ported(workspace, capsys):
    """`project merge-detections` now runs: with no partition stores it
    merges nothing, prints the JAX merge's JSON, and leaves an empty main
    store; without a project it exits as the JAX CLI does."""
    ws, _paths, conf = workspace
    pdir = str(ws / "merge")
    with pytest.raises(SystemExit, match="no projects exist"):
        cli.main(["--project-dir", pdir, "project", "merge-detections"])
    assert cli.main(["--project-dir", pdir, "project", "new", "M"]) == 0
    capsys.readouterr()
    assert cli.main(["--project-dir", pdir, "project", "merge-detections", "M"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: out[k] for k in ("partitions", "files", "rows")} == {
        "partitions": 0, "files": 0, "rows": 0}
    assert out["store"].endswith("M_detections.csv") and os.path.isfile(out["store"])


def test_detect_without_a_project_exits(workspace):
    ws, _paths, _conf = workspace
    with pytest.raises(SystemExit, match="no projects exist"):
        cli.main(["--project-dir", str(ws / "empty"), "detect", "--random-init",
                  "--device", "cpu"])
