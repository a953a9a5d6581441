"""The port's CLI options of this slice: the global ``-v``/``--log-json``,
``doctor``, and ``detect``'s ``--chunk-checkpoint``/``--file-concurrency``;
the port's ``detect`` parser has every option of the JAX one."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from softspoken_tpu import cli as jcli
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import cli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCTOR_KEYS = {"native_dsp", "native_flac", "libvorbis", "libmpg123", "libopus",
               "checkpoint", "native_cache_dir", "device", "kernels", "summary"}


def _options(parser, command):
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {s for a in sub.choices[command]._actions for s in a.option_strings}


def test_detect_parser_has_every_option_of_the_jax_one():
    ours, theirs = _options(cli.build_parser(), "detect"), _options(jcli.build_parser(), "detect")
    assert theirs <= ours
    # the port's own: --device, and --config also after the command
    assert ours - theirs == {"--device", "--config"}
    g_ours = {s for a in cli.build_parser()._actions for s in a.option_strings}
    g_theirs = {s for a in jcli.build_parser()._actions for s in a.option_strings}
    assert g_theirs <= g_ours


def _wavs(tmp_path, n=3):
    rng = np.random.default_rng(12)
    out = []
    for i in range(n):
        p = str(tmp_path / f"w{i}.wav")
        jwavio.write(p, rng.uniform(-0.5, 0.5, 16000 * (6 + i)).astype(np.float32),
                     16000, subtype="PCM_16")
        out.append(p)
    return out


def test_detect_with_checkpoints_and_concurrency_writes_the_sequential_csv(tmp_path):
    files = _wavs(tmp_path)
    conf = tmp_path / "c.json"
    conf.write_text('{"engine": {"pipeline": "fused", "chunk_seconds": 6.0}}')
    common = ["--random-init", "--device", "cpu", "--device-batch", "4",
              "--precision", "parity", "--config", str(conf)]
    seq, conc = str(tmp_path / "seq.csv"), str(tmp_path / "conc.csv")
    assert cli.main(["detect", "--files", *files, "--out", seq, *common]) == 0
    assert cli.main(["detect", "--files", *files, "--out", conc, "--chunk-checkpoint", "1",
                     "--file-concurrency", "2", *common]) == 0
    with open(seq, "rb") as a, open(conc, "rb") as b:
        assert a.read() == b.read()
    assert os.listdir(tmp_path / ".chunk_progress") == []


def test_load_config_takes_the_new_flags():
    args = cli.build_parser().parse_args(
        ["detect", "--chunk-checkpoint", "3", "--file-concurrency", "2"])
    cfg = cli._load_config(args)
    assert cfg.engine.chunk_checkpoint_every == 3 and cfg.engine.file_concurrency == 2


@pytest.mark.parametrize("flags", [["--mesh"], ["--distributed"],
                                   ["--coordinator", "localhost:1"],
                                   ["--num-processes", "2"], ["--process-id", "0"]],
                         ids=lambda f: f[0])
def test_each_multi_gpu_flag_alone_writes_the_plain_csv(tmp_path, flags, capsys):
    """Each of the five flags alone now runs, as in the JAX CLI: ``--mesh``
    on a CPU detector shards over a one-entry CPU mesh, ``--distributed``
    with no cluster is a single process (the main store), and the other
    three apply only with ``--distributed``; each CSV equals a plain
    run's.  Both runs of a case use the tiny shape (B = 8, 4.8 s chunks)."""
    rng = np.random.default_rng(2)
    wav = str(tmp_path / "x.wav")
    jwavio.write(wav, rng.uniform(-0.4, 0.4, 5 * 22050).astype(np.float32), 22050,
                 subtype="PCM_16")
    conf = tmp_path / "tiny.json"
    conf.write_text(json.dumps({"engine": {"chunk_seconds": 4.8}}))
    base = ["detect", "--files", wav, "--device", "cpu", "--random-init", "--device-batch", "8",
            "--config", str(conf)]
    assert cli.main([*base, "--out", str(tmp_path / "plain.csv")]) == 0
    assert cli.main([*base, "--out", str(tmp_path / "flag.csv"), *flags]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.rindex("\n{") + 1:])
    assert report["detections_csv"] == str(tmp_path / "flag.csv")
    assert report["files_done"] == 1
    assert (tmp_path / "plain.csv").read_bytes() == (tmp_path / "flag.csv").read_bytes()


def test_verbose_sets_debug_level(tmp_path):
    root = logging.getLogger()
    saved = root.level, root.handlers[:]
    try:
        assert cli.main(["--project-dir", str(tmp_path), "-v", "project", "list"]) == 0
        assert root.level == logging.DEBUG
        assert cli.main(["--project-dir", str(tmp_path), "project", "list"]) == 0
        assert root.level == logging.INFO
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]


def _run(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_log_json_lines_parse(tmp_path):
    """The host pipeline (the CPU's "auto") says it does not journal: that
    log line, and every other on stderr, is one JSON object with ts, level,
    logger and msg."""
    (f,) = _wavs(tmp_path, 1)
    r = _run("-v", "--log-json", "detect", "--files", f, "--out", str(tmp_path / "d.csv"),
             "--random-init", "--device", "cpu", "--device-batch", "4",
             "--chunk-checkpoint", "1", "--streaming", cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    lines = [json.loads(line) for line in r.stderr.splitlines() if line.startswith("{")]
    assert lines and all({"ts", "level", "logger", "msg"} <= set(d) for d in lines)
    assert any(d["level"] == "WARNING" and "fused pipeline" in d["msg"] for d in lines)
    assert not [line for line in r.stderr.splitlines()
                if line.strip() and not line.startswith("{")]


def test_doctor_reports_the_missing_card_as_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds doctor there")
    r = _run("doctor", "--device-timeout", "5", cwd=str(tmp_path))
    assert r.returncode == 1
    report = json.loads(r.stdout)
    assert set(report) == DOCTOR_KEYS
    assert report["device"]["status"] == "ERROR" and "CUDA" in report["device"]["error"]
    assert report["kernels"]["status"] == "ERROR"
    assert report["checkpoint"]["status"] == "ok"
    assert report["summary"].startswith("attention: ") and "device" in report["summary"]
    # the codec keys are the JAX doctor's statuses
    from softspoken_tpu.io import mp3, oggvorbis, opus

    for key, mod, missing in (("libvorbis", oggvorbis, "MISSING (OGG undecodable)"),
                              ("libmpg123", mp3, "MISSING (MP3 undecodable)"),
                              ("libopus", opus, "MISSING (Ogg/Opus undecodable)")):
        assert report[key] == {"status": "ok" if mod.available() else missing}
