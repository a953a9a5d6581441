"""The port's ``eval`` command and detect's operating-point flags on the
CPU against the JAX package's CLI: the same eval JSON from the same
synthesized set, and the same detections CSV rows with
``--music-filter --exit-threshold --grid-smooth``."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from softspoken_tpu import cli as jcli
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import cli

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")


@pytest.fixture
def parity_config(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"engine": {"precision": "parity", "device_batch": 16,
                                        "chunk_seconds": 15.0}}))
    return str(p)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [
    [],
    ["--generator", "v2", "--degrade", "rolloff4k,mulaw", "--music-filter",
     "--exit-threshold", "0.05", "--grid-smooth", "3", "--break-duration", "0.3"],
], ids=["v1", "v2-flags"])
def test_eval_prints_the_jax_json(tmp_path, parity_config, capsys, extra):
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    common = ["eval", "--eval-files", "2", "--eval-seconds", "10", "--seed", "5", *extra]
    # the port's default checkpoint is the committed .pth of the orbax one
    assert cli.main(["--config", parity_config, *common, "--make-synthetic",
                     str(tmp_path / "port"), "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "synthesized eval set" in cap.err
    got = _last_json(cap.out)
    jcli.main(["--config", parity_config, *common, "--make-synthetic",
               str(tmp_path / "jax"), "--ckpt", CKPT])
    assert got == _last_json(capsys.readouterr().out)
    assert set(got) == {"frame", "event", "files"} and len(got["files"]) == 2
    assert got["frame"]["tp"] > 0


def test_eval_from_labels_with_ckpt(tmp_path, parity_config, capsys):
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    from softspoken_tpu_torch.train import evaluate as E

    labels = E.make_eval_set(str(tmp_path), n_files=1, seconds=8.0, seed=3)
    cli.main(["--config", parity_config, "eval", "--labels", labels, "--ckpt",
              CKPT + ".pth", "--iou", "0.3", "--device", "cpu"])
    got = _last_json(capsys.readouterr().out)
    jcli.main(["--config", parity_config, "eval", "--labels", labels, "--ckpt", CKPT,
               "--iou", "0.3"])
    assert got == _last_json(capsys.readouterr().out)
    with pytest.raises(SystemExit):
        cli.main(["eval", "--device", "cpu"])


def _beat(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal(int(seconds * sr))
    for tk in np.arange(0.0, seconds, 60.0 / 126.0):
        i = int(tk * sr)
        seg = np.arange(min(int(0.09 * sr), len(x) - i))
        x[i:i + len(seg)] += np.sin(2 * np.pi * 55.0 * seg / sr) * np.exp(-seg / (0.03 * sr))
    return x.astype(np.float32)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_detect_operating_point_flags_write_the_jax_rows(tmp_path, capsys):
    sr = 32000
    x = _beat(12.0, sr, 0)  # a beat, then noise
    x[int(6.5 * sr):] = np.random.default_rng(9).uniform(-0.3, 0.3, len(x) - int(6.5 * sr))
    files = [str(tmp_path / "beat.wav")]
    jwavio.write(files[0], x, sr)
    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"engine": {"precision": "parity", "device_batch": 4,
                                           "chunk_seconds": 6.0, "pipeline": "host"}}))
    flags = ["--random-init", "--exit-threshold", "0.05", "--grid-smooth", "3"]
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        for mf in ([], ["--music-filter"], ["--music-filter", "2.5"]):
            csv_path = str(tmp_path / f"{name}{len(mf)}.csv")
            main(["--config", str(conf), "detect", "--files", *files, "--out", csv_path,
                  *flags, *mf, *extra])
            out[name, len(mf)] = _rows(csv_path)
    capsys.readouterr()
    for n in (0, 1, 2):
        assert out["port", n] == out["jax", n], n
    # the filter dropped the beat's regions; a threshold above every score kept them
    assert len(out["port", 1]) < len(out["port", 0]) == len(out["port", 2])
