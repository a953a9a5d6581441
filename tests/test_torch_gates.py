"""The port's codec gate and music-filter gate
(``softspoken_tpu_torch.tools.codec_gate`` / ``music_filter_gate``) against
the JAX package's ``scripts/codec_gate.py`` / ``music_filter_gate.py`` on
the CPU, at a tiny size with the same trained weights."""

import json
import os
import sys

import pytest
import torch

import softspoken_tpu
import softspoken_tpu.config as jcfg
from softspoken_tpu.io import native as jnative
from softspoken_tpu_torch import config as tcfg
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
from softspoken_tpu_torch.tools import codec_gate as TCG
from softspoken_tpu_torch.tools import music_filter_gate as TMF
from softspoken_tpu_torch.tools import quality_grid as TQG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import codec_gate as JCG  # noqa: E402
import music_filter_gate as JMF  # noqa: E402

torch.set_num_threads(2)

CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")
SMALL_ENGINE = dict(device_batch=8, chunk_seconds=4.8)


@pytest.fixture
def small_engines(monkeypatch):
    """The same small engine in both packages' ``Config().with_engine``."""

    class TSmall(tcfg.Config):
        def with_engine(self, **kw):
            return tcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    class JSmall(jcfg.Config):
        def with_engine(self, **kw):
            return jcfg.Config.with_engine(self, **{**SMALL_ENGINE, **kw})

    for mod in (TCG, TMF, TQG):
        monkeypatch.setattr(mod, "Config", TSmall)
    monkeypatch.setattr(softspoken_tpu, "Config", JSmall)
    # the JAX package's threaded ss_fir_decim_i16 (>= 65,536 outputs with
    # more than one thread) crashes the process; one thread gives the same
    # samples (ROADMAP §3)
    monkeypatch.setattr(jnative, "_threads", lambda: 1)


def test_the_gates_conditions_are_the_jax_scripts():
    assert TCG.CONDITIONS == JCG.CONDITIONS
    assert TMF.CONDITIONS == JMF.CONDITIONS


def test_codec_gate_adpcm4_of_both_packages(tmp_path, monkeypatch, small_engines):
    """1 condition x 2 generators, 1 file x 6 s, three wires per package
    (a fused detection in bf16 takes ~1-2 s on the CPU, so a second
    condition or 10 s files would double the file's time): the same keys,
    parity F1 of every wire within 0.01 frame / 0.03 event, the same
    identical-interval counts; on the CPU the wrappers count no launch
    (their plain versions)."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    monkeypatch.setattr(TCG, "CONDITIONS", TCG.CONDITIONS[:1])
    monkeypatch.setattr(JCG, "CONDITIONS", JCG.CONDITIONS[:1])
    small = ["--files", "1", "--seconds", "6", "--codec", "adpcm4", "--key", "g"]
    reset_launch_counts()
    ours = TCG.main([*small, "--cpu", "--out", str(tmp_path / "port.json"),
                     "--workdir", str(tmp_path / "wp")])
    assert not KERNEL_LAUNCHES
    monkeypatch.setattr(sys, "argv", ["codec_gate.py", *small, "--cpu", "--ckpt", CKPT,
                                      "--out", str(tmp_path / "jax.json"),
                                      "--workdir", str(tmp_path / "wj")])
    JCG.main()
    with open(tmp_path / "jax.json") as f:
        theirs = json.load(f)["g"]
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == {"g": json.loads(json.dumps(ours))}
    assert set(ours) == set(theirs)
    assert set(ours["conditions"]) == {"v1_clean", "v2_clean"}
    assert ours["total_files"] == theirs["total_files"] == 2
    for tag, row in ours["conditions"].items():
        want = theirs["conditions"][tag]
        assert set(row) == set(want)
        for wire in ("pcm16", "adpcm4", "adpcm4_dec"):
            assert abs(row[wire]["frame_f1"] - want[wire]["frame_f1"]) <= 0.01, (tag, wire)
            assert abs(row[wire]["event_f1"] - want[wire]["event_f1"]) <= 0.03, (tag, wire)
        for k in ("adpcm4_intervals_identical", "adpcm4_dec_intervals_identical"):
            assert row[k] == want[k], (tag, k)
    assert ours["interval_identical_files"] == theirs["interval_identical_files"]
    assert min(row["pcm16"]["frame_f1"] for row in ours["conditions"].values()) > 0.5


def test_codec_gate_appends_under_its_key_and_needs_the_card(tmp_path):
    out = tmp_path / "gates.json"
    out.write_text(json.dumps({"other": {"kept": 1}}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCG.main(["--out", str(out)])
    with pytest.raises(SystemExit, match="epoch<0"):
        TCG.main(["--cpu", "--ckpt", str(tmp_path / "none.pth"), "--out", str(out)])
    assert json.loads(out.read_text()) == {"other": {"kept": 1}}


def test_music_filter_gate_part1_equals_jax(tmp_path, monkeypatch):
    """Part 1 (the truth-region scorer sweep, host numpy) over 2 conditions
    x 2 generators, 1 file x 10 s: equal to the JAX script's, key for key."""
    conds = [TQG.CONDITIONS[0], TQG.CONDITIONS[9]]  # clean, hum
    monkeypatch.setattr(TMF, "CONDITIONS", conds)
    monkeypatch.setattr(JMF, "CONDITIONS", conds)
    small = ["--files", "1", "--seconds", "10", "--threshold", "0.5", "--skip-detect"]
    ours = TMF.main([*small, "--out", str(tmp_path / "port.json"),
                     "--workdir", str(tmp_path / "wp")])
    monkeypatch.setattr(sys, "argv", ["music_filter_gate.py", *small,
                                      "--out", str(tmp_path / "jax.json"),
                                      "--workdir", str(tmp_path / "wj")])
    JMF.main()
    with open(tmp_path / "jax.json") as f:
        theirs = json.load(f)
    ours = json.loads(json.dumps(ours))
    del ours["wall_seconds"], theirs["wall_seconds"]
    assert ours == theirs
    assert set(ours["truth_region_sweep"]) == {"v1_clean", "v1_hum", "v2_clean", "v2_hum"}
    assert ours["detect_ab"] == {}
