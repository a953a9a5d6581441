"""The port's profiling tools (``softspoken_tpu_torch.tools.profile_e2e``,
``sweep_device``, ``profile_chunk``, ``bench_train``), ``compare_grids``
and the music-filter gate's detect A/B on the CPU at a tiny size; each tool
runs as a module and needs the card unless asked for the CPU."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
from softspoken_tpu_torch.tools import bench_train, compare_grids, music_filter_gate
from softspoken_tpu_torch.tools import profile_chunk, profile_e2e, quality_grid, sweep_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("quality_grid", "compare_grids", "codec_gate", "music_filter_gate",
         "profile_e2e", "sweep_device", "profile_chunk", "bench_train")

torch.set_num_threads(2)


def test_every_tool_is_a_module_with_a_main_and_the_isolation_walk_takes_it_in():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_isolation import _modules

    walked = set(_modules())
    for name in TOOLS:
        assert f"softspoken_tpu_torch.tools.{name}" in walked
        path = os.path.join(ROOT, "softspoken_tpu_torch", "tools", f"{name}.py")
        tree = ast.parse(open(path, encoding="utf-8").read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "main" for n in tree.body)
        last = tree.body[-1]
        assert isinstance(last, ast.If) and "__main__" in ast.unparse(last.test), name


def test_compare_grids_runs_as_a_module_and_prints_the_jax_verdict():
    a, b = (os.path.join(ROOT, "docs", f) for f in ("QUALITY_r04.json", "QUALITY_r05.json"))
    ours = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch.tools.compare_grids",
                           a, b], cwd=ROOT, capture_output=True, text=True, timeout=120)
    theirs = subprocess.run([sys.executable, os.path.join("scripts", "compare_grids.py"),
                             a, b], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert ours.returncode == theirs.returncode == 0, ours.stderr
    assert ours.stdout == theirs.stdout
    assert "worst condition:" in ours.stdout


def _grid(f1s):
    return {"conditions": {k: {"parity": {"frame_f1": f, "event_f1": e},
                               "parity_postfilter": {"frame_f1": f, "event_f1": e}}
                           for k, (f, e) in f1s.items()}}


def test_compare_grids_holds_both_operating_points(tmp_path, capsys):
    old = tmp_path / "old.json"
    old.write_text(json.dumps(_grid({"v1_clean": (0.95, 0.80), "v2_fading": (0.72, 0.40)})))
    near = tmp_path / "near.json"
    near.write_text(json.dumps(_grid({"v1_clean": (0.955, 0.82), "v2_fading": (0.72, 0.40)})))
    far = _grid({"v1_clean": (0.95, 0.80), "v2_fading": (0.72, 0.40)})
    far["conditions"]["v2_fading"]["parity_postfilter"]["event_f1"] = 0.45
    far_p = tmp_path / "far.json"
    far_p.write_text(json.dumps(far))
    tol = ["--tol-frame", "0.01", "--tol-event", "0.03"]
    assert compare_grids.main([str(old), str(near), *tol]) == 0
    assert "4/4 (condition, key) pairs inside" in capsys.readouterr().out
    assert compare_grids.main([str(old), str(far_p), *tol]) == 1
    out = capsys.readouterr().out
    assert "v2_fading              parity_postfilter" in out and "OUTSIDE" in out
    assert "largest |Δevent| 0.0500 (v2_fading parity_postfilter)" in out
    rows = compare_grids.hold(_grid({"a": (0.9, 0.8)})["conditions"],
                              {"a": {"parity": {"frame_f1": 0.9, "event_f1": 0.8}}}, 0.01, 0.03)
    assert [r.get("missing") for r in rows] == [None, True] and not rows[1]["ok"]


@pytest.mark.parametrize("mod, argv", [
    (profile_e2e, ["--seconds", "2"]),
    (sweep_device, ["--variants", "base"]),
    (profile_chunk, ["--out", "x.md"]),
    (bench_train, []),
    (music_filter_gate, ["--files", "1", "--seconds", "2"]),
    (quality_grid, ["--quick"]),
])
def test_each_tool_needs_the_card_unless_asked_for_the_cpu(mod, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    if "--out" in argv:
        argv = [*argv[:-1], str(tmp_path / argv[-1])]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_profile_e2e_prints_every_stage(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(profile_e2e.tempfile, "tempdir", None)
    runs = profile_e2e.main(["--seconds", "8", "--repeats", "1", "--batch", "5",
                             "--chunk-seconds", "3", "--codec", "adpcm4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wire kind: adpcm4" in out and "run 0: wall=" in out
    for stage in profile_e2e.STAGES:
        assert f"    {stage}" in out
    assert len(runs) == 1 and runs[0]["rate"] > 0 and runs[0]["stages"]["dispatch"] > 0
    assert os.path.exists(tmp_path / "softspoken_bench" / "bench_8s.wav")


def test_sweep_device_runs_each_variant(monkeypatch, capsys):
    monkeypatch.setitem(sweep_device.VARIANTS, "tiny", dict(device_batch=5, chunk_seconds=3.0))
    monkeypatch.setitem(sweep_device.VARIANTS, "tiny_phase_unroll2", dict(
        device_batch=5, chunk_seconds=3.0, decoder_upsample="phase", scan_unroll=2))
    rows = sweep_device.main(["--variants", "tiny,tiny_phase_unroll2", "--repeats", "1",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["variant"] for r in rows] == ["tiny", "tiny_phase_unroll2"]
    assert all(r["audio_s_per_s"] > 0 and r["mfu"] is None for r in rows)
    assert "tiny_phase_unroll2" in out and "mfu=null" in out


def test_profile_chunk_writes_its_table_on_the_cpu(tmp_path, capsys):
    out_md = tmp_path / "p.md"
    reset_launch_counts()
    got = profile_chunk.main(["--batch", "5", "--chunk-seconds", "3", "--repeats", "1",
                              "--device", "cpu", "--out", str(out_md),
                              "--trace-dir", str(tmp_path / "trace")])
    text = out_md.read_text()
    assert text.startswith("# Fused chunk program — device op profile")
    assert "| device op | ms (all reps) | % | count | source |" in text
    assert "MFU null (CPU)" in text and "| CPU op |" in text
    assert got["device_ms"] is None and got["rows"] and got["rate"] > 0
    assert not KERNEL_LAUNCHES  # the plain versions on the CPU


def test_profile_chunk_table_reads_only_device_events(tmp_path):
    """A small synthetic Chrome trace: kernel, copy and memset durations
    summed per name; host events left out; the hand kernels named."""
    ev = [
        {"ph": "X", "cat": "kernel", "dur": 150.0,
         "name": "void mel_core_kernel<WindowLoader, 0>(Params)"},
        {"ph": "X", "cat": "kernel", "dur": 150.0,
         "name": "void mel_core_kernel<WindowLoader, 0>(Params)"},
        {"ph": "X", "cat": "kernel", "dur": 9.5, "name": "adpcm_decode_kernel"},
        {"ph": "X", "cat": "kernel", "dur": 400.0,
         "name": "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32"},
        {"ph": "X", "cat": "gpu_memcpy", "dur": 40.0, "name": "Memcpy HtoD (Pinned -> Device)"},
        {"ph": "X", "cat": "gpu_memset", "dur": 2.0, "name": "Memset (Device)"},
        {"ph": "X", "cat": "cpu_op", "dur": 5000.0, "name": "aten::conv2d"},
        {"ph": "X", "cat": "cuda_runtime", "dur": 300.0, "name": "cudaLaunchKernel"},
        {"ph": "i", "cat": "kernel", "name": "marker"},
        {"ph": "M", "name": "thread_name", "args": {"name": "stream 7"}},
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    agg, cnt = profile_chunk.aggregate(str(p))
    k1 = "void mel_core_kernel<WindowLoader, 0>(Params)"
    assert agg[k1] == 300.0 and cnt[k1] == 2
    assert sum(agg.values()) == 300.0 + 9.5 + 400.0 + 40.0 + 2.0
    assert "aten::conv2d" not in agg and "cudaLaunchKernel" not in agg and "marker" not in agg
    md = profile_chunk.table(agg, cnt, ["# t", ""])
    rows = [r for r in md.splitlines() if r.startswith("| `")]
    assert rows[0].startswith("| `sm90_xmma") and rows[0].endswith("| cuDNN conv |")
    assert rows[1] == f"| `{k1}` | 0.300 | 39.9% | 2 | K1 frame_mel: csrc/frame_mel.cu |"
    assert any(r.endswith("| K3 adpcm_decode: csrc/adpcm_decode.cu |") for r in rows)
    assert any(r.endswith("| copy |") for r in rows)


def test_bench_train_prints_its_keys(capsys):
    out = bench_train.main(["--outer", "1", "--batch", "2", "--n-inner", "1", "--pool", "4",
                            "--device", "cpu"])
    assert set(out) == {"steps", "batch", "s_per_step", "clips_per_s", "train_mfu",
                        "audio_s_per_s", "loss", "dtype", "pool_gen_s", "device"}
    assert out["steps"] == 1 and out["train_mfu"] is None and out["clips_per_s"] > 0
    assert str(out) in capsys.readouterr().out


def test_music_filter_gate_detect_ab_on_the_cpu(tmp_path, monkeypatch):
    """Part 2 runs both detectors (filter off and on) over the A/B tags the
    conditions hold; the filter only drops regions."""
    from softspoken_tpu_torch import config as tcfg

    class Small(tcfg.Config):
        def with_engine(self, **kw):
            return tcfg.Config.with_engine(self, **{"device_batch": 8, "chunk_seconds": 4.8,
                                                    **kw})

    monkeypatch.setattr(music_filter_gate, "Config", Small)
    monkeypatch.setattr(music_filter_gate, "CONDITIONS", quality_grid.CONDITIONS[:1])
    out = music_filter_gate.main(["--files", "1", "--seconds", "6", "--threshold", "0.3",
                                  "--device", "cpu", "--out", str(tmp_path / "mf.json")])
    assert set(out["detect_ab"]) == {"v1_clean", "v2_clean"}
    for ab in out["detect_ab"].values():
        assert ab["files"] == 1 and 0 <= ab["regions_on"] <= ab["regions_off"]
    assert json.loads((tmp_path / "mf.json").read_text())["detect_ab"] == out["detect_ab"]
