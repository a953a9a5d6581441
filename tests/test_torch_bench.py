"""The port's bench (softspoken_tpu_torch/bench.py) and its CLI commands on
the CPU: the JSON line holds every key of the JAX package's bench line (read
from the root bench.py, not typed in here) plus ``device``; ``bench
--seconds`` and ``BENCH_SECONDS`` follow the JAX CLI's precedence; the
``bench`` and ``gui`` parsers take the JAX options plus ``--device``."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from softspoken_tpu_torch import bench, cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_payload_keys(path: str) -> "tuple[set, set]":
    """A bench script's JSON keys, read from its source (not imported):
    those of the dicts given to ``payload.update`` (every run prints them)
    and those assigned as ``payload[...]`` (printed when their phase runs).
    The card's bench test (tests/test_torch_cuda.py) reads them here too, so
    this module imports the JAX package only inside the tests that use it."""
    always, assigned = set(), set()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and getattr(node.func.value, "id", "") == "payload"):
            always |= {k.value for k in node.args[0].keys}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(t.value, "id", "") == "payload":
                    assigned.add(t.slice.value)
    return always, assigned


JAX_ALWAYS, JAX_ASSIGNED = bench_payload_keys(os.path.join(ROOT, "bench.py"))


def test_the_jax_keys_were_read():
    assert {"metric", "value", "mfu", "device_only", "wire_codec",
            "link_utilization"} <= JAX_ALWAYS
    assert JAX_ASSIGNED == {"link_wait", "truncated", "multifile_rate",
                            "multifile_k", "multifile_stats"}


def test_the_port_writes_the_same_conditional_keys():
    always, assigned = bench_payload_keys(bench.__file__)
    assert always == JAX_ALWAYS | {"device"}
    assert assigned == JAX_ASSIGNED


def test_bench_line_on_the_cpu_has_every_jax_key(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path),
               BENCH_SECONDS="10", BENCH_REPEATS="1",
               BENCH_DEVICE_BATCH="5", BENCH_CHUNK_SECONDS="3",
               BENCH_DEV_BATCH="5", BENCH_DEV_CHUNK_SECONDS="3",
               BENCH_TIME_BUDGET="0",  # spent: no extra repeats, no multi-file phase
               BENCH_TRACE=str(tmp_path / "trace"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", "bench",
                        "--device", "cpu"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    line = json.loads(lines[0])
    assert JAX_ALWAYS <= set(line)
    assert set(line) - JAX_ALWAYS - JAX_ASSIGNED == {"device"}
    assert not set(line) & {"multifile_rate", "multifile_k", "multifile_stats", "truncated"}
    assert line["device"] == "cpu" and line["wire_codec"] == "i16"
    assert line["metric"] == "audio_sec_per_wall_sec_per_chip"
    assert line["value"] > 0 and line["device_only"] > 0 and line["repeats"] == 1
    assert line["vs_baseline"] == round(line["value"] / 100.0, 3)
    # no card, no peak: MFU is not a CPU number
    assert line["mfu"] is None and line["mfu_median"] is None
    assert line["mfu_median_healthy"] is None and line["device_only_mfu"] is None
    assert line["gflop_per_window"] == 6.965
    assert line["wire_sr"] == 32000
    # the traced repeat's Chrome trace names the annotated span
    (trace,) = list((tmp_path / "trace").glob("*.json"))
    assert "bench.detect_file_streaming" in trace.read_text()


def test_bench_seconds_precedence(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda device=None: seen.append(
        (os.environ["BENCH_SECONDS"], device)))
    monkeypatch.delenv("BENCH_SECONDS", raising=False)
    cli.main(["bench", "--device", "cpu"])
    assert seen[-1] == ("1800", "cpu")
    monkeypatch.setenv("BENCH_SECONDS", "77")
    cli.main(["bench"])
    assert seen[-1] == ("77", None)  # no flag: the ambient variable applies
    cli.main(["bench", "--seconds", "12"])
    assert seen[-1] == ("12.0", None)  # an explicit flag wins over it


def test_bench_needs_the_card_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


def _sub(parser):
    return next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")


@pytest.mark.parametrize("command", ["bench", "gui"])
def test_parsers_take_the_jax_options_and_device(command):
    from softspoken_tpu import cli as jcli

    ours = {s for a in _sub(cli.build_parser()).choices[command]._actions
            for s in a.option_strings}
    theirs = {s for a in _sub(jcli.build_parser()).choices[command]._actions
              for s in a.option_strings}
    assert ours - theirs == {"--device"} and theirs <= ours


def test_the_port_has_every_jax_command_but_convert_ckpt():
    from softspoken_tpu import cli as jcli

    ours, theirs = set(_sub(cli.build_parser()).choices), set(_sub(jcli.build_parser()).choices)
    assert theirs - ours == {"convert-ckpt"} and ours <= theirs
