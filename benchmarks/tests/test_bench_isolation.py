"""What the benchmark may load and read: no JAX, no JAX package, no program
in the reference, no TPU-era bench files; no result without a card."""

import ast
import os
import subprocess
import sys

import pytest

import benchcopy

from benchmarks import run

BENCH = os.path.join(benchcopy.REPO, "benchmarks")


@pytest.mark.parametrize("loaded,found", [
    (["softspoken_tpu_torch", "softspoken_tpu_torch.engine.fused"], []),
    (["softspoken_tpu.io.audio"], ["softspoken_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "softspoken_tpu_tools"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in run.forbidden_modules() if m in found or m in loaded] == found


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _py_files(top):
    for d, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_reference_imports_nothing_of_jax_or_the_program():
    bad = {"jax", "jaxlib", "flax", "softspoken_tpu", "softspoken_tpu_torch"}
    for path in _py_files(os.path.join(BENCH, "reference")):
        assert not set(_imports(path)) & bad, path


def test_no_file_imports_jax_or_reads_the_tpu_bench_records():
    for path in _py_files(BENCH):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "softspoken_tpu", "bench"}, path
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path, encoding="utf-8").read()
        for word in ("BENCH_r0", "MULTICHIP_", "VERDICT.md"):
            assert word not in text, (path, word)


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output (this sandbox has no card; on the card the look passes
    and the test has nothing to show)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        benchcopy.cells("detect_runner")[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA card" in r.stderr
