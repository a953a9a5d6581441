"""The port stands alone: it imports neither JAX nor the JAX package, nor
pandas, nor matplotlib outside the one function that draws a PNG (the card's
machine has neither), and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "softspoken_tpu_torch")


def _modules():
    out = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                out.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(out)


FORBIDDEN = ("jax", "softspoken_tpu", "pandas", "matplotlib")


def test_the_walk_takes_in_every_package_of_the_port():
    """The Qt shim's ``PySide6`` stand-in, the bench, the host trainer's
    modules, the codec readers, the real-audio probe, the fine-tune
    drivers and the round-5 tools are walked (and so imported and parsed
    below) like every other module."""
    mods = _modules()
    shim = "softspoken_tpu_torch.ui.qt_shim"
    assert {shim, f"{shim}.PySide6", f"{shim}.PySide6.QtCore", f"{shim}.PySide6.QtGui",
            f"{shim}.PySide6.QtWidgets", "softspoken_tpu_torch.ui.qt_app",
            "softspoken_tpu_torch.bench", "softspoken_tpu_torch.runtime.profiling"} <= set(mods)
    assert {f"softspoken_tpu_torch.{m}" for m in (
        "train.augment", "train.data", "train.fit", "io.mp3", "io.oggvorbis",
        "io.opus", "parallel", "parallel.mesh", "parallel.distributed",
        "parallel.grid")} <= set(mods)
    assert {f"softspoken_tpu_torch.tools.{m}" for m in (
        "real_audio_check", "ftlib", "ft_music", "ft_synth3", "ft_hisnr", "ft_boundary",
        "ft_snrfloor", "train_r05", "retrain_gate_r05", "probe_agc_r05",
        "probe_scratch_channels")} <= set(mods)


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (conftest already imported jax here): no jax,
    no JAX package, no pandas, no matplotlib."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mod", _modules() + ["chip_smoke"])
def test_no_jax_or_reference_imports_in_source(mod):
    path = os.path.join(ROOT, *mod.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *mod.split("."), "__init__.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "pandas"), n
            assert top != "softspoken_tpu", n


def _matplotlib_importers(tree):
    """Names of the functions that import matplotlib (None: module level)."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            f = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module or ""]
            if any(n.split(".")[0] == "matplotlib" for n in names):
                out.append(func)
            visit(child, f)

    visit(tree, None)
    return out


@pytest.mark.parametrize("mod", _modules() + ["chip_smoke"])
def test_matplotlib_only_inside_render_review_png(mod):
    path = os.path.join(ROOT, *mod.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(ROOT, *mod.split("."), "__init__.py")
    found = _matplotlib_importers(ast.parse(open(path, encoding="utf-8").read()))
    if mod == "softspoken_tpu_torch.ui.spectrogram":
        assert found == ["render_review_png", "render_review_png"]
    else:
        assert found == [], found


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(state_dict=fixture_state_dict(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from softspoken_tpu_torch import cli

        cli.main(["detect", "--files", "x.wav", "--random-init"])
