"""The port as an installed package: a wheel built offline from a copy of
the checkout carries the kernels' and host libraries' sources, installs the
``softspoken-torch`` console script, and builds its libraries into a user
cache rather than beside the installed package.  A kernel that cannot be
built still raises."""

import json
import os
import shutil
import subprocess
import sys
import zipfile

import pytest

from softspoken_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ["frame_mel.cu", "dft_mel.cu", "adpcm_decode.cu", "mel_core.cuh",
           "ssdsp.cpp", "ssflac.cpp"]


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(install dir, HOME) of a wheel of the port, built from a copy of the
    needed files and installed with ``--target``."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    src.mkdir()
    for f in ("pyproject.toml", "MANIFEST.in", "README.md"):
        shutil.copy(os.path.join(ROOT, f), src / f)
    shutil.copytree(os.path.join(ROOT, "softspoken_tpu_torch"), src / "softspoken_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "--no-input"]
    r = subprocess.run([*pip, "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                        "-w", str(tmp / "dist"), str(src)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    (wheel,) = (tmp / "dist").glob("*.whl")
    target = tmp / "site"
    r = subprocess.run([*pip, "install", "--no-deps", "--no-index", "--target", str(target),
                        str(wheel)], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    home = tmp / "home"
    home.mkdir()
    return target, home, wheel


def _run(installed, code):
    target, home, _wheel = installed
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", _build.BUILD_ENV, "SOFTSPOKEN_DISABLE_NATIVE")}
    env.update(PYTHONPATH=str(target), HOME=str(home))
    # from the install's parent, so that the checkout is not on the path
    return subprocess.run([sys.executable, "-s", "-c", code], cwd=str(target.parent), env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_wheel_carries_the_sources_and_the_console_script(installed):
    _target, _home, wheel = installed
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        entry = next(n for n in names if n.endswith("entry_points.txt"))
        scripts = z.read(entry).decode()
    assert {f"softspoken_tpu_torch/csrc/{f}" for f in SOURCES} <= names
    assert "softspoken-torch = softspoken_tpu_torch.cli:main" in scripts


def test_the_installed_port_builds_into_the_user_cache(installed):
    """The installed ``CSRC`` holds every source; with the install
    read-only, ``BUILD_DIR`` is the user cache under HOME; a host library builds and loads
    there (when g++ is present); the CUDA kernel's build raises here,
    where nvcc is absent, rather than falling back."""
    target, home, _wheel = installed
    code = (
        "import os, json\n"
        "from softspoken_tpu_torch.ops import _build\n"
        "from softspoken_tpu_torch.io import native\n"
        "out = {'csrc': _build.CSRC, 'files': sorted(os.listdir(_build.CSRC)),\n"
        "       'build_dir': _build.BUILD_DIR, 'lib': _build.lib_path('frame_mel')}\n"
        "lib = native.load_host_lib('ssdsp')\n"
        "out['ssdsp'] = None if lib is None else lib._name\n"
        "try:\n"
        "    _build.build('frame_mel')\n"
        "    out['kernel'] = 'built'\n"
        "except RuntimeError as e:\n"
        "    out['kernel'] = str(e)\n"
        "print(json.dumps(out))\n")
    modes = {p: os.stat(p).st_mode for p in [target, *target.rglob("*")]}
    for p in modes:  # the install read-only, as site-packages often is
        os.chmod(p, modes[p] & ~0o222)
    try:
        r = _run(installed, code)
    finally:
        for p, mode in modes.items():
            os.chmod(p, mode)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["csrc"] == str(target / "softspoken_tpu_torch" / "csrc")
    assert set(SOURCES) <= set(out["files"])
    cache = str(home / ".cache" / "softspoken_tpu_torch")
    assert out["build_dir"] == cache
    assert os.path.dirname(out["lib"]) == cache
    if shutil.which("g++"):
        assert out["ssdsp"] is not None and os.path.dirname(out["ssdsp"]) == cache
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert out["kernel"].startswith("nvcc not found")
    assert not (target / "build").exists()


def test_the_console_script_runs_from_the_install(installed):
    target, home, _wheel = installed
    script = target / "bin" / "softspoken-torch"
    assert script.exists()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(target), HOME=str(home))
    r = subprocess.run([sys.executable, "-s", str(script), "--help"], cwd=str(target.parent),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "softspoken_tpu_torch" in r.stdout and "detect" in r.stdout


def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    """A checkout whose build tree cannot be written, and a package outside
    any checkout, build into ``~/.cache/softspoken_tpu_torch``; the
    environment override comes first; this checkout builds into its own
    ``build/``."""
    monkeypatch.delenv(_build.BUILD_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    cache = str(tmp_path / "home" / ".cache" / "softspoken_tpu_torch")
    checkout = tmp_path / "checkout"
    (checkout / "softspoken_tpu_torch").mkdir(parents=True)
    (checkout / "pyproject.toml").write_text("")
    pkg = str(checkout / "softspoken_tpu_torch")
    assert _build.build_dir(pkg) == str(checkout / "build" / "softspoken_tpu_torch")
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    assert _build.build_dir(pkg) == cache
    monkeypatch.undo()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv(_build.BUILD_ENV, raising=False)
    assert _build.build_dir(str(tmp_path / "site" / "softspoken_tpu_torch")) == cache
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "elsewhere"))
    assert _build.build_dir(pkg) == str(tmp_path / "elsewhere")
    monkeypatch.delenv(_build.BUILD_ENV)
    assert _build.build_dir() == os.path.join(ROOT, "build", "softspoken_tpu_torch")
