"""Build and load the package's native code: the CUDA kernels (nvcc) and
the host C++ libraries (g++), each a shared library loaded with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -o build/softspoken_tpu_torch/<name>-<hash>.so

into ``BUILD_DIR`` (``build_dir``: the checkout's ``build/``, listed in
.gitignore, or a user cache for an installed package), with
``-I csrc`` so that the sources can share headers.  The hash covers the
source, every header in ``csrc/`` (any of them may be included) and the
flags, so an edited source or header rebuilds and a stale library is never
loaded.

The host libraries ``csrc/ssdsp.cpp`` (resample, downmix) and
``csrc/ssflac.cpp`` (the FLAC decoder) are built with

    g++ -O3 -march=native -shared -fPIC -std=c++17 -o <lib> <src> -lpthread

into the same directory, under a name that carries a hash of the source
and the flags and a tag of the host's instruction set (``-march=native``
code must not load on another CPU).  Nothing here runs at import: the CPU
tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ENV = "SOFTSPOKEN_TORCH_BUILD_DIR"


def build_dir(pkg: str = _PKG) -> str:
    """Where the libraries go: ``$SOFTSPOKEN_TORCH_BUILD_DIR`` if set; else
    the checkout's ``build/softspoken_tpu_torch/`` when ``pkg`` lies in a
    checkout (its parent holds ``pyproject.toml``) whose build tree can be
    written; else ``~/.cache/softspoken_tpu_torch/``, so that an installed
    package never writes beside itself in site-packages.  Nothing is
    created here."""
    env = os.environ.get(BUILD_ENV)
    if env:
        return env
    root = os.path.dirname(pkg)
    local = os.path.join(root, "build", "softspoken_tpu_torch")
    if os.path.isfile(os.path.join(root, "pyproject.toml")):
        probe = local
        while not os.path.exists(probe) and probe != root:
            probe = os.path.dirname(probe)
        if os.access(probe, os.W_OK | os.X_OK):
            return local
    return os.path.join(os.path.expanduser("~"), ".cache", "softspoken_tpu_torch")


BUILD_DIR = build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc's output (ptxas register report)


def nvcc_path() -> str:
    """The nvcc to use; raises if the toolkit is absent."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of softspoken_tpu_torch "
                       "are built from csrc/ on first use and need the CUDA toolkit")


def lib_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries a
    hash of the source, of every header in ``csrc/`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(b"\0" + fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless already built; returns the library
    path.  Raises on a failed build."""
    src = os.path.join(CSRC, name + ".cu")
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        build_logs[name] = r.stdout
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stdout}")
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib


def host_isa_tag() -> str:
    """Short digest of the host CPU's instruction-set flags (``/proc/cpuinfo``,
    else the machine name): part of a ``-march=native`` library's name."""
    blob = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    blob = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha256(blob.encode()).hexdigest()[:8]


def host_lib_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cpp`` is built: the name carries a
    hash of the source and the flags, and the host's ISA tag."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cpp"), "rb") as f:
        h.update(b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}-{host_isa_tag()}.so")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cpp`` with g++ unless already built; returns the
    library path.  Raises ``RuntimeError`` when g++ is missing or fails."""
    out = host_lib_path(name)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: cannot build csrc/{name}.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp,
                            os.path.join(CSRC, name + ".cpp"), "-lpthread"],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=300)
        build_logs[name] = r.stdout
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cpp:\n{r.stdout}")
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
