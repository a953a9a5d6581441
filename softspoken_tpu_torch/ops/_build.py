"""Build and load the package's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -o build/softspoken_tpu_torch/<name>-<hash>.so

into the checkout's ``build/`` directory (listed in .gitignore), with
``-I csrc`` so that the sources can share headers.  The hash covers the
source, every header in ``csrc/`` (any of them may be included) and the
flags, so an edited source or header rebuilds and a stale library is never
loaded.  Nothing here runs at import: the CPU tests import
every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "softspoken_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
