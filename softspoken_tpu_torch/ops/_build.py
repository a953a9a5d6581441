"""Build and load the package's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/softspoken_tpu_torch/<name>-<hash>.so

into the checkout's ``build/`` directory (listed in .gitignore).  The hash
covers the source and the flags, so an edited source rebuilds and a stale
library is never loaded.  Nothing here runs at import: the CPU tests import
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


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless already built; returns the library
    path.  Raises on a failed build."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{name}-{h}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
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
