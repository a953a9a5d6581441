"""The maintainers' tools on the port: the checkpoint quality grid and its
A/B verdict, the codec and music-filter gates, and the profiling scripts.

Each module is the counterpart of the script of the same name under the
repository's ``scripts/`` (same flags, JSON keys and cache layout) and runs
as ``python -m softspoken_tpu_torch.tools.<name>``: on the CUDA card unless
``--device cpu`` is given (the codec gate's ``--cpu`` too).  None writes
into a file that already exists under the repository's ``docs/``.
"""

from __future__ import annotations

import argparse
import os

from ..config import PathsConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DOCS = os.path.join(REPO_ROOT, "docs")
# the trained weights the JAX scripts default to, as the port reads them
DEFAULT_CKPT = os.path.join(PathsConfig().model_dir, PathsConfig().model_name)
# where the tools write by default: under the checkout's ignored build tree
OUT_DIR = os.path.join(REPO_ROOT, "build", "softspoken_tpu_torch", "tools")


def resolve_out(path: str) -> str:
    """``path`` made absolute against the repository root (as the JAX
    scripts resolve theirs); refuses a file that already exists under
    ``docs/``, the committed evidence."""
    if not os.path.isabs(path):
        path = os.path.join(REPO_ROOT, path)
    path = os.path.abspath(path)
    if os.path.commonpath([path, DOCS]) == DOCS and os.path.exists(path):
        raise SystemExit(f"refusing to write into {path}: it is committed evidence "
                         "under docs/; pass a new --out")
    return path


def repo_relative(path: str) -> str:
    """``path`` relative to the repository root when it lies inside it."""
    path = os.path.abspath(path)
    return (os.path.relpath(path, REPO_ROOT)
            if os.path.commonpath([path, REPO_ROOT]) == REPO_ROOT else path)


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises without "
                         "one); cpu runs on the host")
