"""The maintainers' tools on the port: the checkpoint quality grid and its
A/B verdict, the codec and music-filter gates, the profiling scripts, the
real-audio probe, the fine-tune experiment drivers, and the round-5
retrain supervisor with its adoption gate and its two probes.

Each module is the counterpart of the script of the same name under the
repository's ``scripts/`` (same flags, JSON keys and cache layout) and runs
as ``python -m softspoken_tpu_torch.tools.<name>``: on the CUDA card unless
``--device cpu`` is given (the codec gate's ``--cpu`` too).  None writes
into a file that already exists under the repository's ``docs/``.  The
fine-tune drivers (``ft_*``, on ``ftlib``) and the round-5 tools run the
trainer and the others as subprocesses; ``quality_grid``,
``real_audio_check`` and the two probes print their kernel launches on
one line at exit (``print_launches``) for such a caller to read back
(``read_launches``).
"""

from __future__ import annotations

import argparse
import json
import os

from ..config import PathsConfig
from ..ops import KERNEL_LAUNCHES, _build

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DOCS = os.path.join(REPO_ROOT, "docs")
# the trained weights the JAX scripts default to, as the port reads them
DEFAULT_CKPT = os.path.join(PathsConfig().model_dir, PathsConfig().model_name)
# where the tools write by default: beside the built libraries, in the
# checkout's ignored build tree (a user cache for an installed package)
OUT_DIR = os.path.join(_build.BUILD_DIR, "tools")


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


LAUNCHES_TAG = "kernel launches:"


def print_launches(before: dict) -> dict:
    """Prints, on one line of the log, the hand kernels' launches
    (``ops.KERNEL_LAUNCHES``) made since the snapshot ``before``, so that a
    caller that ran the tool as a subprocess can read them
    (``read_launches``); returns them."""
    got = {k: n - before.get(k, 0) for k, n in sorted(KERNEL_LAUNCHES.items())
           if n - before.get(k, 0)}
    print(f"{LAUNCHES_TAG} {json.dumps(got)}", flush=True)
    return got


def read_launches(log_text: str) -> dict:
    """The launches of the last ``print_launches`` line in a tool's log;
    raises when the log has none."""
    lines = [ln for ln in log_text.splitlines() if ln.startswith(LAUNCHES_TAG)]
    if not lines:
        raise ValueError(f"no '{LAUNCHES_TAG}' line in the log")
    return json.loads(lines[-1][len(LAUNCHES_TAG):])
