"""A copy of the benchmark at a size the CPU tests can hold.

``tiny_copy(tmp)`` copies ``benchmarks/`` and ``BENCHMARK.json`` into
``tmp`` and shrinks what a CPU run cannot hold: two 8 s recordings per mix,
a device batch of 8 windows and chunks of 4.8 s (three chunks a file, so the
grid's carry between chunks is exercised); pools of 8 + 10 clips, batches of
4 and 2 steps a call, and the training frontend's DFT in float32, as the
program computes it on the CPU.  Every limit stays the cell's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _edit(path: str, fn) -> None:
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def tiny_copy(tmp: str) -> str:
    """The copied ``benchmarks/`` directory (pass it as ``root``)."""
    shutil.copytree(os.path.join(REPO, "benchmarks"), os.path.join(tmp, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    root = os.path.join(tmp, "benchmarks")
    def small_traffic(d):
        if d["generator"] == "field_recordings":
            d["params"].update(files=2, seconds=8.0, bed_tile_seconds=4.0, bed_bank=2)
        elif d["generator"] == "clip_pools":
            d["params"].update(n_speech=8, n_noise=10, workers=1)

    def small_config(d):
        if "engine" in d.get("program", {}):
            d["program"]["engine"].update(device_batch=8, chunk_seconds=4.8)
        if "recipe" in d:
            # on the CPU the program's training frontend is float32
            d["recipe"].update(batch_size=4, n_inner=2, mel_dft="float32")

    for name in os.listdir(os.path.join(root, "traffic")):
        _edit(os.path.join(root, "traffic", name), small_traffic)
    for name in os.listdir(os.path.join(root, "configs")):
        _edit(os.path.join(root, "configs", name), small_config)
    for name in os.listdir(os.path.join(root, "workloads")):
        _edit(os.path.join(root, "workloads", name),
              lambda d: d.update(links=8, trace_seconds=1.5))
    return root


def cells(driver: str) -> list:
    """The cells whose configuration runs ``driver``."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    configs = {}
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            configs[c["name"]] = json.load(f)
    return [w["name"] for w in spec["workloads"] if configs[w["config"]]["driver"] == driver]
