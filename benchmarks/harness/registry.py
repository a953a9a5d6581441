"""Find the benchmark's parts by name.

Everything that belongs to one configuration, traffic mix, cell, driver,
generator or metric is a file of its own under ``benchmarks/``; this module
maps a name from ``BENCHMARK.json`` to that file:

    configs/<config>.json        the configuration as it is run
    traffic/<traffic>.json       a traffic mix: its generator and parameters
    workloads/<cell>.json        what belongs to one cell (trace slice, limits)
    drivers/<driver>.py          the entry a window drives (``Driver``)
    generators/<generator>.py    seeded input generators (``generate``)
    metrics/<metric>.py          one reader per metric (``read``)

No name of a cell, configuration or metric is written here or in ``run.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def bench_path(*parts: str, root: Optional[str] = None) -> str:
    return os.path.join(root or BENCH_DIR, *parts)


def load_json(kind: str, name: str, root: Optional[str] = None) -> dict:
    path = bench_path(kind, f"{name}.json", root=root)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Optional[str] = None) -> ModuleType:
    """``<kind>/<name>.py`` as a module; the name may hold dots."""
    path = bench_path(kind, f"{name}.py", root=root)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    mod_name = f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Optional[str] = None) -> dict:
    """``BENCHMARK.json`` beside ``benchmarks/``."""
    repo = os.path.dirname(root) if root else REPO_DIR
    with open(os.path.join(repo, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    entry: dict          # the BENCHMARK.json entry
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    settings: dict       # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without a list follows the end-to-end metric it moves
    return metric.get("moves", metric["name"]) in reported


def find_cell(name: str, root: Optional[str] = None) -> Cell:
    spec = load_spec(root)
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json (known: {known})")
    entry = entries[0]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, entry=entry,
                config=load_json("configs", entry["config"], root),
                traffic=load_json("traffic", entry["traffic"], root),
                settings=load_json("workloads", name, root),
                end_to_end=e2e, per_layer=per_layer,
                root=root or BENCH_DIR)

