#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` and the cell's files (``harness/registry.py``),
sets up through the configuration's driver (``drivers/<driver>.py``),
times a window of ``--seconds``, checks what the window produced against
the plain reference, and prints one JSON line as the last line of standard
output.  ``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
times the window without the profiler up to the cell's ``trace_seconds``
slice, profiles that slice, and reports the per-layer metrics.  Every
metric is read by ``metrics/<name>.py``.

Exits 2 without enough CUDA cards and 3 when a module of ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded at the end; neither
prints a result.  Build caches live in the checkout's ``build/``.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "softspoken_tpu")


class NoDevice(RuntimeError):
    pass


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: from
    /proc; elsewhere this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``softspoken_tpu_torch`` is not ``softspoken_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(REPO_DIR, "build")
    os.environ["SOFTSPOKEN_TORCH_BUILD_DIR"] = os.path.join(build, "softspoken_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["USE_FLAX"] = "0"


@dataclass
class Context:
    seed: int
    device: object
    work: str

    @staticmethod
    def log(msg: str) -> None:
        print(f"benchmark: {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=60, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def read_metrics(metrics: List[dict], records: dict, root: Optional[str]) -> Dict[str, dict]:
    from benchmarks.harness import registry

    out = {}
    for m in metrics:
        value = registry.load_module("metrics", m["name"], root).read(records)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_passes(c: dict) -> bool:
    v, lim = c["value"], c["limit"]
    return v <= lim if c["op"] == "<=" else v >= lim


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: Optional[str] = None, root: Optional[str] = None,
             t_start: Optional[float] = None, driver_hook=None):
    """One run of cell ``name``; returns (result dict, checks).  ``device``
    other than None skips the look for cards (the CPU tests);
    ``driver_hook(driver)`` is called by the driver's set-up before the
    steps the check follows (the control and the faults)."""
    import torch

    from benchmarks.harness import registry
    from benchmarks.harness.trace import SLICE_SPAN, Trace

    t_start = process_start() if t_start is None else t_start
    cell = registry.find_cell(name, root)
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"cell {name} needs {chips} CUDA card(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    work = tempfile.mkdtemp(prefix="softspoken-bench-")
    try:
        ctx = Context(seed=seed, device=dev, work=work)
        driver = registry.load_module("drivers", cell.config["driver"], root).Driver(cell, ctx)
        driver.setup(driver_hook)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        records = {"config": cell.config, "settings": cell.settings,
                   "setup_s": time.perf_counter() - t_start}
        timed = []
        if not trace:
            records["window"] = driver.window(seconds)
            timed.append(records["window"])
        else:
            slice_s = float(cell.settings["trace_seconds"])
            records["window"] = driver.window(max(1.0, seconds - slice_s))
            timed.append(records["window"])
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                with record_function(SLICE_SPAN):
                    records["slice"] = driver.window(slice_s, spans=True)
                    ctx.sync()
            timed.append(records["slice"])
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            records["trace"] = Trace.load(path)
        ctx.sync()
        peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, records, root)
        device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                       "count": chips, "memory_peak_bytes": peak}
        if dev.type == "cuda":
            device_info["power"] = power_limit()
        result = {"metrics": metrics, "device": device_info}
        if trace:
            tr = records["trace"]
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.device_ops(10),
                                   "idle_gaps": tr.idle_by_host(10)}
        attempted = sum(w["attempted"] for w in timed)
        failed = sum(len(w["errors"]) + w["attempted"] - w["done"] for w in timed)
        driver.release()
        t_check = time.perf_counter()
        checks = driver.check(timed)
        ctx.log(f"set-up {records['setup_s']:.1f} s, window and trace "
                f"{t_check - t_start - records['setup_s']:.1f} s, check "
                f"{time.perf_counter() - t_check:.1f} s")
        result = {"correct": failed == 0 and all(check_passes(c) for c in checks),
                  "attempted": attempted, "failed": failed, **result,
                  # a number that is not finite failed its check; JSON has no
                  # such number, so it is written as null
                  "checks": {c["name"]: {"value": c["value"] if math.isfinite(c["value"])
                                         else None, "limit": c["limit"], "op": c["op"]}
                             for c in checks}}
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    sys.path.insert(0, REPO_DIR)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=t_start)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of {', '.join(bad)} are loaded; no result", file=sys.stderr)
        return 3
    for c in checks:
        ok = "ok" if check_passes(c) else "FAILED"
        print(f"check {c['name']} = {c['value']!r} (limit {c['op']} {c['limit']!r}) {ok}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
