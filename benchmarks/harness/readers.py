"""What the metric readers share: each ``metrics/<name>.py`` reads one
number from a run's records with one of these.

``records["window"]`` is the untraced part of the window (a traced run's
host metrics come from it), ``records["slice"]`` the traced slice's host
record and ``records["trace"]`` its ``harness.trace.Trace``.  A reader
that finds nothing to read returns None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import registry


def _window(records) -> Optional[dict]:
    w = records.get("window")
    return w if w and w.get("wall_s", 0) > 0 else None


def audio_rate(records) -> Optional[float]:
    """Audio seconds of the files done over the window's wall time."""
    w = _window(records)
    return sum(f[3] for f in w["files"]) / w["wall_s"] if w and w.get("files") else None


def file_rate(records) -> Optional[float]:
    """Files done over the window's wall time."""
    w = _window(records)
    return len(w["files"]) / w["wall_s"] if w and w.get("files") else None


def file_p95_ms(records) -> Optional[float]:
    """95th percentile of ``file_started`` -> ``file_done`` over every file
    of the window, in ms (numpy's linear interpolation)."""
    w = _window(records)
    if not w or not w.get("files"):
        return None
    return float(np.percentile([1e3 * (f[2] - f[1]) for f in w["files"]], 95))


def stage_pct(records, stage: str) -> Optional[float]:
    """A ``StageTimers`` stage's total over the window's wall time, in %."""
    w = _window(records)
    if not w or stage not in w.get("timers", {}):
        return None
    return 100.0 * w["timers"][stage] / w["wall_s"]


def persist_ms_per_file(records) -> Optional[float]:
    w = _window(records)
    if not w or not w.get("files") or "persist" not in w.get("timers", {}):
        return None
    return 1e3 * w["timers"]["persist"] / len(w["files"])


def mfu_detect(records) -> Optional[float]:
    """Frozen forward work of the windows done over the wall time and the
    configuration's stated peak, in %."""
    w = _window(records)
    if not w or not w.get("files"):
        return None
    counts = registry.load_module("counts", "specunet2d")
    work = w["windows"] * counts.detect_flops_per_window()
    return 100.0 * work / (w["wall_s"] * float(records["config"]["peak_flops"]))


def k1_roofline_pct(records) -> Optional[float]:
    """K1's least time (``counts/k1.py``) over its device time, both summed
    over the launches the trace names, in %."""
    trace = records.get("trace")
    if trace is None:
        return None
    k1 = registry.load_module("counts", "k1")
    launches = [e for e in trace.kernels(k1.KERNEL_NAME_PARTS[0])
                if all(p in e.name for p in k1.KERNEL_NAME_PARTS)]
    busy = sum(e.dur for e in launches) * 1e-6
    if not launches or busy <= 0:
        return None
    batch = int(records["slice"]["device_batch"])
    return 100.0 * len(launches) * k1.least_seconds(batch) / busy


def idle_pct(records) -> Optional[float]:
    """Share of the traced slice in which no kernel, copy or memset ran on
    the card, in %."""
    trace = records.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
