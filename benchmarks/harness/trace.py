"""Reading a ``torch.profiler`` Chrome trace.

The traced slice of a run is exported as a Chrome trace (JSON, times in
microseconds).  Device work is every event of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; the slice is the span the harness opened
around it (``SLICE_SPAN``).  The readers under ``metrics/`` take a
``Trace`` and compute from it; nothing here knows a metric's name.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SLICE_SPAN = "bench.traced_slice"


@dataclass
class Event:
    name: str
    cat: str
    ts: float       # microseconds
    dur: float      # microseconds
    tid: object

    @property
    def end(self) -> float:
        return self.ts + self.dur


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """The events of one traced slice."""

    def __init__(self, events: List[Event]):
        spans = [e for e in events if e.name == SLICE_SPAN]
        if spans:
            s = max(spans, key=lambda e: e.dur)
            self.t0, self.t1, self.slice_tid = s.ts, s.end, s.tid
        else:
            ts = [e.ts for e in events] or [0.0]
            self.t0, self.t1 = min(ts), max(e.end for e in events) if events else 0.0
            self.slice_tid = None
        inside = [e for e in events if e.end > self.t0 and e.ts < self.t1]
        self.device = [e for e in inside if e.cat in DEVICE_CATS]
        self.host = [e for e in inside if e.cat in HOST_CATS]
        self.runtime = [e for e in inside if e.cat in RUNTIME_CATS]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        items = raw["traceEvents"] if isinstance(raw, dict) else raw
        events = []
        for ev in items:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            events.append(Event(str(ev.get("name", "")), str(ev.get("cat", "")),
                                float(ev["ts"]), float(ev["dur"]), ev.get("tid")))
        return cls(events)

    # ------------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of device intervals, clipped to the slice (microseconds)."""
        return _union([(max(e.ts, self.t0), min(e.end, self.t1)) for e in self.device])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self, contains: str) -> List[Event]:
        """Device kernels whose name holds ``contains``."""
        return [e for e in self.device if e.cat == "kernel" and contains in e.name]

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [[name, seconds], ...]."""
        tot: Dict[str, float] = defaultdict(float)
        for e in self.device:
            tot[e.name] += e.dur
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-6] for k, v in ranked]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        busy = self.busy_intervals()
        gaps, at = [], self.t0
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.t1:
            gaps.append((at, self.t1))
        return gaps

    def launch_tid(self):
        """The host thread that launches most kernels: the one whose idle
        time holds the card back."""
        counts: Dict[object, int] = defaultdict(int)
        for e in self.runtime:
            if "Launch" in e.name:
                counts[e.tid] += 1
        if not counts:
            return self.slice_tid
        return max(counts.items(), key=lambda kv: kv[1])[0]

    def _host_names(self, times: List[float]) -> List[str]:
        """What the launching thread was doing at each of ``times``: the
        innermost host event open there, else "before <the next event>"
        (the host between two operations, in Python or the runtime).  A
        sweep over the events sorted by start."""
        tid = self.launch_tid()
        evs = [e for e in self.host if e.tid == tid and e.name != SLICE_SPAN]
        if not evs:
            # the profiler records operators only on the thread that started
            # it; on another launching thread the runtime calls are what
            # there is
            evs = [e for e in self.runtime if e.tid == tid]
        evs.sort(key=lambda e: (e.ts, -e.dur))
        order = sorted(range(len(times)), key=lambda k: times[k])
        names = ["(no host op)"] * len(times)
        stack: List[Event] = []
        i = 0
        for k in order:
            t = times[k]
            while i < len(evs) and evs[i].ts <= t:
                while stack and stack[-1].end <= evs[i].ts:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            if stack:
                names[k] = stack[-1].name
            elif i < len(evs):
                names[k] = "before " + evs[i].name
        return names

    def idle_by_host(self, top: int = 10) -> List[List]:
        """Idle time summed by the host operation open over each gap's
        middle: [[name, seconds], ...], longest first."""
        gaps = self.idle_gaps()
        names = self._host_names([0.5 * (s + e) for s, e in gaps])
        tot: Dict[str, float] = defaultdict(float)
        for (s, e), name in zip(gaps, names):
            tot[name] += e - s
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-6] for k, v in ranked]

