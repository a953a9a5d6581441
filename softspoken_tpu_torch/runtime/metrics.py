"""Throughput and stage timing.

The reference's headline number is the Voice Detector screen's "Processing
Speed (audio sec / real sec)" (``silencer_ui.py:152-158, 276-299``); here it
is a counter decoupled from any GUI, beside accumulating stage timers.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class ThroughputMeter:
    """Audio-seconds processed per wall-second."""

    n_chips: int = 1
    audio_seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)

    def reset(self) -> None:
        self.audio_seconds = 0.0
        self._t0 = time.perf_counter()

    def add_audio(self, seconds: float) -> None:
        self.audio_seconds += seconds

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def audio_sec_per_wall_sec(self) -> float:
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        wall = self.wall_seconds  # one clock reading for a consistent record
        rate = self.audio_seconds / wall if wall > 0 else 0.0
        return {
            "audio_seconds": self.audio_seconds,
            "wall_seconds": wall,
            "audio_sec_per_wall_sec": rate,
            "audio_sec_per_wall_sec_per_chip": rate / max(1, self.n_chips),
        }


class StageTimers:
    """Accumulating named wall-clock timers; safe to use from several
    threads (the fused engine's fill and upload threads add to it)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in sorted(self.summary().items())})
