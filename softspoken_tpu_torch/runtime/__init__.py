"""Run orchestration and instrumentation."""

from .metrics import StageTimers, ThroughputMeter
from .workers import DetectRunner, RunCallbacks, RunReport

__all__ = ["DetectRunner", "RunCallbacks", "RunReport", "StageTimers", "ThroughputMeter"]
