"""Sliding-window job planning — the reference formulas.

NNDetector.plan_detection_job (NNDetector.py:55-82):
  padded length L = round(duration·22050) + 2·3·22050
  window          = 66150 samples, step = floor(22050·0.6) = 13230
  num_windows     = ceil((L − 66150) / 13230)
  start_indexes   = arange(num_windows) · 13230
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np

from ..config import Config, DEFAULT_CONFIG
from ..io import get_audio_data


def num_windows_for_padded_length(padded_samples: int, cfg: Config = DEFAULT_CONFIG) -> int:
    return int(
        math.ceil((padded_samples - cfg.samples_per_window) / cfg.samples_per_step)
    )


def num_windows_for_duration(duration_seconds: float, cfg: Config = DEFAULT_CONFIG) -> int:
    padded = round(duration_seconds * cfg.dsp.sample_rate) + 2 * cfg.pad_samples
    return num_windows_for_padded_length(padded, cfg)


def window_starts(n: int, cfg: Config = DEFAULT_CONFIG) -> np.ndarray:
    return np.arange(n, dtype=np.int64) * cfg.samples_per_step


def plan_detection_job(
    files: Iterable[str], cfg: Config = DEFAULT_CONFIG
) -> Dict[str, np.ndarray]:
    """{file → window start indexes} from header probes only."""
    plan: Dict[str, np.ndarray] = {}
    for f in files:
        duration, _sr = get_audio_data(f)
        plan[f] = window_starts(num_windows_for_duration(duration, cfg), cfg)
    return plan
