"""Score grid → speech intervals (numpy).

Numerics contract (NNDetector.py:103-190):
  * global grid of dt = 3/256 s bins; window i adds its 256 raw logits at
    bin round(i·0.6/(3/256)); the grid is averaged by coverage count
  * bin time = idx·(3/256), formatted "%.4f" and parsed back with float()
    (the reference passes times around as strings, NNDetector.py:185-187)
  * a value > threshold opens/extends a region; a region ends at its last
    above-threshold bin (NNDetector.py:117-127)
  * regions merge while the gap ≤ break_duration (NNDetector.py:129-138)
  * the −pad_seconds shift is applied by the caller (worker.py:100)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

TIME_RESOLUTION = 3.0 / 256.0  # exact in binary


def bin_time(idx: int) -> float:
    """Reference bin→time mapping incl. its 4-decimal string round-trip."""
    return float(f"{idx * TIME_RESOLUTION:.4f}")


def window_bin_offset(window_index, step_seconds: float = 0.6) -> np.ndarray:
    """Grid bin where window i's 256 scores start: round(i·step/dt),
    half-to-even like python round() (NNDetector.py:175)."""
    return np.rint(np.asarray(window_index, np.float64) * step_seconds / TIME_RESOLUTION).astype(
        np.int64
    )


def average_grid_host(mask_logits: np.ndarray, step_seconds: float = 0.6):
    """The host pipeline's overlap grid: (num_windows, 256) raw logits in
    window order → (sum_grid, count_grid), float64, sized to the last
    covered bin."""
    n = mask_logits.shape[0]
    if n == 0:
        return np.zeros(0), np.zeros(0)
    offs = window_bin_offset(np.arange(n), step_seconds)
    glen = int(offs[-1]) + mask_logits.shape[1]
    s = np.zeros(glen, np.float64)
    c = np.zeros(glen, np.float64)
    idx = (offs[:, None] + np.arange(mask_logits.shape[1])[None, :]).ravel()
    np.add.at(s, idx, mask_logits.astype(np.float64).ravel())
    np.add.at(c, idx, 1.0)
    return s, c


def smooth_grid(avg_values: np.ndarray, width: int) -> np.ndarray:
    """Centered running median over ``width`` (odd) bins, edges replicated."""
    if width <= 1:
        return np.asarray(avg_values)
    av = np.asarray(avg_values, np.float64)
    if len(av) == 0:
        return av
    w = min(int(width) | 1, 2 * len(av) - 1)
    padded = np.pad(av, w // 2, mode="edge")
    return np.median(sliding_window_view(padded, w), axis=1)


def find_speech_regions(
    avg_values: np.ndarray,
    threshold: float = 0.1,
    break_duration: float = 0.5,
    first_bin: int = 0,
    exit_threshold: Optional[float] = None,
    smooth_bins: int = 0,
) -> List[Tuple[float, float]]:
    """Threshold + run-find + gap-merge over the averaged grid.

    ``exit_threshold`` below ``threshold`` turns on hysteresis: a region
    needs a bin above ``threshold`` and extends over the contiguous bins
    above ``exit_threshold`` (not reference behaviour; off by default).
    ``smooth_bins`` > 1 applies ``smooth_grid`` first.
    """
    av = np.asarray(avg_values)
    if smooth_bins > 1:
        av = smooth_grid(av, smooth_bins)
    above = av > threshold
    if not above.any():
        return []
    runs = above
    if exit_threshold is not None and exit_threshold < threshold:
        runs = av > exit_threshold
    d = np.diff(runs.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1)  # inclusive index of the run's last bin
    if runs[0]:
        starts = np.r_[0, starts]
    if runs[-1]:
        ends = np.r_[ends, len(runs) - 1]
    if runs is not above:  # keep only low-threshold runs holding a seed bin
        seed_csum = np.r_[0, np.cumsum(above)]
        has_seed = seed_csum[ends + 1] - seed_csum[starts] > 0
        starts, ends = starts[has_seed], ends[has_seed]

    st = np.array([bin_time(first_bin + int(i)) for i in starts])
    et = np.array([bin_time(first_bin + int(i)) for i in ends])
    if len(st) > 1:
        new_group = np.flatnonzero(st[1:] - et[:-1] > break_duration)
        merged_s = st[np.r_[0, new_group + 1]]
        merged_e = et[np.r_[new_group, len(et) - 1]]
        return list(zip(merged_s, merged_e))
    return list(zip(st, et))


def shift_regions(regions, offset_seconds: float) -> List[Tuple[float, float]]:
    """Apply the −pad shift (worker.py:100)."""
    return [(s + offset_seconds, e + offset_seconds) for (s, e) in regions]


def filter_min_length(regions, minimum_detection_len: float = 0.1):
    """Review-stage filter: keep only length > minimum_detection_len
    (settings.py:26, review_detections.py:764-770)."""
    return [(s, e) for (s, e) in regions if (e - s) > minimum_detection_len]


def merge_intervals(intervals, gap: float = 0.3) -> List[Tuple[float, float]]:
    """Sort and merge intervals whose gap is ≤ ``gap`` seconds: the label
    merge shared by both synthetic generators (``train/synth.py``,
    ``train/synth2.py``)."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s - merged[-1][1] <= gap:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged
