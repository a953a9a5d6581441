"""Window logits -> averaged score grid -> speech regions, in numpy.

The reference detector's post-processing (``NNDetector.py`` of AVianEco/
Softspoken, ``worker.py`` for the pad shift):

  * bins of 3/256 s; window i adds its 256 logits from bin
    round(i * 0.6 / (3/256)) (half to even); each bin is the mean of the
    windows covering it;
  * a bin above the threshold (0.1) is speech; a region runs from its first
    to its last speech bin, each time taken as "%.4f" of bin * 3/256;
  * regions whose gap is at most 0.5 s merge; every time is shifted by
    -3 s, the zero padding.

The minimum detection length (0.1 s) is applied by the review stage, not
by detection, so it is not applied here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

DT = 3.0 / 256.0


def bin_offsets(n: int, step: float = 0.6) -> np.ndarray:
    return np.rint(np.arange(n, dtype=np.float64) * step / DT).astype(np.int64)


def average(logits: np.ndarray, step: float = 0.6) -> np.ndarray:
    """(W, 256) logits -> float64 mean grid over bins [0, last + 256)."""
    off = bin_offsets(logits.shape[0], step)
    n = int(off[-1]) + logits.shape[1]
    s = np.zeros(n)
    c = np.zeros(n)
    for i, o in enumerate(off):
        s[o: o + logits.shape[1]] += logits[i]
        c[o: o + logits.shape[1]] += 1.0
    return s / np.maximum(c, 1.0)


def regions(avg: np.ndarray, threshold: float = 0.1, merge_gap: float = 0.5,
            shift: float = -3.0) -> List[Tuple[float, float]]:
    """In the grid's own dtype: a float32 grid is compared with float32's
    0.1, a float64 grid with float64's."""
    above = np.asarray(avg) > threshold
    runs: List[Tuple[float, float]] = []
    i, n = 0, len(above)
    while i < n:
        if above[i]:
            j = i
            while j + 1 < n and above[j + 1]:
                j += 1
            runs.append((float(f"{i * DT:.4f}"), float(f"{j * DT:.4f}")))
            i = j + 1
        else:
            i += 1
    merged: List[Tuple[float, float]] = []
    for s, e in runs:
        if merged and s - merged[-1][1] <= merge_gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return [(s + shift, e + shift) for s, e in merged]
