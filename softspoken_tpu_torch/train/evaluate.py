"""Detection-quality metrics: precision / recall / F1 on labeled audio.

Copies of the metric functions of the JAX package's ``train/evaluate.py``
(``_grid_mask``, ``frame_metrics``, ``_iou``, ``event_metrics``).  Two
views:

  * **frame-level** — precision/recall/F1 of speech presence on the
    engine's own 3/256 s score grid (the resolution of the mask head);
  * **event-level** — greedy one-to-one matching of predicted to labeled
    intervals at an IoU threshold (0.5 default).

The labeled recordings come from ``train/synth.synth_field_recording``.
The rest of the JAX evaluation harness (eval sets on disk, the error
taxonomy, the ``eval`` command) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]


def _grid_mask(intervals: Sequence[Interval], n_bins: int, dt: float) -> np.ndarray:
    m = np.zeros(n_bins, bool)
    for s, e in intervals:
        a = max(0, int(np.floor(s / dt)))
        b = min(n_bins, int(np.ceil(e / dt)))
        if b > a:
            m[a:b] = True
    return m


def frame_metrics(
    pred: Sequence[Interval],
    truth: Sequence[Interval],
    duration: float,
    dt: float = 3.0 / 256.0,
) -> Dict[str, float]:
    """Speech-presence P/R/F1 on the engine's score grid."""
    n = max(1, int(np.ceil(duration / dt)))
    p = _grid_mask(pred, n, dt)
    t = _grid_mask(truth, n, dt)
    tp = float((p & t).sum())
    fp = float((p & ~t).sum())
    fn = float((~p & t).sum())
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"tp": tp, "fp": fp, "fn": fn,
            "precision": prec, "recall": rec, "f1": f1}


def _iou(a: Interval, b: Interval) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


def event_metrics(
    pred: Sequence[Interval], truth: Sequence[Interval], iou: float = 0.5
) -> Dict[str, float]:
    """Greedy IoU matching (each truth matched to ≤1 prediction)."""
    pairs = sorted(
        ((_iou(p, t), i, j) for i, p in enumerate(pred) for j, t in enumerate(truth)),
        reverse=True,
    )
    used_p, used_t = set(), set()
    tp = 0
    for score, i, j in pairs:
        if score < iou:
            break
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        tp += 1
    fp = len(pred) - tp
    fn = len(truth) - tp
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"tp": float(tp), "fp": float(fp), "fn": float(fn),
            "precision": prec, "recall": rec, "f1": f1}
