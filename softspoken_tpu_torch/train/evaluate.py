"""Detection-quality evaluation: precision / recall / F1 on labeled audio.

A copy of the JAX package's ``train/evaluate.py``.  Two complementary
views:

  * **frame-level** — precision/recall/F1 of speech presence on the
    engine's own 3/256 s score grid (the resolution of the mask head);
  * **event-level** — greedy one-to-one matching of predicted to labeled
    intervals at an IoU threshold (0.5 default), with an error taxonomy
    that names each failure (miss, merged, split, boundary, false alarm,
    fragment).

Labels are ``<stem>.txt`` Audacity-style files (start\\tend\\tlabel) or the
``labels.csv`` written by ``make_eval_set`` (file,start_time,end_time rows —
one row per speech span).  ``make_eval_set`` synthesizes labeled outdoor
recordings with either generator (``train/synth.py``, the training family,
or ``train/synth2.py``, out of family) under the degradations of
``train/degrade.py``, so an F1 is measurable with zero external data.
``evaluate_detector`` runs a ``Detector`` over them (the ``eval`` command).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

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


def event_error_taxonomy(
    pred: Sequence[Interval], truth: Sequence[Interval], iou: float = 0.5
) -> Dict[str, float]:
    """Classify every event-level failure so the dominant mode is NAMED.

    Event F1 lags frame F1 across the whole quality grid, but a
    single number cannot say whether the detector *misses* events, *merges*
    neighbours into one span, *splits* one event into fragments, or finds
    them with *boundaries* too far off to clear the IoU bar — and each of
    those points at a different lever (recall/threshold, break_duration,
    smoothing, boundary localization).  Mirrors the reference's event
    granularity: its regionization emits one row per merged region
    (NNDetector.py:103-143), so event identity is region identity.

    Runs the same greedy matching as :func:`event_metrics`, then classifies
    each unmatched TRUTH event (the FNs):

      * ``miss``     — no predicted interval overlaps it at all
      * ``merged``   — an overlapping prediction also overlaps other truth
                       events (one span swallowed several; checked first —
                       a merged span is usually also the only overlap)
      * ``split``    — ≥2 predictions overlap this truth alone (fragmented)
      * ``boundary`` — exactly one 1:1 overlapping prediction, IoU < bar:
                       the event was found, its edges were not

    and each unmatched PREDICTION (the FPs):

      * ``false_alarm`` — overlaps no truth at all (a real false fire)
      * ``fragment``    — overlaps truth but lost the match (the pred-side
                          shadow of merged/split/boundary; kept separate so
                          false-alarm counts stay honest)

    Matched pairs contribute onset/offset absolute errors (seconds) so a
    dominant ``boundary`` class can be read as trim magnitude.  Counts sum
    across files; combine with :func:`merge_taxonomy`.
    """

    def _inter(a: Interval, b: Interval) -> float:
        return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))

    pairs = sorted(
        ((_iou(p, t), i, j) for i, p in enumerate(pred) for j, t in enumerate(truth)),
        reverse=True,
    )
    used_p, used_t = set(), set()
    matched: List[Tuple[int, int]] = []
    for score, i, j in pairs:
        if score < iou:
            break
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        matched.append((i, j))

    out = {"miss": 0.0, "merged": 0.0, "split": 0.0, "boundary": 0.0,
           "false_alarm": 0.0, "fragment": 0.0,
           "onset_abs_err_sum": 0.0, "offset_abs_err_sum": 0.0,
           "matched": float(len(matched))}
    # truth events each prediction touches (for the merged test)
    touches = {i: [j for j, t in enumerate(truth) if _inter(p, t) > 0]
               for i, p in enumerate(pred)}
    for j, t in enumerate(truth):
        if j in used_t:
            continue
        over = [i for i, p in enumerate(pred) if _inter(p, t) > 0]
        if not over:
            out["miss"] += 1
        elif any(len(touches[i]) >= 2 for i in over):
            out["merged"] += 1
        elif len(over) >= 2:
            out["split"] += 1
        else:
            out["boundary"] += 1
    for i, p in enumerate(pred):
        if i in used_p:
            continue
        if touches[i]:
            out["fragment"] += 1
        else:
            out["false_alarm"] += 1
    for i, j in matched:
        out["onset_abs_err_sum"] += abs(pred[i][0] - truth[j][0])
        out["offset_abs_err_sum"] += abs(pred[i][1] - truth[j][1])
    return out


def merge_taxonomy(total: Dict[str, float], part: Dict[str, float]) -> None:
    """Accumulate :func:`event_error_taxonomy` outputs across files."""
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + v


def finalize_taxonomy(total: Dict[str, float]) -> Dict[str, float]:
    """Counts → report: per-class FN fractions + mean boundary errors."""
    fn = sum(total.get(k, 0.0) for k in ("miss", "merged", "split", "boundary"))
    n_match = total.get("matched", 0.0)
    out = {k: total.get(k, 0.0)
           for k in ("miss", "merged", "split", "boundary",
                     "false_alarm", "fragment")}
    for k in ("miss", "merged", "split", "boundary"):
        out[f"{k}_frac_of_fn"] = round(out[k] / fn, 4) if fn else 0.0
    out["onset_mae_s"] = (round(total["onset_abs_err_sum"] / n_match, 4)
                          if n_match else 0.0)
    out["offset_mae_s"] = (round(total["offset_abs_err_sum"] / n_match, 4)
                           if n_match else 0.0)
    return out


def event_metrics_granularity(
    pred: Sequence[Interval],
    truth: Sequence[Interval],
    break_duration: float,
    iou: float = 0.5,
) -> Dict[str, float]:
    """Event metrics with truth re-merged at the operating point's gap.

    The synthetic label generators merge ground-truth spans at a fixed
    0.3 s gap (engine/regions.py::merge_intervals — the shared label
    convention), while the detector merges predictions at the operating
    point's ``break_duration``.  When that is larger (the parity point's
    0.5 s, settings.py:13 / NNDetector.py:133), one prediction legitimately
    spans several truth events and 1:1 IoU matching penalizes BOTH sides —
    a granularity artifact, not a detection error.  Re-merging truth with
    the same gap evaluates events at the operating point's own output
    granularity.  Report this alongside (never instead of) the plain
    event metric.
    """
    from ..engine.regions import merge_intervals

    return event_metrics(pred, merge_intervals(truth, break_duration), iou)


def _accumulate(total: Dict[str, float], part: Dict[str, float]) -> None:
    for k in ("tp", "fp", "fn"):
        total[k] = total.get(k, 0.0) + part[k]


def _finalize(total: Dict[str, float]) -> Dict[str, float]:
    tp, fp, fn = total.get("tp", 0.0), total.get("fp", 0.0), total.get("fn", 0.0)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"tp": tp, "fp": fp, "fn": fn,
            "precision": prec, "recall": rec, "f1": f1}


# --------------------------------------------------------------------------
# label IO
# --------------------------------------------------------------------------

def save_labels(path: str, labeled: Sequence[Tuple[str, Sequence[Interval]]]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "start_time", "end_time"])
        for fname, ivs in labeled:
            for s, e in ivs:
                w.writerow([fname, f"{s:.6f}", f"{e:.6f}"])


_AUDIO_EXTS = (".wav", ".flac", ".aif", ".aiff", ".ogg")


def _audio_for_stem(directory: str, stem: str) -> Optional[str]:
    for ext in _AUDIO_EXTS:
        cand = os.path.join(directory, stem + ext)
        if os.path.isfile(cand):
            return cand
    return None


def _load_audacity_txt(path: str) -> List[Interval]:
    """One Audacity label track: ``start\\tend\\tlabel`` per line, no header
    (the format export/audacity.py writes — see its module docstring)."""
    intervals: List[Interval] = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                raise ValueError(
                    f"{path}:{ln}: not an Audacity label row (need "
                    f"start<TAB>end[<TAB>label]): {line!r}")
            intervals.append((float(parts[0]), float(parts[1])))
    return sorted(intervals)


def load_labels(path: str) -> List[Tuple[str, List[Interval]]]:
    """Load evaluation labels from any supported container:

      * ``labels.csv`` (file,start_time,end_time rows — make_eval_set)
      * a single Audacity ``<stem>.txt`` label track (start\\tend\\tlabel,
        tab-separated, no header) — the matching audio is ``<stem>.wav``
        (or .flac/.aif/.ogg) next to it
      * a directory of such ``.txt`` tracks
    """
    if os.path.isdir(path):
        out: List[Tuple[str, List[Interval]]] = []
        for txt in sorted(os.listdir(path)):
            if not txt.endswith(".txt"):
                continue
            full_txt = os.path.join(path, txt)
            audio = _audio_for_stem(path, os.path.splitext(txt)[0])
            if audio is None:
                raise FileNotFoundError(
                    f"no audio file next to label track {full_txt} "
                    f"(looked for {os.path.splitext(txt)[0]}{_AUDIO_EXTS})")
            out.append((audio, _load_audacity_txt(full_txt)))
        if not out:
            raise FileNotFoundError(f"no .txt label tracks in {path}")
        return out
    if path.endswith(".txt"):
        directory = os.path.dirname(os.path.abspath(path))
        stem = os.path.splitext(os.path.basename(path))[0]
        audio = _audio_for_stem(directory, stem)
        if audio is None:
            raise FileNotFoundError(
                f"no audio file next to label track {path} "
                f"(looked for {stem}{_AUDIO_EXTS})")
        return [(audio, _load_audacity_txt(path))]

    by_file: Dict[str, List[Interval]] = {}
    order: List[str] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            fn = row["file"]
            if fn not in by_file:
                by_file[fn] = []
                order.append(fn)
            by_file[fn].append((float(row["start_time"]), float(row["end_time"])))
    base = os.path.dirname(os.path.abspath(path))
    out = []
    for fn in order:
        full = fn if os.path.isabs(fn) else os.path.join(base, fn)
        out.append((full, sorted(by_file[fn])))
    return out


def make_eval_set(
    outdir: str,
    n_files: int = 8,
    seconds: float = 120.0,
    sr: int = 32000,
    seed: int = 1234,
    generator: str = "v1",
    snr_db: Optional[Tuple[float, float]] = None,
    degradations: Optional[Sequence[str]] = None,
) -> str:
    """Synthesize labeled field recordings; returns the labels.csv path.

    ``generator``: "v1" (train/synth.py — the TRAINING family) or "v2"
    (train/synth2.py — the independently-written out-of-family generator).
    ``snr_db`` pins the per-event SNR range (default: each generator's own
    0–20 dB draw).  ``degradations`` is a list of
    train/degrade.py condition names applied to the finished recordings.
    """
    from ..io import wavio
    from . import synth, synth2

    make = {"v1": synth.synth_field_recording,
            "v2": synth2.field_recording2}[generator]
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    labeled = []
    for i in range(n_files):
        kwargs = {} if snr_db is None else {"snr_db": snr_db}
        audio, ivs = make(rng, seconds, sr=sr, **kwargs)
        if degradations:
            from . import degrade

            audio = degrade.apply(audio, sr, degradations, rng)
        name = f"eval_{i:03d}.wav"
        wavio.write(os.path.join(outdir, name), audio, sr, subtype="PCM_16")
        labeled.append((name, ivs))
    labels_path = os.path.join(outdir, "labels.csv")
    save_labels(labels_path, labeled)
    return labels_path


# --------------------------------------------------------------------------
# the harness
# --------------------------------------------------------------------------

def evaluate_detector(
    detector,
    labeled: Sequence[Tuple[str, Sequence[Interval]]],
    iou: float = 0.5,
    min_len: float = 0.1,
) -> Dict[str, object]:
    """Run detection over labeled files; returns aggregate + per-file metrics.

    Applies the review-stage minimum-length filter (settings.py:26) to the
    predictions, mirroring what the review stage exports.
    """
    from ..engine import regions as R

    frame_total: Dict[str, float] = {}
    event_total: Dict[str, float] = {}
    per_file = []
    for path, truth in labeled:
        res = detector.detect_file(path)
        # clamp into [0, dur] FIRST so the min-length filter judges the
        # audible span, not a pad-straddling one; the duration comes from
        # the detection result itself — same clock the predictions were
        # made on, and no second header probe per file.
        # Both edges: a right-pad-only prediction (s >= dur) must drop the
        # same way a left-pad-only one (e <= 0) does.
        dur = res.audio_seconds
        pred = [
            (max(0.0, s), min(dur, e))
            for s, e in res.intervals if e > 0 and s < dur
        ]
        pred = R.filter_min_length(pred, min_len)
        fm = frame_metrics(pred, truth, dur)
        em = event_metrics(pred, truth, iou)
        _accumulate(frame_total, fm)
        _accumulate(event_total, em)
        per_file.append({
            "file": os.path.basename(path),
            "n_pred": len(pred), "n_truth": len(truth),
            "frame_f1": fm["f1"], "event_f1": em["f1"],
        })
    return {
        "frame": _finalize(frame_total),
        "event": _finalize(event_total),
        "files": per_file,
    }
