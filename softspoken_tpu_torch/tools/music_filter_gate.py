"""Grid-neutrality gate for the music post-filter (``engine/postfilter.py``):
the port of ``scripts/music_filter_gate.py``.

The filter can only DROP detected regions, so its only possible harm on the
synthetic quality grid is dropping true speech regions.  This gate
measures that directly:

  Part 1 (scorer sweep, no NN, host numpy): regenerate every grid
  condition's eval set (the seeds and conditions of ``quality_grid``) and
  score each TRUTH region's context window with ``postfilter.music_score``.
  A region scoring >= the threshold would be dropped if the detector
  predicted it; the per-condition drop count and score distribution bound
  what the filter could do to grid recall.

  Part 2 (full-pipeline A/B, on the card unless ``--device cpu``): detect
  a subset of conditions with the trained checkpoint, music filter off vs
  on, and diff the interval lists — the conditions with periodic artifacts
  most like a beat (hum, dropout) plus both generators' clean sets.

    python -m softspoken_tpu_torch.tools.music_filter_gate [--threshold 0.6]
        [--files 8] [--seconds 120] [--out PATH] [--quick] [--skip-detect]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..config import Config
from ..engine import postfilter as PF
from ..engine.detector import resolve_device
from ..io import wavio
from ..io.resample import resample
from ..train import evaluate as E
from . import DEFAULT_CKPT, add_device_arg, resolve_out
from .quality_grid import CONDITIONS

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "music_filter_gate.json")


def score_truth_regions(labels_csv, sr_internal, threshold):
    """Score every truth region's context in one condition's eval set."""
    scores = []
    dropped = 0
    total = 0
    for path, truth in E.load_labels(labels_csv):
        x, sr = wavio.read(path)
        x = np.asarray(x, np.float32)
        if sr != sr_internal:
            x = resample(x, sr, sr_internal).astype(np.float32)
        dur = len(x) / sr_internal

        def read_ctx(s, e, _x=x):
            return _x[int(s * sr_internal):int(e * sr_internal)]

        kept, sc = PF.filter_intervals(truth, read_ctx, sr_internal, dur, threshold)
        scores.extend(v for v in sc if np.isfinite(v))
        total += len(truth)
        dropped += len(truth) - len(kept)
    if not scores:
        return {"regions": total, "dropped": dropped}
    arr = np.array(scores)
    return {
        "regions": total,
        "dropped": dropped,
        "score_median": round(float(np.median(arr)), 3),
        "score_p90": round(float(np.percentile(arr, 90)), 3),
        "score_max": round(float(arr.max()), 3),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threshold", type=float, default=None,
                    help="default: postfilter.DEFAULT_THRESHOLD")
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--quick", action="store_true",
                    help="2 files x 60 s, 3 conditions, no detect A/B")
    ap.add_argument("--skip-detect", action="store_true",
                    help="Part 1 (scorer sweep) only")
    ap.add_argument("--workdir", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.out = resolve_out(args.out)

    thr = args.threshold if args.threshold is not None else PF.DEFAULT_THRESHOLD
    n_files, seconds = args.files, args.seconds
    conditions = CONDITIONS
    if args.quick:
        n_files, seconds = 2, 60.0
        conditions = CONDITIONS[:2] + [CONDITIONS[9]]  # clean, snr0, hum
        args.skip_detect = True

    # Part 2's device, resolved before Part 1's synthesis: without a card
    # the gate raises at once
    device = None if args.skip_detect else resolve_device(args.device)
    sr_internal = Config().dsp.sample_rate
    base = args.workdir or tempfile.mkdtemp(prefix="mf_gate_")
    out = {"threshold": thr, "eval": {"files": n_files, "seconds": seconds},
           "truth_region_sweep": {}, "detect_ab": {}}

    t_all = time.time()
    worst = None
    labels_by_tag = {}
    for gen in ("v1", "v2"):
        for ci, (cname, kw) in enumerate(conditions):
            tag = f"{gen}_{cname}"
            labels = E.make_eval_set(os.path.join(base, tag), n_files=n_files,
                                     seconds=seconds, seed=7000 + ci,
                                     generator=gen, **kw)
            labels_by_tag[tag] = labels
            r = score_truth_regions(labels, sr_internal, thr)
            out["truth_region_sweep"][tag] = r
            if "score_max" in r and (worst is None or r["score_max"] > worst):
                worst = r["score_max"]
            print(f"sweep {tag}: {r}", flush=True)
    out["truth_region_sweep_worst_score"] = worst
    out["truth_region_sweep_total_dropped"] = sum(
        r["dropped"] for r in out["truth_region_sweep"].values())

    if not args.skip_detect:
        from ..engine import Detector

        ab_tags = ["v1_clean", "v2_clean", "v1_hum", "v2_hum",
                   "v1_dropout", "v2_dropout"]
        cfg = Config().with_engine(mel_precision="highest")
        det0 = Detector(cfg, checkpoint_path=args.ckpt, device=device)
        if getattr(det0, "epoch", -1) < 0:
            raise SystemExit("checkpoint did not load (epoch<0)")
        det1 = Detector(cfg.with_engine(music_filter=thr), checkpoint_path=args.ckpt,
                        device=device)
        for tag in ab_tags:
            if tag not in labels_by_tag:
                continue
            labeled = E.load_labels(labels_by_tag[tag])
            diff = 0
            regions0 = regions1 = 0
            for path, _truth in labeled:
                r0 = det0.detect_file_streaming(path)
                r1 = det1.detect_file_streaming(path)
                regions0 += len(r0.intervals)
                regions1 += len(r1.intervals)
                if list(r0.intervals) != list(r1.intervals):
                    diff += 1
            out["detect_ab"][tag] = {
                "files": len(labeled), "files_with_diff": diff,
                "regions_off": regions0, "regions_on": regions1,
            }
            print(f"A/B {tag}: {out['detect_ab'][tag]}", flush=True)

    out["wall_seconds"] = round(time.time() - t_all, 1)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} in {out['wall_seconds']} s", flush=True)
    return out


if __name__ == "__main__":
    main()
