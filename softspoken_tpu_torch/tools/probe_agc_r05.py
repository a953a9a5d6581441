"""Directional probe: inference-side level normalization (AGC) for the
deep-fade recall collapse.

The port of ``scripts/probe_agc_r05.py``.  The round-5 per-event taxonomy
(docs/QUALITY_r05.json) names v2_fading's event gap: most FNs are outright
MISSES inside deep-fade segments, plus false alarms — a level problem, not
a boundary problem.  The fading channel (train/degrade.py: 8-20 s
random-walk gain) drifts the level the detector sees, while training clips
are level-stationary.  This probe measures the cheapest inference-side
counter: a slow automatic gain control applied to the audio BEFORE
detection —

    env(t) = sqrt(moving_avg(x^2, win))        (win ~ 3 s: longer than
                                                speech events, shorter
                                                than the fade timescale)
    y(t)   = x(t) * ref / max(env(t), floor)   (floor keeps silence from
                                                being amplified into a
                                                false-alarm bed)

A/B on the SAME synthesized eval files (seeds 9500+i; fading / clean / snr5
/ clip in both generators), parity operating point, one ``Detector`` of
the committed weights for both arms: frame and event F1 and the miss /
merged / false_alarm taxonomy per condition and arm.  The AGC files are
written once beside the originals as ``*_agc.wav`` (PCM_16).  A host-side
prototype for direction only.  The record is docs/PROBE_AGC_r05.json;
``--upload-codec`` picks the fused pipeline's wire ("auto" is exact PCM16
on the card, decimated mu-law on the JAX package's TPU).

    python -m softspoken_tpu_torch.tools.probe_agc_r05 [--files 4]
        [--seconds 90] [--workdir DIR] [--out PATH] [--config JSON]
        [--upload-codec auto|pcm16|mulaw8|adpcm4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import Config
from ..engine import Detector
from ..io import wavio
from ..ops import KERNEL_LAUNCHES
from ..train import evaluate as E
from . import DEFAULT_CKPT, OUT_DIR, add_device_arg, print_launches, resolve_out
from . import quality_grid as QG

CONDS = [
    ("fading", dict(degradations=["fading"])),
    ("clean", dict()),
    ("snr5", dict(snr_db=(5.0, 5.0))),
    ("clip", dict(degradations=["clip"])),
]
SEED0 = 9500  # condition i's eval set: seed 9500 + i, in both generators
DEFAULT_OUT = os.path.join(OUT_DIR, "PROBE_AGC_torch.json")


def moving_average_same(v: np.ndarray, win: int) -> np.ndarray:
    """``np.convolve(v, np.ones(win) / win, mode="same")`` for
    ``len(v) >= win`` as a difference of cumulative sums: O(N) where the
    direct convolution is O(N * win) (a 96,000-tap box at 32 kHz).  The
    window of output i covers ``v[i + (win - 1) // 2 - win + 1 ..
    i + (win - 1) // 2]``, clipped to the signal."""
    n = len(v)
    if n < win:
        raise ValueError(f"AGC window of {win} samples is longer than the signal ({n})")
    c = np.concatenate(([0.0], np.cumsum(v, dtype=np.float64)))
    i = np.arange(n)
    hi = np.minimum(i + (win - 1) // 2, n - 1) + 1
    lo = np.maximum(i + (win - 1) // 2 - win + 1, 0)
    return (c[hi] - c[lo]) / win


def agc(x: np.ndarray, sr: int, win_s: float = 3.0,
        floor_db: float = -45.0) -> np.ndarray:
    """Slow RMS-envelope normalization (zero-phase moving average)."""
    win = max(1, int(sr * win_s))
    env2 = moving_average_same(x.astype(np.float64) ** 2, win)
    env = np.sqrt(np.maximum(env2, 0.0))
    floor = 10.0 ** (floor_db / 20.0)
    ref = max(float(np.median(env)), floor)  # preserve the file's own level
    y = x.astype(np.float64) * (ref / np.maximum(env, floor))
    peak = np.abs(y).max()
    if peak > 0.99:  # the wire is int16; avoid clipping the normalized take
        y *= 0.99 / peak
    return y.astype(np.float32)


def agc_files(labeled, win_s: float, floor_db: float) -> list:
    """The AGC twin of each labeled file, ``<stem>_agc.wav`` in PCM_16
    beside it, written once and reused."""
    labeled_agc = []
    for path, truth in labeled:
        ap_path = path[:-4] + "_agc.wav"
        if not os.path.exists(ap_path):
            x, sr = wavio.read(path)
            if x.ndim > 1:
                x = x.mean(axis=1)
            wavio.write(ap_path, agc(x, sr, win_s, floor_db), sr, subtype="PCM_16")
        labeled_agc.append((ap_path, truth))
    return labeled_agc


def arm_row(det, labeled, pad_seconds: float) -> dict:
    """One arm of a condition: parity frame and event F1 and the taxonomy."""
    m = QG.metrics_from(QG.detect_set(det, labeled), pad_seconds)
    return {"frame_f1": m["parity"]["frame_f1"], "event_f1": m["parity"]["event_f1"],
            "taxonomy": {k: m["parity"]["event_error_taxonomy"][k]
                         for k in ("miss", "merged", "false_alarm")}}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, "work_r05", "agc"))
    ap.add_argument("--win", type=float, default=3.0)
    ap.add_argument("--floor-db", type=float, default=-45.0)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--upload-codec", default="auto",
                    choices=["auto", "pcm16", "mulaw8", "adpcm4"],
                    help="the fused pipeline's upload wire (engine.upload_codec); "
                         "mulaw8 is the JAX package's \"auto\" on its TPU")
    ap.add_argument("--config", default=None,
                    help="a config JSON (as the CLI's --config) in place of the "
                         "defaults, e.g. {\"engine\": {\"precision\": \"parity\"}}")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    launches0 = dict(KERNEL_LAUNCHES)
    t0 = time.time()
    out_path = resolve_out(args.out)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    cfg = (Config.from_file(args.config) if args.config else Config()).with_engine(
        upload_codec=args.upload_codec)
    det = Detector(cfg, checkpoint_path=args.ckpt, device=args.device)
    if getattr(det, "epoch", -1) < 0:
        raise SystemExit("committed checkpoint did not load")

    out = {"win_s": args.win, "floor_db": args.floor_db,
           "files": args.files, "seconds": args.seconds, "conditions": {}}
    for gen in ("v1", "v2"):
        for ci, (cname, kw) in enumerate(CONDS):
            tag = f"{gen}_{cname}"
            d = os.path.join(wd, f"eval_{tag}")
            labels = os.path.join(d, "labels.csv")
            if not os.path.exists(labels):
                labels = E.make_eval_set(d, n_files=args.files, seconds=args.seconds,
                                         seed=SEED0 + ci, generator=gen, **kw)
            labeled = E.load_labels(labels)
            labeled_agc = agc_files(labeled, args.win, args.floor_db)
            row = {name: arm_row(det, lab, cfg.engine.pad_seconds)
                   for name, lab in (("baseline", labeled), ("agc", labeled_agc))}
            row["delta_frame"] = round(row["agc"]["frame_f1"] - row["baseline"]["frame_f1"], 4)
            row["delta_event"] = round(row["agc"]["event_f1"] - row["baseline"]["event_f1"], 4)
            out["conditions"][tag] = row
            print(f"{tag}: frame {row['baseline']['frame_f1']} -> "
                  f"{row['agc']['frame_f1']} ({row['delta_frame']:+.4f})  "
                  f"event {row['baseline']['event_f1']} -> "
                  f"{row['agc']['event_f1']} ({row['delta_event']:+.4f})", flush=True)

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {out_path} in {time.time() - t0:.1f} s", flush=True)
    print_launches(launches0)
    return out


if __name__ == "__main__":
    main()
