"""Out-of-family quality grid of a checkpoint: the maintainers' gate.

The port of ``scripts/quality_grid.py``.  Runs the committed trained
checkpoint over labeled eval sets from BOTH synthetic generators (v1 = the
training family, v2 = the independently-written out-of-family
``train/synth2.py``) under a degradation grid (pinned SNRs, 4 kHz mic
rolloff, clipping, mu-law round trip, mains hum, dropouts, reverberation,
fading), and reports frame/event F1 at the parity operating point
(threshold 0.1, merge 0.5 s) FIRST, the tuned point (merge 0.3 s) second,
plus threshold, hysteresis, smoothing and IoU sweeps recomputed host-side
from each file's averaged score grid (one detection pass per file).

The detector is ``Detector(Config().with_engine(mel_precision=...))``: on
the card the fused pipeline with the frame_mel kernel in "highest" mode,
as the JAX package runs it on its accelerator.  The output JSON, the
``--cache-dir`` files and the flags are the JAX script's: its
``scripts/compare_grids.py`` and ``--rescore`` read this tool's, and the
other way round.

    python -m softspoken_tpu_torch.tools.quality_grid [--out PATH]
        [--files 8] [--seconds 120] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..config import Config
from ..engine import Detector
from ..engine import postfilter as PF
from ..engine import regions as R
from ..engine.fused import _i16_kind
from ..io import load_audio_startstop
from ..ops import KERNEL_LAUNCHES
from ..train import evaluate as E
from . import (DEFAULT_CKPT, OUT_DIR, add_device_arg, print_launches, repo_relative,
               resolve_out)

THRESHOLDS = [0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5]
HYST_EXITS = [0.0, 0.02, 0.05, 0.08]
PARITY = {"threshold": 0.1, "break_duration": 0.5}
TUNED = {"threshold": 0.1, "break_duration": 0.3}

CONDITIONS = [
    ("clean", dict()),
    ("snr0", dict(snr_db=(0.0, 0.0))),
    ("snr5", dict(snr_db=(5.0, 5.0))),
    ("snr10", dict(snr_db=(10.0, 10.0))),
    ("snr20", dict(snr_db=(20.0, 20.0))),
    ("rolloff4k", dict(degradations=["rolloff4k"])),
    ("clip", dict(degradations=["clip"])),
    ("mulaw", dict(degradations=["mulaw"])),
    ("bfp4", dict(degradations=["bfp4"])),
    ("hum", dict(degradations=["hum"])),
    ("dropout", dict(degradations=["dropout"])),
    ("rolloff4k+mulaw", dict(degradations=["rolloff4k", "mulaw"])),
    ("snr5+rolloff4k", dict(snr_db=(5.0, 5.0), degradations=["rolloff4k"])),
    # reverberation at three RT60s (an image-source + Schroeder-tail RIR
    # independent of the training reverb), a slow-fading channel, and a
    # mid-SNR reverberant condition
    ("reverb03", dict(degradations=["reverb03"])),
    ("reverb08", dict(degradations=["reverb08"])),
    ("reverb15", dict(degradations=["reverb15"])),
    ("fading", dict(degradations=["fading"])),
    ("snr10+reverb08", dict(snr_db=(10.0, 10.0), degradations=["reverb08"])),
]
QUICK_CONDITIONS = CONDITIONS[:2] + [CONDITIONS[7], CONDITIONS[14]]
DEFAULT_OUT = os.path.join(OUT_DIR, "QUALITY_torch.json")


def detect_set(det, labeled):
    """One detection pass per file → the raw material of ``metrics_from``:
    the averaged score grid, the file's duration (from the result: the
    clock the predictions were made on), the truth intervals, the
    pipeline's own merged intervals (the codec gate compares those) and the
    file's path (the post-filter A/B reads its audio)."""
    per_file = []
    for path, truth in labeled:
        res = det.detect_file_streaming(path)
        per_file.append({
            "avg": np.asarray(res.avg_values, np.float32),
            "dur": float(res.audio_seconds),
            "truth": [(float(s), float(e)) for s, e in truth],
            "intervals": tuple(res.intervals),
            "path": os.path.abspath(path),
        })
    return per_file


def _predictions(pf_, pad_seconds, threshold, break_duration,
                 exit_threshold=None, smooth_bins=0):
    """A file's predicted intervals at one operating point: regions of the
    grid, shifted by -pad, clamped into [0, dur] at both edges FIRST (so the
    min-length filter judges the audible span), then min length 0.1 s."""
    avg, dur = pf_["avg"], pf_["dur"]
    regs = R.find_speech_regions(avg, threshold, break_duration,
                                 exit_threshold=exit_threshold,
                                 smooth_bins=smooth_bins)
    regs = R.shift_regions(regs, -pad_seconds)
    regs = [(max(0.0, s), min(dur, e)) for s, e in regs if e > 0 and s < dur]
    return R.filter_min_length(regs, 0.1)


def _f1s(f, e):
    return {"frame_f1": round(f["f1"], 4), "event_f1": round(e["f1"], 4)}


def metrics_from(per_file, pad_seconds):
    """Metrics at many operating points from cached score grids (host-only)."""

    def metrics_at(threshold, break_duration, exit_threshold=None,
                   smooth_bins=0, iou=0.5, taxonomy=None):
        ft, et, gt = {}, {}, {}
        for pf_ in per_file:
            truth, dur = pf_["truth"], pf_["dur"]
            pred = _predictions(pf_, pad_seconds, threshold, break_duration,
                                exit_threshold, smooth_bins)
            E._accumulate(ft, E.frame_metrics(pred, truth, dur))
            E._accumulate(et, E.event_metrics(pred, truth, iou))
            E._accumulate(gt, E.event_metrics_granularity(
                pred, truth, break_duration, iou))
            if taxonomy is not None:
                E.merge_taxonomy(taxonomy, E.event_error_taxonomy(pred, truth, iou))
        return E._finalize(ft), E._finalize(et), E._finalize(gt)

    # the per-event error taxonomy at the parity point names which failure
    # mode dominates each condition's event-F1 gap
    tax = {}
    pf, pe, pg = metrics_at(taxonomy=tax, **PARITY)
    tf, te, tg = metrics_at(**TUNED)
    sweep = {}
    for thr in THRESHOLDS:
        f, e, _ = metrics_at(thr, PARITY["break_duration"])
        sweep[str(thr)] = _f1s(f, e)
    # hysteresis (the engine's exit_threshold): the parity enter level,
    # extended over bins above the exit level
    hyst = {}
    for ex in HYST_EXITS:
        f, e, _ = metrics_at(PARITY["threshold"], PARITY["break_duration"],
                             exit_threshold=ex)
        hyst[str(ex)] = _f1s(f, e)
    # median smoothing widths, smoothing + hysteresis, and an IoU sweep so
    # that the 0.5 cutoff cannot hide near-miss boundary fragmentation
    smooth = {}
    for w in (3, 5, 7):
        f, e, _ = metrics_at(PARITY["threshold"], PARITY["break_duration"],
                             smooth_bins=w)
        smooth[f"s{w}"] = _f1s(f, e)
        f, e, _ = metrics_at(PARITY["threshold"], PARITY["break_duration"],
                             exit_threshold=0.05, smooth_bins=w)
        smooth[f"s{w}+hyst0.05"] = _f1s(f, e)
    iou_sweep = {}
    for iou in (0.3, 0.5, 0.7):
        _, e, _ = metrics_at(PARITY["threshold"], PARITY["break_duration"], iou=iou)
        iou_sweep[str(iou)] = round(e["f1"], 4)
    return {
        "parity": {"frame_f1": round(pf["f1"], 4),
                   "frame_precision": round(pf["precision"], 4),
                   "frame_recall": round(pf["recall"], 4),
                   "event_f1": round(pe["f1"], 4),
                   "event_precision": round(pe["precision"], 4),
                   "event_recall": round(pe["recall"], 4),
                   # truth re-merged at the operating point's own gap:
                   # separates one prediction legitimately spanning several
                   # close truth events from real misses; reported beside,
                   # never instead of, the plain event metric
                   "event_f1_granularity": round(pg["f1"], 4),
                   "event_error_taxonomy": E.finalize_taxonomy(tax)},
        "tuned": {"frame_f1": round(tf["f1"], 4),
                  "event_f1": round(te["f1"], 4),
                  "event_f1_granularity": round(tg["f1"], 4)},
        "threshold_sweep": sweep,
        "hysteresis_sweep": hyst,
        "smooth_sweep": smooth,
        "event_f1_iou_sweep": iou_sweep,
        "n_files": len(per_file),
    }


def postfilter_parity_metrics(per_file, pad_seconds, threshold):
    """Parity-point metrics WITH the music post-filter applied: the
    full-grid on-vs-off A/B of the filter.

    Reuses each file's cached score grid for the predictions and reads the
    eval WAV itself for the filter's context windows, the engine's own
    application point (``Detector._apply_music_filter`` runs on the merged
    interval list).  Files whose audio is gone (a rescore elsewhere) are
    skipped and counted.
    """
    sr = Config().dsp.sample_rate
    ft, et = {}, {}
    scored = skipped = dropped = total = 0
    for pf_ in per_file:
        path = pf_.get("path")
        if not path or not os.path.exists(path):
            skipped += 1
            continue
        dur, truth = pf_["dur"], pf_["truth"]
        pred = _predictions(pf_, pad_seconds, PARITY["threshold"],
                            PARITY["break_duration"])

        def read_ctx(s, e, _p=path):
            audio, _sr = load_audio_startstop(_p, (s, e), target_sr=sr)
            return audio

        kept, _scores = PF.filter_intervals(pred, read_ctx, sr, dur, threshold)
        dropped += len(pred) - len(kept)
        total += len(pred)
        scored += 1
        E._accumulate(ft, E.frame_metrics(kept, truth, dur))
        E._accumulate(et, E.event_metrics(kept, truth, 0.5))
    if scored == 0:
        return {"skipped_files": skipped, "note": "no audio on disk"}
    f, e = E._finalize(ft), E._finalize(et)
    return {
        "threshold": threshold,
        "frame_f1": round(f["f1"], 4),
        "frame_recall": round(f["recall"], 4),
        "event_f1": round(e["f1"], 4),
        "event_recall": round(e["recall"], 4),
        "regions_dropped": dropped,
        "regions_total": total,
        "files_scored": scored,
        "skipped_files": skipped,
    }


def score_set(det, labeled, pad_seconds):
    """One detection pass per file; metrics at many operating points."""
    per_file = detect_set(det, labeled)
    out = metrics_from(per_file, pad_seconds)
    out["intervals"] = [pf["intervals"] for pf in per_file]
    return out


def save_cache(path, per_file):
    """Persist a condition's score grids so that operating points and
    metric definitions can be re-evaluated host-side (``--rescore``)
    without the detection pass.  The JAX script's ``.npz`` layout."""
    arrs = {f"avg{i}": pf["avg"] for i, pf in enumerate(per_file)}
    meta = [{"dur": pf["dur"], "truth": pf["truth"],
             "intervals": [list(map(float, iv)) for iv in pf["intervals"]],
             "path": pf.get("path")}
            for pf in per_file]
    arrs["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrs)


def load_cache(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
        return [{
            "avg": z[f"avg{i}"],
            "dur": m["dur"],
            "truth": [tuple(t) for t in m["truth"]],
            "intervals": tuple(tuple(iv) for iv in m["intervals"]),
            "path": m.get("path"),
        } for i, m in enumerate(meta)]


def _check_cache_dir(cache_dir, ident):
    """A cache directory belongs to ONE run: the checkpoint by path AND
    content (a retrain written to the same path must not reuse the old
    weights' grids), the eval size, the mel precision and the pipeline."""
    os.makedirs(cache_dir, exist_ok=True)
    marker = os.path.join(cache_dir, "cache_ckpt.json")
    if os.path.exists(marker):
        with open(marker) as f:
            prev = json.load(f)
        if prev != ident:
            raise SystemExit(
                f"--cache-dir {cache_dir} belongs to a different run ({prev}); "
                "refusing to mix caches — use a fresh directory")
    else:
        with open(marker, "w") as f:
            json.dump(ident, f)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--quick", action="store_true",
                    help="2 files x 60 s, clean+3 conditions (smoke)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--mel-precision", default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--upload-codec", default="auto",
                    choices=["auto", "pcm16", "mulaw8", "adpcm4"],
                    help="the fused pipeline's upload wire (engine.upload_codec; "
                         "\"auto\" is pcm16 on the card, mulaw8 on the JAX "
                         "package's TPU, decimated to 16 kHz there: pass mulaw8 "
                         "to hold a TPU record like with like)")
    ap.add_argument("--cache-dir", default=None,
                    help="save per-condition score grids (npz) here so "
                         "--rescore can recompute metrics without the card")
    ap.add_argument("--rescore", default=None, metavar="CACHE_DIR",
                    help="skip detection; recompute all metrics host-side "
                         "from a --cache-dir produced by a previous run")
    ap.add_argument("--no-postfilter-ab", action="store_true",
                    help="skip the per-condition music-postfilter A/B")
    ap.add_argument("--postfilter-threshold", type=float, default=None,
                    help="music-filter threshold for the A/B (default: "
                         "engine/postfilter.DEFAULT_THRESHOLD)")
    add_device_arg(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    launches0 = dict(KERNEL_LAUNCHES)

    n_files, seconds = args.files, args.seconds
    conditions = CONDITIONS
    if args.quick:
        n_files, seconds = 2, 60.0
        conditions = QUICK_CONDITIONS
        if args.out == DEFAULT_OUT:
            # the smoke run never takes the full grid's place
            args.out = os.path.join(tempfile.gettempdir(), "quality_grid_quick.json")
    args.out = resolve_out(args.out)

    cfg = Config().with_engine(mel_precision=args.mel_precision,
                               upload_codec=args.upload_codec)
    det = None
    if args.rescore is None:
        det = Detector(cfg, checkpoint_path=args.ckpt, device=args.device)
        if getattr(det, "epoch", -1) < 0:
            raise SystemExit(
                f"checkpoint {args.ckpt} did not load (epoch<0) — refusing "
                "to run the grid on random init")
        wire = _i16_kind(det) if det.pipeline == "fused" else "none (host decode)"
        print(f"detector: {det.pipeline} pipeline, mel kernel {det.mel_kernel} "
              f"({det.mel_mode}), wire {wire}, {det.device}, epoch {det.epoch}",
              flush=True)
    pad = cfg.engine.pad_seconds

    out = {
        "round": 4,
        "transfer_risk": (
            "Both eval generators are synthetic; neither proves performance "
            "on real field audio. Reverberation (eval-independent "
            "image-source RIR conditions) and time-varying channels "
            "(slow-fading) are in the grid. Remaining unbounded axes: real "
            "speech phonotactics, real weather (wind buffeting the mic "
            "element), overlapping speakers."),
        "postfilter_ab": (
            "parity_postfilter per condition is the full-grid on-vs-off "
            "A/B of the music post-filter."),
        # inside the checkout, relative to its root: the record names the
        # weights, not the machine it ran on
        "checkpoint": repo_relative(args.ckpt),
        "operating_points": {
            "parity": PARITY,
            "tuned": dict(TUNED, note="merge 0.3 s selected on seed-77 v1 "
                                      "tuning set in round 2"),
        },
        "eval": {"n_files": n_files, "seconds": seconds, "iou": 0.5,
                 "min_len": 0.1},
        "generators": {
            "v1": "train/synth.py — SAME family the checkpoint was trained "
                  "on (in-family)",
            "v2": "train/synth2.py — independently-written DSP "
                  "(LF glottal source, cascade moving formants, OU-field "
                  "textures, plan-derived labels); OUT-OF-FAMILY",
        },
        "conditions": {},
    }

    if args.cache_dir:
        _check_cache_dir(args.cache_dir, {
            "ckpt": os.path.abspath(args.ckpt),
            "weights": det.weights_digest() if det is not None else "rescore",
            "files": n_files, "seconds": seconds,
            "mel_precision": args.mel_precision,
            "pipeline": det.pipeline if det is not None else "rescore",
            "upload_codec": args.upload_codec})

    base = args.workdir or tempfile.mkdtemp(prefix="quality_grid_")
    threshold = (args.postfilter_threshold if args.postfilter_threshold is not None
                 else PF.DEFAULT_THRESHOLD)
    t_all = time.time()
    for gen in ("v1", "v2"):
        for ci, (cname, kw) in enumerate(conditions):
            tag = f"{gen}_{cname}"
            if args.rescore is not None:
                cache = os.path.join(args.rescore, f"{tag}.npz")
                if not os.path.exists(cache):
                    print(f"{tag}: no cache at {cache}, skipping", flush=True)
                    continue
                t0 = time.time()
                per_file = load_cache(cache)
                result = metrics_from(per_file, pad)
                result["rescore_seconds"] = round(time.time() - t0, 1)
            else:
                cache = (os.path.join(args.cache_dir, f"{tag}.npz")
                         if args.cache_dir else None)
                if cache and os.path.exists(cache):
                    # restartability: completed conditions are not re-run
                    print(f"{tag}: reusing cached score grids ({cache})", flush=True)
                    per_file = load_cache(cache)
                    result = metrics_from(per_file, pad)
                    result["from_cache"] = True
                else:
                    d = os.path.join(base, tag)
                    # the same seed per condition across generators; the
                    # index is the condition's place in the list run, as the
                    # JAX script's (so --quick's mulaw takes seed 7002)
                    seed = 7000 + ci
                    t0 = time.time()
                    labels = E.make_eval_set(d, n_files=n_files, seconds=seconds,
                                             seed=seed, generator=gen, **kw)
                    synth_s = time.time() - t0
                    t0 = time.time()
                    per_file = detect_set(det, E.load_labels(labels))
                    if cache:
                        save_cache(cache, per_file)
                    result = metrics_from(per_file, pad)
                    result["synth_seconds"] = round(synth_s, 1)
                    result["detect_seconds"] = round(time.time() - t0, 1)
            if not args.no_postfilter_ab:
                result["parity_postfilter"] = postfilter_parity_metrics(
                    per_file, pad, threshold)
            out["conditions"][tag] = result
            print(f"{tag}: parity frame F1 {result['parity']['frame_f1']} "
                  f"event F1 {result['parity']['event_f1']} "
                  f"(granularity-matched "
                  f"{result['parity']['event_f1_granularity']})", flush=True)

    if args.rescore is not None:
        out["rescored_from"] = os.path.abspath(args.rescore)

    # headline: the worst case over the v2 (out-of-family) conditions
    v2 = {k: v for k, v in out["conditions"].items() if k.startswith("v2_")}
    if not v2:
        raise SystemExit("no v2 conditions scored — refusing to write a "
                         "summary-less grid")
    worst = min(v2.items(), key=lambda kv: kv[1]["parity"]["frame_f1"])
    out["summary"] = {
        "worst_out_of_family": {"condition": worst[0], "parity": worst[1]["parity"]},
        "v2_clean_parity": out["conditions"].get("v2_clean", {}).get("parity"),
        "v1_clean_parity": out["conditions"].get("v1_clean", {}).get("parity"),
        "wall_seconds": round(time.time() - t_all, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    print_launches(launches0)
    return out


if __name__ == "__main__":
    main()
