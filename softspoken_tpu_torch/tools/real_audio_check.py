"""Real-recorded-audio evidence for a checkpoint: two limited probes.

The port of ``scripts/real_audio_check.py``.  Every other quality number
is synthetic against synthetic; this adds the only real recorded audio at
hand, pygame's bundled example sounds (a house-music loop, an MS-ADPCM
music clip, and four impact/whoosh effects):

  A. **False positives** on speech-free real recordings: each source class
     is looped into a bed (gain-jittered, gapped) and run through the
     detector; every detection is a false fire.
  B. **Recall over real-noise beds**: out-of-family synthetic speech
     (``train/synth2.py``, near-clean) is mixed over the real beds at pinned
     SNRs; frame/event F1 at the parity operating point, scored by
     ``tools.quality_grid``.

The sources are 11 kHz consumer-grade game assets with seconds of unique
material: a texture probe, not field evidence.  The clips are read from
``--data-dir`` (default: the ``examples/data`` directory of an installed
pygame, found without importing it); without them the tool exits non-zero
naming the missing clips and writes nothing.  The beds, the mixes, the RNG
seed (20260819), the rates (22,050 Hz for A, 32,000 Hz for B) and the JSON
keys are the JAX script's; ``backend`` is the port's tag
(``engine/fused.py::backend_tag``).  On the card the detector runs the
fused pipeline with the frame_mel kernel in "highest" mode.

    python -m softspoken_tpu_torch.tools.real_audio_check [--out PATH]
        [--seconds 60] [--files 4] [--snrs 0,5,10,20] [--quick]
        [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import tempfile
import time

import numpy as np

from ..config import Config
from ..engine import Detector
from ..engine import regions as R
from ..engine.fused import backend_tag
from ..io import wavio
from ..io.resample import resample
from ..ops import KERNEL_LAUNCHES
from ..train import evaluate as E
from . import (DEFAULT_CKPT, OUT_DIR, add_device_arg, print_launches, repo_relative,
               resolve_out)
from . import quality_grid as QG

SEED = 20260819
FP_SR, RECALL_SR = 22050, 32000
SOURCES = {
    # class → files (relative to the data directory)
    "music_house": ["house_lo.wav"],
    "music_adpcm": ["secosmic_lo.wav"],
    "impacts": ["boom.wav", "car_door.wav", "punch.wav", "whiff.wav"],
}
DEFAULT_OUT = os.path.join(OUT_DIR, "QUALITY_torch_realaudio.json")


def pygame_data_dir():
    """pygame's ``examples/data`` directory when pygame is installed (found
    from its import spec, without importing it), else None."""
    try:
        spec = importlib.util.find_spec("pygame")
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.origin:
        return None
    return os.path.join(os.path.dirname(spec.origin), "examples", "data")


def missing_clips(data_dir) -> list:
    """The clips of ``SOURCES`` that ``data_dir`` lacks (all of them when it
    is None or not a directory)."""
    names = [n for files in SOURCES.values() for n in files]
    if not data_dir or not os.path.isdir(data_dir):
        return names
    return [n for n in names if not os.path.isfile(os.path.join(data_dir, n))]


def _load_sources(data_dir, sr):
    """class → list of float32 clips at ``sr`` (the port's decode and
    resampler, which equal the JAX package's)."""
    out = {}
    for cls, names in SOURCES.items():
        clips = []
        for n in names:
            x, native = wavio.read(os.path.join(data_dir, n))
            clips.append(resample(np.asarray(x, np.float32), native, sr).astype(np.float32))
        out[cls] = clips
    return out


def make_bed(clips, seconds, sr, rng, peak=0.5):
    """Loop clips into a bed: random order, ±6 dB per repeat, 0.2–1 s gaps."""
    total = int(seconds * sr)
    bed = np.zeros(total, np.float32)
    pos = 0
    while pos < total:
        c = clips[int(rng.integers(len(clips)))]
        g = 10.0 ** (rng.uniform(-6.0, 6.0) / 20.0)
        seg = c * np.float32(g)
        n = min(len(seg), total - pos)
        bed[pos:pos + n] += seg[:n]
        pos += n + int(rng.uniform(0.2, 1.0) * sr)
    m = float(np.abs(bed).max())
    if m > 0:
        bed *= np.float32(peak / m)
    return bed


def fp_probe(det, data_dir, seconds, workdir, rng):
    """Part A: the detector over speech-free real-audio beds."""
    sources = _load_sources(data_dir, FP_SR)
    results = {}
    for cls, clips in sources.items():
        bed = make_bed(clips, seconds, FP_SR, rng)
        path = os.path.join(workdir, f"fp_{cls}.wav")
        wavio.write(path, bed, FP_SR, subtype="PCM_16")
        res = det.detect_file_streaming(path)
        avg = np.asarray(res.avg_values, np.float32)
        dur = float(res.audio_seconds)
        pred = [(max(0.0, s), min(dur, e)) for s, e in res.intervals if e > 0 and s < dur]
        pred = R.filter_min_length(pred, 0.1)
        det_s = sum(e - s for s, e in pred)
        results[cls] = {
            "bed_seconds": round(dur, 1),
            "false_events": len(pred),
            "false_events_per_min": round(len(pred) / (dur / 60.0), 2),
            "false_seconds": round(det_s, 2),
            "false_fraction": round(det_s / dur, 4),
            "grid_max": round(float(avg.max()), 4),
            "grid_frac_above_thr": round(float((avg > det.cfg.engine.threshold).mean()), 4),
        }
        print(f"  fp {cls}: {results[cls]}", flush=True)
    return results


def recall_probe(det, data_dir, n_files, seconds, snrs, pad, workdir, rng):
    """Part B: out-of-family speech mixed over real beds at pinned SNRs."""
    sources = _load_sources(data_dir, RECALL_SR)
    all_clips = [c for clips in sources.values() for c in clips]

    # near-clean out-of-family speech (v2 generator, high SNR so the
    # synthetic noise field is negligible next to the real bed)
    clean_dir = os.path.join(workdir, "v2_clean30")
    labels = E.make_eval_set(clean_dir, n_files=n_files, seconds=seconds, sr=RECALL_SR,
                             seed=7100, generator="v2", snr_db=(30.0, 30.0))
    labeled = E.load_labels(labels)

    out = {}
    for snr in snrs:
        mixdir = os.path.join(workdir, f"mix_snr{snr:g}")
        os.makedirs(mixdir, exist_ok=True)
        mixed = []
        for path, truth in labeled:
            x, file_sr = wavio.read(path)
            if file_sr != RECALL_SR:
                raise RuntimeError(f"{path}: {file_sr} Hz, expected {RECALL_SR}")
            bed = make_bed(all_clips, len(x) / RECALL_SR + 1.0, RECALL_SR, rng, peak=0.9)
            bed = bed[:len(x)]
            # speech level measured over the labeled speech spans
            mask = np.zeros(len(x), bool)
            for s, e in truth:
                mask[int(s * RECALL_SR):int(e * RECALL_SR)] = True
            sp = float(np.sqrt(np.mean(np.square(x[mask])))) if mask.any() else 0.0
            bd = float(np.sqrt(np.mean(np.square(bed)))) or 1.0
            want_bed = sp / (10.0 ** (snr / 20.0))
            mix = x + bed * np.float32(want_bed / bd)
            m = float(np.abs(mix).max())
            if m > 1.0:
                mix /= np.float32(m * 1.001)
            dst = os.path.join(mixdir, os.path.basename(path))
            wavio.write(dst, mix.astype(np.float32), RECALL_SR, subtype="PCM_16")
            mixed.append((dst, truth))
        r = QG.metrics_from(QG.detect_set(det, mixed), pad)
        out[f"snr{snr:g}"] = {"parity": r["parity"], "n_files": r["n_files"]}
        print(f"  recall snr{snr:g}: frame_f1={r['parity']['frame_f1']} "
              f"event_f1={r['parity']['event_f1']}", flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--snrs", default="0,5,10,20")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--quick", action="store_true", help="1 file x 30 s, one SNR (smoke)")
    ap.add_argument("--music-filter", type=float, default=None,
                    help="run with engine.music_filter at this threshold "
                         "(engine/postfilter.py); default off")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--data-dir", default=None,
                    help="directory holding the clips of SOURCES (default: "
                         "pygame's examples/data)")
    add_device_arg(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    launches0 = dict(KERNEL_LAUNCHES)

    snrs = [float(s) for s in args.snrs.split(",") if s]
    if args.quick:
        args.seconds, args.files, snrs = 30.0, 1, [10.0]
        if args.out == DEFAULT_OUT:
            # the smoke run never takes the full probe's place
            args.out = os.path.join(tempfile.gettempdir(), "real_audio_quick.json")
    args.out = resolve_out(args.out)

    data_dir = args.data_dir or pygame_data_dir()
    missing = missing_clips(data_dir)
    if missing:
        raise SystemExit(f"real-audio clips missing from {data_dir or '(no pygame)'}: "
                         f"{', '.join(missing)}; pass --data-dir with pygame's "
                         "examples/data")

    cfg = Config().with_engine(mel_precision="highest")
    if args.music_filter is not None:
        cfg = cfg.with_engine(music_filter=args.music_filter)
    det = Detector(cfg, checkpoint_path=args.ckpt, device=args.device)
    if getattr(det, "epoch", -1) < 0:
        raise SystemExit(f"checkpoint {args.ckpt} did not load (epoch<0)")
    pad = cfg.engine.pad_seconds

    workdir = args.workdir or tempfile.mkdtemp(prefix="real_audio_")
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    print("Part A: false positives on speech-free real beds", flush=True)
    fp = fp_probe(det, data_dir, args.seconds, workdir, rng)
    print("Part B: recall over real-noise beds", flush=True)
    rec = recall_probe(det, data_dir, args.files, args.seconds, snrs, pad, workdir, rng)
    out = {
        "checkpoint": repo_relative(args.ckpt),
        "epoch": int(det.epoch),
        "backend": backend_tag(det.device),
        "sources": "pygame 2.6.1 bundled example sounds (11 kHz consumer "
                   "game assets; real recordings, NOT field audio)",
        "operating_point": {"threshold": cfg.engine.threshold,
                            "break_duration": cfg.engine.break_duration,
                            "min_len": 0.1,
                            "music_filter": cfg.engine.music_filter},
        "false_positives_on_real_audio": fp,
        "recall_over_real_noise_beds": rec,
        "caveats": [
            "sources are bandlimited (~5.5 kHz) and loop seconds of unique "
            "material — a texture probe, not sim-to-real evidence",
            "music is intentionally adversarial: broadband rhythmic "
            "content is the classic speech-detector confuser",
        ],
        "wall_seconds": round(time.time() - t0, 1),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out} in {out['wall_seconds']} s", flush=True)
    print_launches(launches0)
    return out


if __name__ == "__main__":
    main()
