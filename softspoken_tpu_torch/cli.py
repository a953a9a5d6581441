"""Command line: ``python -m softspoken_tpu_torch detect --files … --out …``
and ``python -m softspoken_tpu_torch train --synthetic --steps N --out model.pth``.

Runs on the CUDA card by default (``--device cpu`` to run on the CPU), with
the trained weights of ``root/models/spec_unet_2d/model_checkpoint.pth``
unless ``--checkpoint`` or ``--random-init`` says otherwise.  Reads WAV
(RF64, RIFX, G.711, ADPCM), FLAC, AIFF/AIFC, W64, CAF, AU and SPHERE; an
MP3, Ogg Vorbis or Opus file is recorded as an error naming its format.
The pipeline, mel kernel and resampler are chosen in the ``--config`` JSON
(``{"engine": {"pipeline": "host", "mel_kernel": "pallas"}}``), as with the
JAX package's CLI.  Prints a JSON report and exits nonzero when any file
failed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

from .config import Config


def _load_config(args) -> Config:
    cfg = Config.from_file(args.config) if args.config else Config()
    if args.precision:
        cfg = cfg.with_engine(precision=args.precision)
    if args.device_batch:
        cfg = cfg.with_engine(device_batch=args.device_batch)
    if args.threshold is not None:
        cfg = cfg.with_engine(threshold=args.threshold)
    if args.break_duration is not None:
        cfg = cfg.with_engine(break_duration=args.break_duration)
    if args.strict_reference:
        cfg = cfg.with_engine(skip_processed_files=False)
    return cfg


def cmd_detect(args) -> Dict:
    from .ckpt import fixture_state_dict
    from .engine import Detector
    from .project import DetectionStore
    from .runtime import DetectRunner, RunCallbacks

    cfg = _load_config(args)
    sd = fixture_state_dict(seed=0) if args.random_init else None
    det = Detector(cfg, state_dict=sd, checkpoint_path=args.checkpoint, device=args.device)
    store_path = args.out or "detections.csv"
    store = DetectionStore(store_path)
    cb = RunCallbacks(
        file_started=lambda f: print(f"→ {f}", flush=True),
        message=lambda m: print(f"   {m}", flush=True),
    )
    runner = DetectRunner(det, store, cfg, streaming=args.streaming or None)
    report = runner.run([os.path.abspath(f) for f in args.files], cb)
    out = {
        "files_done": report.files_done,
        "files_skipped": report.files_skipped,
        "rows_added": report.rows_added,
        "errors": report.errors,
        **report.throughput,
        "stage_seconds": report.timers,
        "detections_csv": store_path,
        "device": str(det.device),
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


def cmd_train(args) -> Dict:
    from .train import fit_synthetic

    if args.mesh:
        raise NotImplementedError(
            "train --mesh (multi-GPU) is not ported to softspoken_tpu_torch yet "
            "(ROADMAP.md §1, multi-GPU and the sharded steps)")
    if not args.synthetic:
        if args.speech_dir or args.noise_dir:
            raise NotImplementedError(
                "train --speech-dir/--noise-dir (the host trainer `fit`, "
                "train/data.py) is not ported to softspoken_tpu_torch yet "
                "(ROADMAP.md §1, the host trainer)")
        raise SystemExit("train: only --synthetic is ported "
                         "(the host trainer is not, see ROADMAP.md)")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    metrics = fit_synthetic(
        steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        ckpt_out=args.out,
        augmentations=args.augment,
        seed=args.seed,
        n_inner=args.n_inner,
        pool_speech=args.pool_size,
        pool_noise=args.pool_size,
        resume=args.resume,
        train_dtype=args.dtype,
        noise_extra_kinds=tuple(args.noise_extra or ()),
        noise_extra_frac=args.noise_extra_frac,
        noise_extra_policy=args.noise_extra_policy,
        noise_extra_snr_range=(args.noise_extra_snr_min, args.noise_extra_snr_max),
        noise_extra_silent_prob=args.noise_extra_silent_prob,
        boundary_weight=args.boundary_weight,
        snr_db_range=(args.snr_min, args.snr_max),
        stall_abort_s=args.stall_abort,
        device=args.device,
    )
    print(json.dumps(metrics), flush=True)
    return metrics


def _add_train_parser(sub) -> None:
    """The JAX CLI's ``train`` flags; ``--out`` and ``--resume`` are .pth."""
    pt = sub.add_parser("train", help="train SpecUNet_2D (--synthetic)")
    pt.add_argument("--speech-dir", help="clean-speech WAVs (not ported yet)")
    pt.add_argument("--noise-dir", help="environment WAVs (not ported yet)")
    pt.add_argument("--synthetic", action="store_true",
                    help="train from the synthetic corpus with fully on-device "
                         "batch synthesis (train/synth.py + device_data.py)")
    pt.add_argument("--steps", type=int, default=1000)
    pt.add_argument("--batch-size", type=int, default=16)
    pt.add_argument("--n-inner", type=int, default=10,
                    help="optimizer steps per outer iteration (one metrics read each)")
    pt.add_argument("--pool-size", type=int, default=768,
                    help="device-resident clips per pool")
    pt.add_argument("--lr", type=float, default=1e-3)
    pt.add_argument("--out", help="checkpoint output (.pth)")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--augment", nargs="*", default=["add_reverb", "reduce_volume"])
    pt.add_argument("--mesh", action="store_true", help="multi-GPU (not ported yet)")
    pt.add_argument("--noise-extra", nargs="*", default=[],
                    choices=["music", "granular", "drone", "impact_chain", "crackle"],
                    help="opt-in confuser textures mixed into the noise pool "
                         "(synth.EXTRA_ENVIRONMENT_KINDS)")
    pt.add_argument("--snr-min", type=float, default=-5.0,
                    help="training mix SNR floor in dB")
    pt.add_argument("--snr-max", type=float, default=20.0)
    pt.add_argument("--noise-extra-frac", type=float, default=0.2,
                    help="fraction of the noise pool drawn from --noise-extra kinds")
    pt.add_argument("--noise-extra-policy", default="mixed", choices=["mixed", "protected"],
                    help="'mixed': extras behave like any other noise clip. "
                         "'protected': extras appear as pure negatives on silent "
                         "rows and only at --noise-extra-snr-min..max dB under speech")
    pt.add_argument("--noise-extra-snr-min", type=float, default=10.0,
                    help="(protected policy) SNR floor in dB for extras under speech")
    pt.add_argument("--noise-extra-snr-max", type=float, default=20.0)
    pt.add_argument("--noise-extra-silent-prob", type=float, default=0.5,
                    help="(protected policy) probability a silent row draws its "
                         "noise from the extras region")
    pt.add_argument("--boundary-weight", type=float, default=0.0,
                    help="extra BCE weight within ~47 ms of speech onsets/offsets "
                         "(mean-normalized; 0 = off)")
    pt.add_argument("--stall-abort", type=float, default=900.0,
                    help="abort with exit code 86 when no training step completes "
                         "for this many seconds; 0 disables")
    pt.add_argument("--resume", metavar="CKPT",
                    help="warm-start weights, BN statistics and the step counter "
                         "from a .pth")
    pt.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="forward/backward compute dtype (params and optimizer "
                         "stay float32)")
    pt.add_argument("--device", help="torch device (default: the CUDA card)")
    pt.set_defaults(func=cmd_train)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="softspoken_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("detect", help="run voice detection on audio files")
    d.add_argument("--config", help="JSON config file overriding defaults")
    d.add_argument("--files", nargs="+", required=True,
                   help="audio files (WAV, FLAC, AIFF, W64, CAF, AU, SPHERE)")
    d.add_argument("--out", help="detections CSV (default detections.csv)")
    g = d.add_mutually_exclusive_group()
    g.add_argument("--checkpoint", help="reference .pth checkpoint (default: the "
                   "trained root/models/spec_unet_2d/model_checkpoint.pth)")
    g.add_argument("--random-init", action="store_true",
                   help="use the deterministic random-init fixture weights")
    d.add_argument("--precision", choices=["fast", "parity"])
    d.add_argument("--device-batch", type=int)
    d.add_argument("--threshold", type=float, help="score threshold (default 0.1)")
    d.add_argument("--break-duration", type=float, help="gap-merge seconds (default 0.5)")
    d.add_argument("--strict-reference", action="store_true",
                   help="reprocess files already in the CSV")
    d.add_argument("--streaming", action="store_true",
                   help="force bounded-memory streaming decode")
    d.add_argument("--device", help="torch device (default: the CUDA card)")
    d.set_defaults(func=cmd_detect)
    _add_train_parser(sub)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out = args.func(args)
    return 1 if out.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
