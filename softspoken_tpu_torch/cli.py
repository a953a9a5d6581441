"""Command line: ``python -m softspoken_tpu_torch detect --files … --out …``.

Runs on the CUDA card by default (``--device cpu`` to run on the CPU).
Prints a JSON report and exits nonzero when any file failed.
"""

from __future__ import annotations

import argparse
import json
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
    report = DetectRunner(det, store, cfg).run([os.path.abspath(f) for f in args.files], cb)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="softspoken_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    d = sub.add_parser("detect", help="run voice detection on audio files")
    d.add_argument("--config", help="JSON config file overriding defaults")
    d.add_argument("--files", nargs="+", required=True, help="WAV files")
    d.add_argument("--out", help="detections CSV (default detections.csv)")
    g = d.add_mutually_exclusive_group()
    g.add_argument("--checkpoint", help="reference .pth checkpoint")
    g.add_argument("--random-init", action="store_true",
                   help="use the deterministic random-init fixture weights")
    d.add_argument("--precision", choices=["fast", "parity"])
    d.add_argument("--device-batch", type=int)
    d.add_argument("--threshold", type=float, help="score threshold (default 0.1)")
    d.add_argument("--break-duration", type=float, help="gap-merge seconds (default 0.5)")
    d.add_argument("--strict-reference", action="store_true",
                   help="reprocess files already in the CSV")
    d.add_argument("--device", help="torch device (default: the CUDA card)")
    d.set_defaults(func=cmd_detect)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    out = args.func(args)
    return 1 if out.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
