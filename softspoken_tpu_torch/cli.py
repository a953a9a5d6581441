"""Command line: the detect-review-silence workflow and the trainer.

    python -m softspoken_tpu_torch [--project-dir P] [--config c.json]
                                   [-v] [--log-json] <command>

  project new|list|status|add-files|remove-files
  detect        — voice detection over a project (or ad-hoc ``--files``)
  review        — list/grade/keep/erase/add/delete detections, re-run the
                  exporters, render a spectrogram PNG, export a segment WAV
  silence       — mute the erased intervals and write *_silenced.wav
  train         — ``train --synthetic --steps N --out model.pth``, or from
                  WAV directories: ``train --speech-dir S --noise-dir N``
  eval          — F1 of the detector on labeled audio (``--make-synthetic
                  DIR`` synthesizes a labeled eval set first)
  doctor        — one JSON report of the environment: the card, the
                  kernels' build, the native libraries, the checkpoint
  bench         — one JSON line: the 30-minute WAV's audio-s/wall-s on the
                  card, the device-only rate and MFU against the card's
                  dense bf16 peak
  gui           — the Qt desktop app (PySide6, or ``--smoke`` under the
                  headless shim)

The JAX package's commands and flags.  ``detect`` and ``eval`` run on the
CUDA card by default (``--device cpu`` to run on the CPU; so do ``train``,
``bench`` and ``gui``), with the trained
weights of ``root/models/spec_unet_2d/model_checkpoint.pth`` unless
``--checkpoint`` (``eval --ckpt``) or ``--random-init`` says otherwise.
They read WAV (RF64, RIFX, G.711, ADPCM), FLAC, AIFF/AIFC, W64, CAF, AU
and SPHERE, and MP3, Ogg Vorbis and Opus where the system libraries load.
The pipeline, mel kernel and
resampler are chosen in the ``--config`` JSON (``{"engine": {"pipeline":
"host", "mel_kernel": "pallas"}}``).  ``detect`` and ``silence`` print a
JSON report and exit nonzero when any file failed; ``doctor`` exits nonzero
when a probe failed.

Multi-card: ``detect --mesh`` shards each batch's windows over every
visible card in one process; ``detect --distributed`` runs one process per
card (``torch.distributed``: ``--coordinator/--num-processes/--process-id``,
or ``torchrun --nproc-per-node N -m softspoken_tpu_torch detect ...
--distributed``), each on its round-robin share of the files, and
``project merge-detections`` gathers their stores; ``train --mesh`` trains
over every visible card as ``data × seq`` parallelism, one process per card
(started here, or by ``torchrun``).  With ``--device cpu`` they run on the
CPU over gloo.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional

from .config import Config


def _load_config(args) -> Config:
    cfg = Config.from_file(args.config) if getattr(args, "config", None) else Config()
    if getattr(args, "project_dir", None):
        cfg = cfg.with_paths(project_dir=args.project_dir)
    if getattr(args, "precision", None):
        cfg = cfg.with_engine(precision=args.precision)
    if getattr(args, "device_batch", None):
        cfg = cfg.with_engine(device_batch=args.device_batch)
    if getattr(args, "threshold", None) is not None:
        cfg = cfg.with_engine(threshold=args.threshold)
    if getattr(args, "break_duration", None) is not None:
        cfg = cfg.with_engine(break_duration=args.break_duration)
    if getattr(args, "exit_threshold", None) is not None:
        cfg = cfg.with_engine(exit_threshold=args.exit_threshold)
    if getattr(args, "grid_smooth", None) is not None:
        cfg = cfg.with_engine(grid_smooth=args.grid_smooth)
    if getattr(args, "music_filter", None) is not None:
        from .engine import postfilter

        thr = args.music_filter  # a bare --music-filter is -1: the default
        cfg = cfg.with_engine(
            music_filter=postfilter.DEFAULT_THRESHOLD if thr < 0 else thr)
    if getattr(args, "strict_reference", False):
        cfg = cfg.with_engine(skip_processed_files=False)
    if getattr(args, "chunk_checkpoint", None):
        cfg = cfg.with_engine(chunk_checkpoint_every=args.chunk_checkpoint)
    if getattr(args, "file_concurrency", None):
        cfg = cfg.with_engine(file_concurrency=args.file_concurrency)
    return cfg


def _manager(cfg: Config):
    from .project import ProjectManager

    return ProjectManager(cfg)


def _active_project(pm, name: Optional[str]):
    if name:
        proj = pm.set_active_project(name)
        if proj is None:
            sys.exit(f"error: no project named '{name}'")
        return proj
    if not pm.activate_latest():
        sys.exit("error: no projects exist; create one with `project new <name>`")
    return pm.current_project


# ---------------------------------------------------------------------------
# project
# ---------------------------------------------------------------------------

def cmd_project(args) -> None:
    cfg = _load_config(args)
    pm = _manager(cfg)
    # the optional positional `name` precedes `files`: argparse binds the
    # FIRST audio file as the project name when the user means the default
    # project.  If `name` is an existing path and not an existing project,
    # treat it as a file.
    if args.action in ("add-files", "remove-files") and args.name:
        known = {p["name"] for p in pm.projects_data}
        if args.name not in known and os.path.exists(args.name):
            args.files = [args.name] + list(args.files)
            args.name = None
    if args.action == "new":
        if not args.name:
            raise SystemExit("error: `project new` requires a project name")
        pm.add_project(args.name)
        print(f"created project '{args.name}' under {pm.project_output_dir(args.name)}")
        if args.files:
            # `project new name f1.wav f2.wav` registers the trailing files
            # like add-files
            pm.set_active_project(args.name)
            merged = pm.update_file_list([os.path.abspath(f) for f in args.files])
            print(f"{len(merged)} file(s) registered")
    elif args.action == "list":
        for p in pm.projects_data:
            print(f"{p['name']}\t(last accessed {p.get('last_accessed', '?')})")
    elif args.action == "status":
        proj = _active_project(pm, args.name)
        print(json.dumps({"project": proj["name"], **pm.step_status()}, indent=2))
    elif args.action == "add-files":
        _active_project(pm, args.name)
        files = [os.path.abspath(f) for f in args.files]
        merged = pm.update_file_list(files)
        print(f"{len(merged)} file(s) registered")
    elif args.action == "remove-files":
        _active_project(pm, args.name)
        remaining = pm.remove_from_file_list([os.path.abspath(f) for f in args.files])
        print(f"{len(remaining)} file(s) remain")
    elif args.action == "merge-detections":
        from .parallel import merge_partition_stores

        proj = _active_project(pm, args.name)
        print(json.dumps(merge_partition_stores(proj["detections_file"])))


# ---------------------------------------------------------------------------
# detect
# ---------------------------------------------------------------------------

def cmd_detect(args) -> Dict:
    cfg = _load_config(args)
    device = args.device
    joined = False
    if args.distributed:
        from .parallel import init_distributed

        dev = init_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=args.device)
        joined = dev is not None
        device = dev if joined else device
    try:
        return _detect(args, cfg, device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _detect(args, cfg, device) -> Dict:
    """``detect`` in the JAX order: the detector, the file list, this
    process's partition and store (``--distributed``), the mesh wrap
    (``--mesh``), then the run."""
    from .ckpt import fixture_state_dict
    from .engine import Detector
    from .project import DetectionStore
    from .runtime import DetectRunner, RunCallbacks

    sd = fixture_state_dict(seed=0) if args.random_init else None
    det = Detector(cfg, state_dict=sd, checkpoint_path=args.checkpoint, device=device)
    if args.files:
        files = [os.path.abspath(f) for f in args.files]
        store_path = args.out or "detections.csv"
    else:
        pm = _manager(cfg)
        proj = _active_project(pm, args.project)
        files = pm.get_unprocessed_list()
        store_path = proj["detections_file"]
    if args.distributed:
        from .parallel import distributed as pdist

        files = pdist.partition_files(files, args.process_id, args.num_processes)
        # one store per process: detections gather through the filesystem
        # (project merge-detections), one writer per file
        pid = args.process_id if args.process_id is not None else pdist.process_index()
        if pid or (args.num_processes or pdist.process_count()) > 1:
            base, ext = os.path.splitext(store_path)
            store_path = f"{base}.p{pid}{ext}"
    store = DetectionStore(store_path)
    if args.mesh:
        from .parallel import MeshDetector, make_mesh

        # every visible card; a CPU detector gets a one-entry CPU mesh
        cpu = det.device.type == "cpu"
        det = MeshDetector(det, make_mesh(("data",), devices=[det.device] if cpu else None))
    cb = RunCallbacks(
        file_started=lambda f: print(f"→ {f}", flush=True),
        message=lambda m: print(f"   {m}", flush=True),
    )
    runner = DetectRunner(det, store, cfg, streaming=args.streaming or None)
    report = runner.run(files, cb)
    out = {
        "files_done": report.files_done,
        "files_skipped": report.files_skipped,
        "rows_added": report.rows_added,
        "errors": report.errors,
        **report.throughput,
        "stage_seconds": report.timers,
        "counts": report.counts,
        "detections_csv": store_path,
        "device": str(det.device),
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


# ---------------------------------------------------------------------------
# review
# ---------------------------------------------------------------------------

def cmd_review(args) -> None:
    from .ui import ReviewSession, export_segment_wav, render_review_png

    cfg = _load_config(args)
    pm = _manager(cfg)
    proj = _active_project(pm, args.project)
    session = ReviewSession(proj, pm.projects_folder, cfg)

    if args.action == "list":
        for i, r in enumerate(session.rows):
            # float-formatted strings ('1.0') from Excel/pandas round
            # trips crash int(); coerce leniently like stats() does
            try:
                erased = float(r.get("erase", 0) or 0) == 1.0
            except (TypeError, ValueError):
                erased = False
            mark = "E" if erased else (
                "K" if str(r.get("review_datetime", "")).strip() else "."
            )
            print(
                f"{i:5d} [{mark}] #{r['ID']} {r['file_name']} "
                f"{float(r['start_time']):9.3f}–{float(r['end_time']):9.3f} "
                f"{r.get('user_comment', '')}"
            )
        print(json.dumps(session.stats()))
    elif args.action in ("keep", "erase"):
        for i in args.rows:
            getattr(session, args.action)(index=i, persist=False)
        session.save()
        print(json.dumps(session.stats()))
    elif args.action == "add":
        if not args.file or args.start is None or args.end is None:
            raise SystemExit(
                "review add: --file, --start and --end are all required"
            )
        pos = session.add(
            os.path.dirname(os.path.abspath(args.file)),
            os.path.basename(args.file),
            args.start,
            args.end,
        )
        print(f"inserted at row {pos}" if pos is not None else "rejected (end ≤ start)")
    elif args.action == "delete":
        session.delete(args.rows)
        print(json.dumps(session.stats()))
    elif args.action == "export":
        session.save()  # persists review.csv + all three exporters
        print(f"review saved + exports re-run under {pm.projects_folder}")
    elif args.action == "grade":
        _grade_loop(session, args)
    elif args.action == "render":
        r = session.rows[args.row]
        full = os.path.join(r["file_path"], r["file_name"])
        others = [
            (float(q["start_time"]), float(q["end_time"]))
            for q in session.rows if q["file_name"] == r["file_name"]
        ]
        png = render_review_png(
            full, float(r["start_time"]), float(r["end_time"]), others,
            zoom_level=args.zoom, config=cfg,
        )
        out = args.out or f"detection_{int(r['ID'])}.png"
        with open(out, "wb") as f:
            f.write(png)
        print(out)
    elif args.action == "segment":
        r = session.rows[args.row]
        full = os.path.join(r["file_path"], r["file_name"])
        out = export_segment_wav(
            full, (float(r["start_time"]), float(r["end_time"])), args.out, cfg
        )
        print(out)


def _grade_loop(session, args) -> None:
    """Interactive terminal grading: the review screen's Keep/Erase flow
    (review_detections.py:677-717) over stdin.  [k]eep [e]rase [s]kip
    [p]lay [r]ender [b]ack [q]uit."""
    from .ui import export_segment_wav, play_segment, render_review_png

    while session.current() is not None:
        row = session.current()
        total = len(session)
        reviewed = "✓" if str(row.get("review_datetime", "")).strip() else " "
        print(
            f"\n[{session.current_index + 1}/{total}]{reviewed} #{row['ID']} "
            f"{row['file_name']}  {float(row['start_time']):.3f}–"
            f"{float(row['end_time']):.3f}s  erase={row['erase']}"
        )
        try:
            cmd = input("  [k]eep [e]rase [s]kip [p]lay [r]ender [b]ack [q]uit > ").strip().lower()
        except EOFError:
            break
        full = os.path.join(row["file_path"], row["file_name"])
        idx_before = session.current_index
        if cmd == "k":
            session.keep()
        elif cmd == "e":
            session.erase()
        elif cmd == "s":
            session.next()
        elif cmd == "b":
            session.prev()
        elif cmd == "p":
            seg = (max(0.0, float(row["start_time"])), float(row["end_time"]))
            # session.cfg carries the CLI --config, as `review render/segment`
            if not play_segment(full, seg, config=session.cfg):
                out = export_segment_wav(full, seg, config=session.cfg)
                print(f"  (no audio device; segment written to {out})")
        elif cmd == "r":
            png = render_review_png(
                full, float(row["start_time"]), float(row["end_time"]),
                zoom_level=args.zoom, config=session.cfg,
            )
            out = f"detection_{int(row['ID'])}.png"
            with open(out, "wb") as f:
                f.write(png)
            print(f"  rendered {out}")
        elif cmd == "q":
            break
        # done only when the LAST row itself was just graded/skipped
        # (advancing TO the last row must still display it)
        if idx_before >= total - 1 and cmd in ("k", "e", "s"):
            print("  (end of detections)")
            break
    print(json.dumps(session.stats()))


# ---------------------------------------------------------------------------
# silence
# ---------------------------------------------------------------------------

def cmd_silence(args) -> Dict:
    from .project import read_csv
    from .silence import SilenceRunner, write_status_file

    cfg = _load_config(args)
    pm = _manager(cfg)
    proj = _active_project(pm, args.project)
    review_path = proj["review_file"]
    if not os.path.exists(review_path):
        sys.exit(f"error: no review file at {review_path}; run review first")
    table = read_csv(review_path)  # pandas' default NA handling, as the JAX CLI

    runner = SilenceRunner(args.output_dir, fade_ms=args.fade_ms, subtype=args.subtype)
    report = runner.run(
        table,
        on_file_start=lambda f: print(f"→ {f}", flush=True),
        on_file_done=lambda f: print(f"   wrote {f}", flush=True),
    )
    if not report.stopped:
        write_status_file(proj, pm.project_output_dir(proj["name"]))
        pm.save_current_project()
    out = {
        "files_done": report.files_done,
        "files_failed": report.files_failed,
        "outputs": report.outputs,
        "errors": report.errors,
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

def cmd_eval(args) -> None:
    from .engine import Detector
    from .train import evaluate as E

    if args.make_synthetic:
        labels = E.make_eval_set(
            args.make_synthetic, n_files=args.eval_files,
            seconds=args.eval_seconds, seed=args.seed,
            generator=args.generator,
            snr_db=(args.snr, args.snr) if args.snr is not None else None,
            degradations=args.degrade.split(",") if args.degrade else None,
        )
        print(f"synthesized eval set → {labels}", file=sys.stderr)
    else:
        labels = args.labels
    if not labels:
        raise SystemExit("eval: need --labels or --make-synthetic DIR")

    cfg = _load_config(args)  # applies --threshold/--break-duration too
    det = Detector(cfg, checkpoint_path=args.ckpt, device=args.device)
    result = E.evaluate_detector(det, E.load_labels(labels), iou=args.iou)
    print(json.dumps(result), flush=True)


def _add_operating_point_flags(p, music_help: str) -> None:
    """--threshold, --break-duration and the three opt-in operating-point
    flags shared by detect and eval."""
    p.add_argument("--threshold", type=float, help="score threshold (default 0.1)")
    p.add_argument("--break-duration", type=float, help="gap-merge seconds (default 0.5)")
    p.add_argument("--exit-threshold", type=float,
                   help="hysteresis exit level (< --threshold): regions still "
                        "need a bin above the main threshold but extend over "
                        "bins above this (default: off)")
    p.add_argument("--grid-smooth", type=int,
                   help="odd median-smoothing width (bins) applied to the "
                        "averaged grid before thresholding (default: off)")
    p.add_argument("--music-filter", type=float, nargs="?", const=-1.0,
                   metavar="THRESHOLD", help=music_help)


def _add_eval_parser(sub) -> None:
    """The JAX CLI's ``eval`` flags; ``--ckpt`` is a .pth."""
    pe = sub.add_parser("eval", help="score detections vs labeled intervals (F1)")
    pe.add_argument("--labels", help="labels.csv (file,start_time,end_time) or "
                    "Audacity .txt label track(s)")
    pe.add_argument("--make-synthetic", metavar="DIR",
                    help="first synthesize a labeled eval set into DIR")
    pe.add_argument("--eval-files", type=int, default=8)
    pe.add_argument("--eval-seconds", type=float, default=120.0)
    pe.add_argument("--generator", choices=["v1", "v2"], default="v1",
                    help="v1 = training-family synth; v2 = independent "
                         "out-of-family generator (train/synth2.py)")
    pe.add_argument("--snr", type=float,
                    help="pin per-event SNR (dB); default 0-20 dB draws")
    pe.add_argument("--degrade",
                    help="comma list of degradations (train/degrade.py): "
                         "rolloff4k,clip,mulaw,hum,dropout,bfp4,reverb03,"
                         "reverb08,reverb15,fading")
    pe.add_argument("--ckpt", help="checkpoint .pth (default: the trained "
                    "root/models/spec_unet_2d/model_checkpoint.pth)")
    pe.add_argument("--iou", type=float, default=0.5)
    pe.add_argument("--seed", type=int, default=1234)
    _add_operating_point_flags(pe, "music post-filter (see detect --music-filter)")
    pe.add_argument("--device", help="torch device (default: the CUDA card)")
    pe.set_defaults(func=cmd_eval)


def cmd_train(args) -> Optional[Dict]:
    if not args.synthetic and not (args.speech_dir and args.noise_dir):
        raise SystemExit("train: need --speech-dir and --noise-dir "
                         "(or use --synthetic)")
    if args.mesh:
        return _train_mesh(args)
    metrics = _fit(args)
    print(json.dumps(metrics), flush=True)
    return metrics


def _fit(args, mesh=None) -> Dict:
    """The trainer the flags name, on ``args.device`` or over ``mesh``."""
    from .train import fit_synthetic
    from .train.fit import fit

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    if not args.synthetic:
        return fit(
            args.speech_dir,
            args.noise_dir,
            steps=args.steps,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            ckpt_out=args.out,
            augmentations=args.augment,
            seed=args.seed,
            mesh=mesh,
            resume=args.resume,
            train_dtype=args.dtype,
            boundary_weight=args.boundary_weight,
            device=args.device,
        )
    return fit_synthetic(
        steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        ckpt_out=args.out,
        augmentations=args.augment,
        seed=args.seed,
        mesh=mesh,
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


def _train_mesh(args) -> Optional[Dict]:
    """``train --mesh``: one process per card (``--device cpu``: one per
    ``torchrun`` process, else one), as a ``(n // 2, 2)`` ``data × seq``
    mesh when n is even and above 1, else ``(n, 1)`` (the JAX CLI's shape).
    Started as one process it spawns a worker per card; under ``torchrun``
    (``WORLD_SIZE`` set) this process is one rank.  Rank 0 alone writes the
    checkpoint and prints the metrics."""
    import torch

    from .engine.detector import resolve_device
    from .parallel import distributed as pdist

    if "WORLD_SIZE" in os.environ:
        return _mesh_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                          "env://", args)
    if _on_cpu(args):
        n = 1
    else:
        resolve_device(args.device)  # raises without a card
        n = torch.cuda.device_count()
    init_method = f"tcp://localhost:{pdist.free_port()}"
    if n == 1:
        return _mesh_rank(0, 1, init_method, args)
    pdist.spawn(_mesh_rank, n, args=(n, init_method, args))
    return None


def _on_cpu(args) -> bool:
    return args.device is not None and args.device.split(":")[0] == "cpu"


def _mesh_rank(rank: int, n: int, init_method: str, args) -> Optional[Dict]:
    """Rank ``rank`` of ``n`` in ``train --mesh`` (the worker ``spawn``
    runs, too): joins the group, trains its shard, and on rank 0 prints
    the metrics."""
    import torch.distributed as dist

    from .parallel import distributed as pdist
    from .parallel import make_mesh

    seq = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(("data", "seq"), shape=(n // seq, seq),
                     devices=pdist.rank_devices(rank, n, args.device))
    pdist.init_process_group(init_method, n, rank, list(mesh.devices.flat)[rank])
    try:
        metrics = _fit(args, mesh)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    print(json.dumps(metrics), flush=True)
    return metrics


def _add_train_parser(sub) -> None:
    """The JAX CLI's ``train`` flags, plus ``--device``; ``--out`` and
    ``--resume`` are .pth."""
    pt = sub.add_parser("train", help="train SpecUNet_2D")
    pt.add_argument("--speech-dir", help="clean-speech WAVs (omit with --synthetic)")
    pt.add_argument("--noise-dir", help="environment WAVs (omit with --synthetic)")
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
    pt.add_argument("--mesh", action="store_true",
                    help="data × seq parallelism over every visible card, one "
                         "process per card (under torchrun: one rank per process)")
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


# ---------------------------------------------------------------------------
# doctor
# ---------------------------------------------------------------------------

def _probe_device() -> dict:
    """The card's name and capability, and one tiny launch read back."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (softspoken_tpu_torch runs on the card)")
    dev = torch.device("cuda", torch.cuda.current_device())
    got = (torch.arange(4, device=dev) + 1).cpu().tolist()
    if got != [1, 2, 3, 4]:
        raise RuntimeError(f"a launch on the card returned {got}")
    return {"name": torch.cuda.get_device_name(dev),
            "capability": ".".join(map(str, torch.cuda.get_device_capability(dev))),
            "count": torch.cuda.device_count()}


def _probe_kernels() -> dict:
    """Build (one nvcc per source, started together) and load K1, K2 and
    K3 through ops/_build.py, binding each entry point."""
    from concurrent.futures import ThreadPoolExecutor

    from .ops import _build, adpcm, dft_mel, frame_mel

    mods = (frame_mel, dft_mel, adpcm)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        paths = list(ex.map(_build.build, [m.NAME for m in mods]))
    build_s = time.perf_counter() - t0
    for m in mods:
        m._lib()
    return {"built": {m.NAME: os.path.basename(p) for m, p in zip(mods, paths)},
            "build_s": round(build_s, 2)}


def cmd_doctor(args) -> int:
    """Environment diagnosis as one JSON report, every probe bounded.

    The device probes run on watchdog threads (``--device-timeout``), so a
    hung CUDA runtime still gives a report.  A missing card or a kernel
    that does not build is an ERROR status and a nonzero exit code, never a
    quiet switch to the CPU.  A codec library that does not load is the JAX
    package's ``MISSING`` status, not an error.
    """
    import threading

    cfg = _load_config(args)
    report: dict = {}

    def bounded(name, fn, timeout):
        box = {}

        def work():
            try:
                box["value"] = fn()
            except Exception as e:  # noqa: BLE001 — diagnosis, not control
                box["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=work, daemon=True)
        t0 = time.perf_counter()
        th.start()
        th.join(timeout)
        if th.is_alive():
            report[name] = {"status": "TIMEOUT", "after_s": round(timeout, 1)}
            return None
        dt = round(time.perf_counter() - t0, 2)
        if "error" in box:
            report[name] = {"status": "ERROR", "error": box["error"], "s": dt}
            return None
        report[name] = {"status": "ok", "s": dt, **box["value"]}
        return box["value"]

    from .io import flac, native
    from .ops import _build

    report["native_dsp"] = {
        "status": "ok" if native.native_available() else "MISSING (numpy fallbacks active)"}
    report["native_flac"] = {
        "status": "ok" if flac.flac_available() else "MISSING (FLAC undecodable)"}
    from .io import mp3, oggvorbis, opus

    for key, mod, missing in (("libvorbis", oggvorbis, "MISSING (OGG undecodable)"),
                              ("libmpg123", mp3, "MISSING (MP3 undecodable)"),
                              ("libopus", opus, "MISSING (Ogg/Opus undecodable)")):
        try:
            report[key] = {"status": "ok" if mod.available() else missing}
        except Exception as e:  # noqa: BLE001
            report[key] = {"status": f"ERROR: {e}"}
    ckpt_path = os.path.join(cfg.paths.model_dir, cfg.paths.model_name)
    if os.path.isfile(ckpt_path):
        report["checkpoint"] = {"status": "ok", "path": ckpt_path}
    else:
        report["checkpoint"] = {
            "status": "MISSING (detect degrades to random init)", "path": ckpt_path}

    timeout = float(args.device_timeout)
    if bounded("device", _probe_device, timeout) is not None:
        bounded("kernels", _probe_kernels, timeout)
    else:
        report["kernels"] = {"status": "ERROR", "error": "no usable CUDA device"}
    report["native_cache_dir"] = {"status": "ok", "path": _build.BUILD_DIR}
    bad = [k for k, v in report.items() if v.get("status") != "ok"]
    report["summary"] = "all ok" if not bad else "attention: " + ", ".join(sorted(bad))
    print(json.dumps(report, indent=2), flush=True)
    failed = any(v.get("status") in ("ERROR", "TIMEOUT")
                 for k, v in report.items() if k != "summary")
    if any(v.get("status") == "TIMEOUT" for k, v in report.items() if k != "summary"):
        # a probe thread is stuck in the CUDA runtime: teardown could hang
        # on it, and the report is out
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 1 if failed else 0


def cmd_bench(args) -> None:
    # an explicit --seconds wins over an ambient BENCH_SECONDS; with no flag
    # the variable (bench.py's own contract) still applies
    if args.seconds is not None:
        os.environ["BENCH_SECONDS"] = str(args.seconds)
    else:
        os.environ.setdefault("BENCH_SECONDS", "1800")
    from . import bench

    bench.main(args.device)


def cmd_gui(args) -> int:
    if args.smoke:
        os.environ.setdefault("SOFTSPOKEN_QT_SHIM", "1")
    from .ui import qt_app

    return qt_app.main(_load_config(args), smoke_mode=args.smoke,
                       screenshot=args.screenshot, device=args.device)


def _add_detect_parser(sub) -> None:
    """The JAX CLI's ``detect`` flags, and ``--device``."""
    d = sub.add_parser("detect", help="run voice detection")
    # also accepted after the command; the global --config otherwise
    d.add_argument("--config", default=argparse.SUPPRESS,
                   help="JSON config file overriding defaults")
    d.add_argument("--project", help="project name (default: latest)")
    d.add_argument("--files", nargs="*",
                   help="ad-hoc audio files instead of a project (WAV, FLAC, AIFF, "
                        "W64, CAF, AU, SPHERE)")
    d.add_argument("--out", help="detections CSV for ad-hoc mode (default detections.csv)")
    g = d.add_mutually_exclusive_group()
    g.add_argument("--checkpoint", help="reference .pth checkpoint (default: the "
                   "trained root/models/spec_unet_2d/model_checkpoint.pth)")
    g.add_argument("--random-init", action="store_true",
                   help="use the deterministic random-init fixture weights")
    d.add_argument("--precision", choices=["fast", "parity"])
    d.add_argument("--device-batch", type=int)
    d.add_argument("--file-concurrency", type=int, metavar="K",
                   help="detect K files at once, each worker thread on its own "
                        "CUDA stream; results persist in submission order, so "
                        "the CSV equals the sequential run's. Default 1")
    _add_operating_point_flags(
        d, "drop regions whose surrounding audio scores rhythmic/music-like "
           "(engine/postfilter.py). Optional value = score threshold "
           "(default 0.85); off when the flag is absent")
    d.add_argument("--strict-reference", action="store_true",
                   help="reprocess files already in the CSV")
    d.add_argument("--streaming", action="store_true",
                   help="force bounded-memory streaming decode")
    d.add_argument("--chunk-checkpoint", type=int, metavar="N", default=None,
                   help="persist fused-pipeline progress every N chunks so a "
                        "killed run resumes mid-file (engine/journal.py); "
                        "sidecars live in .chunk_progress/ next to the CSV")
    d.add_argument("--mesh", action="store_true",
                   help="shard each batch's windows over every visible card")
    d.add_argument("--distributed", action="store_true",
                   help="multi-process: join the process group (torch.distributed) and "
                        "detect this process's round-robin share of the file list "
                        "into <csv>.p<id>; gather with `project merge-detections`")
    d.add_argument("--coordinator", help="(--distributed) coordinator address host:port")
    d.add_argument("--num-processes", type=int, help="(--distributed) process count")
    d.add_argument("--process-id", type=int, help="(--distributed) this process's id")
    d.add_argument("--device", help="torch device (default: the CUDA card)")
    d.set_defaults(func=cmd_detect)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="softspoken_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON config file overriding defaults")
    p.add_argument("--project-dir", help="projects root (default ./projects)")
    p.add_argument("-v", "--verbose", action="store_true", help="debug-level logs")
    p.add_argument("--log-json", action="store_true",
                   help="emit machine-parseable JSON-lines logs on stderr")
    sub = p.add_subparsers(dest="command", required=True)

    pp = sub.add_parser("project", help="manage projects")
    pp.add_argument("action", choices=["new", "list", "status", "add-files",
                                       "remove-files", "merge-detections"])
    pp.add_argument("name", nargs="?", help="project name")
    pp.add_argument("files", nargs="*", help="audio files (new/add-files/remove-files)")
    pp.set_defaults(func=cmd_project)

    _add_detect_parser(sub)

    pr = sub.add_parser("review", help="review detections")
    pr.add_argument("action", choices=["list", "grade", "keep", "erase", "add",
                                        "delete", "export", "render", "segment"])
    pr.add_argument("--project")
    pr.add_argument("--rows", type=int, nargs="*", default=[], help="row indexes")
    pr.add_argument("--row", type=int, default=0, help="row index (render/segment)")
    pr.add_argument("--file", help="audio file (add)")
    pr.add_argument("--start", type=float)
    pr.add_argument("--end", type=float)
    pr.add_argument("--zoom", type=float, default=1.0, help="seconds per inch")
    pr.add_argument("--out", help="output path (render/segment)")
    pr.set_defaults(func=cmd_review)

    ps = sub.add_parser("silence", help="zero flagged intervals, write *_silenced.wav")
    ps.add_argument("--project")
    ps.add_argument("--output-dir", required=True)
    ps.add_argument("--fade-ms", type=float, default=0.0,
                    help="crossfade ramp (0 = reference hard zero)")
    ps.add_argument("--subtype", default="PCM_16",
                    help="output sample format (PCM_16 parity default)")
    ps.set_defaults(func=cmd_silence)

    _add_train_parser(sub)
    _add_eval_parser(sub)

    pdx = sub.add_parser(
        "doctor", help="environment diagnosis (card, kernels, native libraries, "
                       "checkpoint) with bounded timeouts")
    pdx.add_argument("--device-timeout", type=float, default=60.0,
                     help="seconds to wait on each device probe before "
                          "reporting TIMEOUT (default 60)")
    pdx.set_defaults(func=cmd_doctor)

    pb = sub.add_parser("bench", help="throughput benchmark")
    pb.add_argument("--seconds", type=float, default=None,
                    help="benchmark recording length (default 1800; an "
                         "explicit value overrides BENCH_SECONDS)")
    pb.add_argument("--device", help="torch device (default: the CUDA card)")
    pb.set_defaults(func=cmd_bench)

    pg = sub.add_parser("gui", help="Qt desktop app (PySide6, or headless shim)")
    pg.add_argument("--smoke", action="store_true",
                    help="construct + click through every screen headlessly")
    pg.add_argument("--screenshot", help="(--smoke) save the review spectrogram PNG")
    pg.add_argument("--device", help="torch device for detection (default: the CUDA card)")
    pg.set_defaults(func=cmd_gui)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils import setup_logging

    setup_logging(level=logging.DEBUG if args.verbose else logging.INFO,
                  json_lines=args.log_json)
    out = args.func(args)
    if isinstance(out, int):
        return out
    return 1 if isinstance(out, dict) and out.get("errors") else 0


if __name__ == "__main__":
    sys.exit(main())
