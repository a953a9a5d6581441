"""Quality gate for a lossy upload wire (``ops/mulaw.py`` / ``ops/adpcm.py``;
pick with ``--codec``): the port of ``scripts/codec_gate.py``.

Synthesizes labeled eval files ONCE per condition (both generators, a
slice of the degradation grid including a mu-law *content* round trip —
companded audio companded again for transport), then scores the SAME files
through the fused pipeline with upload_codec pcm16, the candidate codec,
and the codec with the host decimation to 16 kHz (``io/decimate.py``), and
reports parity-point F1 plus the share of files whose detected intervals
are bit-identical across wires.  On the card ``--codec adpcm4`` decodes
through the adpcm_decode kernel and every wire through frame_mel.

The gate is written under ``--key`` into ``--out`` (read first when it
exists, as the JAX script appends; never a file under ``docs/``).

    python -m softspoken_tpu_torch.tools.codec_gate [--files 6] [--seconds 90]
        [--codec mulaw8|adpcm4] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from ..config import Config
from ..engine import Detector
from ..train import evaluate as E
from . import DEFAULT_CKPT, OUT_DIR, resolve_out
from .quality_grid import score_set

DEFAULT_OUT = os.path.join(OUT_DIR, "CODEC_GATE_torch.json")
CONDITIONS = [
    ("clean", dict()),
    ("snr5", dict(snr_db=(5.0, 5.0))),
    ("mulaw", dict(degradations=["mulaw"])),
    ("clip", dict(degradations=["clip"])),
    ("rolloff4k+mulaw", dict(degradations=["rolloff4k", "mulaw"])),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--sr", type=int, default=32000,
                    help="native rate of the synthesized eval files; 48000 gates "
                         "the M=3 decimation path (32000 gates M=2)")
    ap.add_argument("--key", default="codec_gate",
                    help="top-level key to write under in --out")
    ap.add_argument("--codec", default="mulaw8", choices=["mulaw8", "adpcm4"],
                    help="candidate lossy wire codec to gate against pcm16")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    args.out = resolve_out(args.out)
    device = "cpu" if args.cpu else None

    # three wire variants: exact, codec only, codec + host decimation to
    # 16 kHz — each gated against exact
    C = args.codec
    variants = {
        "pcm16": dict(upload_codec="pcm16", wire_decimate="off"),
        C: dict(upload_codec=C, wire_decimate="off"),
        f"{C}_dec": dict(upload_codec=C, wire_decimate="auto"),
    }
    dets = {}
    for name, kw in variants.items():
        cfg = Config().with_engine(pipeline="fused", **kw)
        dets[name] = Detector(cfg, checkpoint_path=args.ckpt, device=device)
        # refuse random init: a missing checkpoint degrades to fixture
        # weights and would publish a garbage gate under the real name
        if getattr(dets[name], "epoch", -1) < 0:
            raise SystemExit(
                f"checkpoint {args.ckpt} did not load (epoch<0) — "
                "refusing to run the codec gate on random init")
    pad = Config().engine.pad_seconds

    base = args.workdir or tempfile.mkdtemp(prefix="codec_gate_")
    gate = {"files": args.files, "seconds": args.seconds,
            "sr": args.sr, "codec": args.codec,
            "conditions": {}, "interval_identical_files": 0,
            "total_files": 0}
    t_all = time.time()
    for gen in ("v1", "v2"):
        for ci, (cname, kw) in enumerate(CONDITIONS):
            tag = f"{gen}_{cname}"
            labels = E.make_eval_set(os.path.join(base, tag), n_files=args.files,
                                     seconds=args.seconds, seed=8100 + ci,
                                     sr=args.sr, generator=gen, **kw)
            labeled = E.load_labels(labels)
            row = {}
            intervals = {}
            for codec, det in dets.items():
                res = score_set(det, labeled, pad)
                row[codec] = res["parity"]
                # score_set detected every file once: its engine intervals
                # serve the identity check directly
                intervals[codec] = res["intervals"]
            for lossy in (C, f"{C}_dec"):
                same = sum(a == b for a, b in zip(intervals["pcm16"], intervals[lossy]))
                row[f"{lossy}_intervals_identical"] = f"{same}/{args.files}"
                row[f"{lossy}_frame_f1_delta"] = round(
                    row[lossy]["frame_f1"] - row["pcm16"]["frame_f1"], 4)
            same = sum(a == b for a, b in zip(intervals["pcm16"], intervals[f"{C}_dec"]))
            gate["interval_identical_files"] += same
            gate["total_files"] += args.files
            gate["conditions"][tag] = row
            print(f"{tag}: pcm16 frame F1 {row['pcm16']['frame_f1']} "
                  f"{C} {row[C]['frame_f1']} "
                  f"(d {row[f'{C}_frame_f1_delta']:+.4f}) "
                  f"{C}_dec {row[f'{C}_dec']['frame_f1']} "
                  f"(d {row[f'{C}_dec_frame_f1_delta']:+.4f}, "
                  f"ident {row[f'{C}_dec_intervals_identical']})", flush=True)
    gate["wall_seconds"] = round(time.time() - t_all, 1)

    doc = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = json.load(f)
    doc[args.key] = gate
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"updated {args.out} {args.key}", flush=True)
    return gate


if __name__ == "__main__":
    main()
