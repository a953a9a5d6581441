"""Directional probe for the round-5 plan: from-scratch training WITH
channel augmentations vs without, at equal (small) step budgets.

The port of ``scripts/probe_scratch_channels.py``.  All four round-4
fine-tunes from the committed checkpoint failed their gates with one
signature: marginal-SNR/reverberant conditions are exquisitely sensitive
to late distribution changes (docs/FT_SNRFLOOR_r04.json
``round5_reading``).  The proposed round-5 remedy is hard channels INSIDE
from-scratch training.  This probe tests that direction cheaply:

  arm A: train from scratch, augs = add_reverb + reduce_volume (the
         committed checkpoint's lineage augs)
  arm B: same + gain_ramp (train/augment.py's fading analog)

Both arms run the same steps and seed (31337), each a subprocess of the
port's ``train --synthetic`` into ``<workdir>/ckpt_<arm>.pth``; both are
scored by a ``Detector`` on the six conditions that define the question
(clean / fading / reverb08 x both generators, eval sets synthesized once
with seeds 7600+i and reused only under the same parameters).  NOT an
adoption experiment: it measures whether the in-distribution-channel
direction moves the fading/reverb conditions at matched budget.  The
record is docs/PROBE_SCRATCH_r04.json.

    python -m softspoken_tpu_torch.tools.probe_scratch_channels
        [--workdir DIR] [--steps 8000] [--files 4] [--seconds 60]
        [--out PATH] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..config import Config
from ..engine import Detector
from ..ops import KERNEL_LAUNCHES
from ..train import evaluate as E
from . import OUT_DIR, add_device_arg, print_launches, resolve_out
from . import quality_grid as QG
from .ftlib import run, scratch_train_cmd, stage

CONDS = [
    ("clean", dict()),
    ("fading", dict(degradations=["fading"])),
    ("reverb08", dict(degradations=["reverb08"])),
]
ARMS = {
    "A_lineage": ["add_reverb", "reduce_volume"],
    "B_channels": ["add_reverb", "reduce_volume", "gain_ramp"],
}
SEED = 31337
QUESTION = ("Does gain_ramp (fading analog) inside from-scratch training move the "
            "fading/reverb conditions at matched step budget? Directional probe only "
            "— NOT an adoption experiment (models are far below the committed 48k "
            "checkpoint).")
DEFAULT_OUT = os.path.join(OUT_DIR, "PROBE_SCRATCH_torch.json")


def build_eval_sets(workdir, n_files, seconds):
    """Synthesize the six eval sets ONCE (both arms score identical data).
    A set that a previous run built is reused only when EVERY generation
    parameter matches this invocation (its ``labels.csv.fp.json``): a
    count-only check would reuse wrong-duration sets when --seconds
    changed between runs."""
    sets = {}
    for gen in ("v1", "v2"):
        for ci, (cname, kw) in enumerate(CONDS):
            tag = f"{gen}_{cname}"
            d = os.path.join(workdir, f"eval_{tag}")
            labels = os.path.join(d, "labels.csv")
            fp = {"n_files": n_files, "seconds": seconds, "seed": 7600 + ci,
                  "generator": gen, "kwargs": {k: list(v) if isinstance(v, list) else v
                                               for k, v in kw.items()}}
            fp_path = labels + ".fp.json"
            reusable = False
            if os.path.exists(labels) and os.path.exists(fp_path):
                with open(fp_path) as f:
                    reusable = json.load(f) == json.loads(json.dumps(fp))
            if not reusable:
                labels = E.make_eval_set(d, n_files=n_files, seconds=seconds,
                                         seed=7600 + ci, generator=gen, **kw)
                with open(fp_path, "w") as f:
                    json.dump(fp, f)
            sets[tag] = labels
    return sets


def score(ckpt, eval_sets, device=None) -> dict:
    """Parity frame and event F1 of the checkpoint on each eval set."""
    cfg = Config()
    det = Detector(cfg, checkpoint_path=ckpt, device=device)
    if getattr(det, "epoch", -1) < 0:
        raise SystemExit(f"checkpoint {ckpt} did not load")
    out = {}
    for tag, labels in eval_sets.items():
        per_file = QG.detect_set(det, E.load_labels(labels))
        m = QG.metrics_from(per_file, cfg.engine.pad_seconds)
        out[tag] = {"frame_f1": m["parity"]["frame_f1"],
                    "event_f1": m["parity"]["event_f1"]}
        print(f"  {tag}: frame {out[tag]['frame_f1']}", flush=True)
    return out


def summarize(results: dict, steps: int, n_files: int, seconds: float, quick: bool) -> dict:
    """The probe's record from each arm's scores."""
    deltas = {tag: {
        "frame_f1_A": results["A_lineage"][tag]["frame_f1"],
        "frame_f1_B": results["B_channels"][tag]["frame_f1"],
        "delta_B_minus_A": round(results["B_channels"][tag]["frame_f1"]
                                 - results["A_lineage"][tag]["frame_f1"], 4),
    } for tag in results["A_lineage"]}
    return {
        "question": QUESTION,
        "steps": steps,
        "eval": {"files": n_files, "seconds": seconds, "conditions": [c for c, _ in CONDS]},
        "arms": {k: {"augs": v} for k, v in ARMS.items()},
        "per_condition": deltas,
        "quick": bool(quick),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, "probe_scratch"))
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--quick", action="store_true")
    add_device_arg(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    launches0 = dict(KERNEL_LAUNCHES)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    steps = 8 if args.quick else args.steps
    n_files = 1 if args.quick else args.files
    seconds = 30.0 if args.quick else args.seconds
    if args.quick and args.out == DEFAULT_OUT:
        args.out = os.path.join(wd, "probe_quick.json")  # never the full probe's place
    out_path = resolve_out(args.out)

    eval_sets = build_eval_sets(wd, n_files, seconds)
    results = {}
    for arm, augs in ARMS.items():
        ckpt = os.path.join(wd, f"ckpt_{arm}.pth")
        recipe = {"steps": steps, "augs": augs, "seed": SEED, "from_scratch": True,
                  "quick": bool(args.quick)}
        cmd = scratch_train_cmd(sys.executable, ckpt, steps, 2 if args.quick else 128,
                                ["--lr", "1e-3", "--seed", str(SEED), "--augment", *augs],
                                args.quick, args.device)
        stage(f"train {arm}", ckpt, recipe,
              lambda cmd=cmd, arm=arm: run(cmd, os.path.join(wd, f"train_{arm}.log"),
                                           retries=2))
        print(f"scoring {arm} ({augs})", flush=True)
        results[arm] = score(ckpt, eval_sets, args.device)

    out = summarize(results, steps, n_files, seconds, args.quick)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["per_condition"], indent=1), flush=True)
    print(f"wrote {out_path}", flush=True)
    print_launches(launches0)
    return out


if __name__ == "__main__":
    main()
