"""SNR-floor-extension fine-tune experiment: train → gate → verdict.

The port of ``scripts/ft_snrfloor.py`` (the round-4 grid's worst hole, the
slow-fading channel).  The committed checkpoint trains on mixes at SNR
-5..20 dB, but the fading condition's deep fades push speech partly below
that floor, a regime the model has never seen labeled positive.  This
experiment extends the floor (``train --snr-min -12``) and changes no
texture distribution and no loss shape.  Stages (fingerprinted,
``tools.ftlib``):

  1. fine-tune the committed checkpoint (the .pth) into
     ``<workdir>/candidate.pth``
  2. the quality grid of the candidate, without the post-filter A/B
  3. a verdict JSON against the committed ``docs/QUALITY_r04.json``

ADOPTION RULE (decided before measuring): adopt only if (a) NO grid
condition's parity frame F1 regresses more than 0.005, (b) the fading
conditions improve (v2_fading frame F1 by >= +0.02), and (c) v2 mean frame
F1 does not drop.

    python -m softspoken_tpu_torch.tools.ft_snrfloor [--workdir DIR]
        [--steps 6000] [--lr 3e-5] [--snr-min -12] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import OUT_DIR, add_device_arg
from .ftlib import (committed, frame_f1_deltas, grid_cmd, load_json, run_stages, train_cmd,
                    write_verdict)

NAME = "ft_snrfloor"
RULE = ("adopt iff no condition drops >0.005 frame F1, v2_fading "
        "frame F1 improves >= +0.02, and v2 mean frame F1 holds")
SUMMARY = ("adopt", "gate_no_regression_ok", "gate_fading_improves_ok", "gate_v2_mean_ok",
           "fading", "v2_mean_frame_f1", "regressed_conditions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, NAME))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--snr-min", type=float, default=-12.0)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--quick", action="store_true")
    add_device_arg(ap)
    return ap


def plan(args) -> "tuple[dict, dict]":
    """(recipe, stages): the fingerprint, and each stage's (done path, argv)."""
    wd = os.path.abspath(args.workdir)
    steps = 4 if args.quick else args.steps
    bs = 2 if args.quick else args.batch_size
    recipe = {"steps": steps, "lr": args.lr, "snr_min": args.snr_min,
              "batch_size": bs, "quick": bool(args.quick), "seed": 66013}
    cand = os.path.join(wd, "candidate.pth")
    grid_json = os.path.join(wd, "grid_candidate.json")
    py = sys.executable
    return recipe, {
        "train": (cand, train_cmd(py, cand, steps, bs, args.lr, 66013,
                                  ["--snr-min", str(args.snr_min)],
                                  args.quick, args.device)),
        "grid": (grid_json, grid_cmd(py, cand, grid_json, wd, args.quick, args.device,
                                     postfilter_ab=False)),
    }


def verdict(grid_c: dict, grid_0: dict, recipe: dict, cand: str) -> dict:
    """The pre-registered rule on the candidate's grid against the
    committed one."""
    conds_c = grid_c.get("conditions") or {}
    conds_0 = grid_0.get("conditions") or {}
    regressions, per_condition, _worst = frame_f1_deltas(conds_c, conds_0, 0.005)

    def get(tag):
        return per_condition.get(tag, {})

    v2_frames = [r["parity"]["frame_f1"] for t, r in conds_c.items()
                 if t.startswith("v2") and t in per_condition]
    v2_frames_0 = [conds_0[t]["parity"]["frame_f1"] for t in conds_c
                   if t.startswith("v2") and t in per_condition]
    mean_c = sum(v2_frames) / len(v2_frames) if v2_frames else 0.0
    mean_0 = sum(v2_frames_0) / len(v2_frames_0) if v2_frames_0 else 0.0

    fading_delta = get("v2_fading").get("delta", 0.0)
    gate_grid = not regressions
    gate_fading = fading_delta >= 0.02
    gate_mean = mean_c >= mean_0
    return {
        "adopt": bool(gate_grid and gate_fading and gate_mean),
        "gate_no_regression_ok": gate_grid,
        "gate_fading_improves_ok": gate_fading,
        "gate_v2_mean_ok": gate_mean,
        "fading": {"v1": get("v1_fading"), "v2": get("v2_fading")},
        "v2_mean_frame_f1": {"committed": round(mean_0, 4), "candidate": round(mean_c, 4)},
        "regressed_conditions": regressions,
        "per_condition": per_condition,
        "recipe": recipe,
        "candidate": cand,
        "rule": RULE,
    }


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    recipe, stages = plan(args)
    run_stages(wd, recipe, stages)
    out = verdict(load_json(stages["grid"][0]), committed("QUALITY_r04.json"), recipe,
                  stages["train"][0])
    write_verdict(out, os.path.join(wd, f"VERDICT_{NAME}.json"), SUMMARY)
    return out


if __name__ == "__main__":
    main()
