"""Boundary-weighted-loss fine-tune experiment: train → gate → verdict.

The port of ``scripts/ft_boundary.py`` (the training-side event-F1 lever).
Post-processing levers measured marginal on the round-4 grid: events
fragment because of detection quality at boundaries, not threshold
flicker.  This experiment moves the gradient there: fine-tune the committed
checkpoint with ``train --boundary-weight W`` (extra BCE weight within
~47 ms of every onset/offset, mean-normalized), then gate on the full grid.
Stages (fingerprinted, ``tools.ftlib``):

  1. fine-tune the committed checkpoint (the .pth) into
     ``<workdir>/candidate.pth``
  2. the quality grid of the candidate, without the post-filter A/B
  3. a verdict JSON against the committed ``docs/QUALITY_r04.json``

ADOPTION RULE (decided before measuring): adopt only if (a) NO grid
condition's parity frame F1 regresses more than 0.005, (b) the
out-of-family worst-case EVENT F1 improves by at least +0.02, and (c) mean
v2 frame F1 does not drop.

    python -m softspoken_tpu_torch.tools.ft_boundary [--workdir DIR]
        [--steps 6000] [--lr 1e-4] [--weight 2.0] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import OUT_DIR, add_device_arg
from .ftlib import committed, grid_cmd, load_json, run_stages, train_cmd, write_verdict

NAME = "ft_boundary"
RULE = ("adopt iff no condition drops >0.005 frame F1, v2 worst "
        "event F1 improves >= +0.02, and v2 mean frame F1 holds")
SUMMARY = ("adopt", "gate_no_regression_ok", "gate_event_improves_ok", "gate_frame_mean_ok",
           "v2_worst_event_f1", "v2_mean_event_f1", "regressed_conditions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, NAME))
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight", type=float, default=2.0)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--quick", action="store_true")
    add_device_arg(ap)
    return ap


def plan(args) -> "tuple[dict, dict]":
    """(recipe, stages): the fingerprint, and each stage's (done path, argv)."""
    wd = os.path.abspath(args.workdir)
    steps = 4 if args.quick else args.steps
    bs = 2 if args.quick else args.batch_size
    recipe = {"steps": steps, "lr": args.lr, "boundary_weight": args.weight,
              "batch_size": bs, "quick": bool(args.quick), "seed": 99077}
    cand = os.path.join(wd, "candidate.pth")
    grid_json = os.path.join(wd, "grid_candidate.json")
    py = sys.executable
    return recipe, {
        "train": (cand, train_cmd(py, cand, steps, bs, args.lr, 99077,
                                  ["--boundary-weight", str(args.weight)],
                                  args.quick, args.device)),
        "grid": (grid_json, grid_cmd(py, cand, grid_json, wd, args.quick, args.device,
                                     postfilter_ab=False)),
    }


def verdict(grid_c: dict, grid_0: dict, recipe: dict, cand: str) -> dict:
    """The pre-registered rule on the candidate's grid against the
    committed one."""
    conds_c = grid_c.get("conditions") or {}
    conds_0 = grid_0.get("conditions") or {}
    regressions, per_condition = [], {}
    for tag, res_c in conds_c.items():
        res_0 = conds_0.get(tag)
        if res_0 is None:
            continue
        f1_c, f1_0 = res_c["parity"]["frame_f1"], res_0["parity"]["frame_f1"]
        per_condition[tag] = {
            "frame": {"committed": f1_0, "candidate": f1_c,
                      "delta": round(f1_c - f1_0, 4)},
            "event": {"committed": res_0["parity"]["event_f1"],
                      "candidate": res_c["parity"]["event_f1"],
                      "delta": round(res_c["parity"]["event_f1"]
                                     - res_0["parity"]["event_f1"], 4)},
        }
        if f1_c < f1_0 - 0.005:
            regressions.append(tag)

    def v2_stats(conds, key):
        vals = [r["parity"][key] for t, r in conds.items()
                if t.startswith("v2") and t in per_condition]
        return (min(vals), sum(vals) / len(vals)) if vals else (0.0, 0.0)

    wev_0, mev_0 = v2_stats(conds_0, "event_f1")
    wev_c, mev_c = v2_stats(conds_c, "event_f1")
    wfr_0, mfr_0 = v2_stats(conds_0, "frame_f1")
    wfr_c, mfr_c = v2_stats(conds_c, "frame_f1")
    gate_grid = not regressions
    gate_event = wev_c >= wev_0 + 0.02
    gate_frame_mean = mfr_c >= mfr_0
    return {
        "adopt": bool(gate_grid and gate_event and gate_frame_mean),
        "gate_no_regression_ok": gate_grid,
        "gate_event_improves_ok": gate_event,
        "gate_frame_mean_ok": gate_frame_mean,
        "v2_worst_event_f1": {"committed": wev_0, "candidate": wev_c},
        "v2_mean_event_f1": {"committed": round(mev_0, 4), "candidate": round(mev_c, 4)},
        "v2_worst_frame_f1": {"committed": wfr_0, "candidate": wfr_c},
        "v2_mean_frame_f1": {"committed": round(mfr_0, 4), "candidate": round(mfr_c, 4)},
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
