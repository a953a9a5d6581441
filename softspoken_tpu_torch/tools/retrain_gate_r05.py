"""Round-5 retrain adoption gate (docs/ROUND5_PLAN.md, pre-registered).

The port of ``scripts/retrain_gate_r05.py``.  Runs the evidence battery
against the candidate checkpoint of ``tools.train_r05`` and records the
adoption decision:

  stage 1: the quality grid (``tools.quality_grid``, 36 conditions)
           → <workdir>/quality_candidate.json
  stage 2: the real-audio probe (``tools.real_audio_check``)
           → <workdir>/real_candidate.json
  stage 3: the verdict against the committed records
           (docs/QUALITY_r04.json, docs/QUALITY_r03_realaudio.json)
           → <workdir>/RETRAIN_GATE_r05.json (the JAX script's
             docs/RETRAIN_GATE_r05.json is committed evidence)

Gate (registered in docs/ROUND5_PLAN.md BEFORE the training run):
  adopt iff
    (a) no condition regresses >0.005 parity frame F1 vs QUALITY_r04
    (b) v2_fading (the 0.719 worst case) improves
    (c) real-music false_fraction < 0.10

A candidate grid missing committed conditions is refused outside
``--quick`` instead of trivially passing.  Stage 2 needs pygame's clips
(``--data-dir``); without them the gate exits after stage 1 naming them.

    python -m softspoken_tpu_torch.tools.retrain_gate_r05 [--workdir DIR]
        [--ckpt PTH] [--files 8] [--seconds 120] [--quick]
        [--data-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import OUT_DIR, add_device_arg, resolve_out
from . import real_audio_check as RA
from .ftlib import (committed, frame_f1_deltas, grid_cmd, load_json, music_false_fraction,
                    real_cmd, run, stage)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, "work_r05"))
    ap.add_argument("--ckpt", default=None,
                    help="candidate checkpoint (default <workdir>/ckpt_r05.pth)")
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--data-dir", default=None,
                    help="the real-audio clips (default: pygame's examples/data)")
    add_device_arg(ap)
    return ap


def plan(args) -> "tuple[dict, dict]":
    """(recipe, stages): the fingerprint, and each stage's (done path, argv)."""
    wd = os.path.abspath(args.workdir)
    ckpt = args.ckpt or os.path.join(wd, "ckpt_r05.pth")
    n_files = 2 if args.quick else args.files
    seconds = 30.0 if args.quick else args.seconds
    recipe = {"ckpt": ckpt, "files": n_files, "seconds": seconds,
              "quick": bool(args.quick), "plan": "docs/ROUND5_PLAN.md"}
    grid_json = os.path.join(wd, "quality_candidate.json")
    real_json = os.path.join(wd, "real_candidate.json")
    py = sys.executable
    return recipe, {
        "grid": (grid_json, grid_cmd(py, ckpt, grid_json, wd, args.quick, args.device,
                                     workdir=False, files=n_files, seconds=seconds)),
        "real": (real_json, real_cmd(py, ckpt, real_json, args.quick, args.device,
                                     args.data_dir, workdir=os.path.join(wd, "real_wd"))),
    }


def verdict(grid_c: dict, real_c: dict, grid_0: dict, real_0: dict, recipe: dict,
            grid_json: str, real_json: str) -> dict:
    """The pre-registered rule on the candidate's grid and real-audio probe
    against the committed ones; refuses a partial grid unless
    ``recipe["quick"]``."""
    conds_c = grid_c.get("conditions") or {}
    conds_0 = grid_0.get("conditions") or {}
    missing = sorted(set(conds_0) - set(conds_c))
    if missing and not recipe["quick"]:
        raise SystemExit(
            f"candidate grid is missing {len(missing)} committed conditions "
            f"({missing[:5]}…) — refusing to gate on incomplete data")
    shared = {t: conds_c[t] for t in sorted(set(conds_c) & set(conds_0))}
    regressions, per_condition, _ = frame_f1_deltas(shared, conds_0, 0.005)

    fading_0 = conds_0["v2_fading"]["parity"]["frame_f1"]
    fading_c = (conds_c.get("v2_fading") or {}).get("parity", {}).get("frame_f1")
    music_0, music_c = music_false_fraction(real_0), music_false_fraction(real_c)
    gate_grid = not regressions
    gate_fading = fading_c is not None and fading_c > fading_0
    gate_music = music_c < 0.10
    n_better = sum(1 for v in per_condition.values() if v["delta"] > 0)
    n_worse = sum(1 for v in per_condition.values() if v["delta"] < 0)
    worst_c = min(((t, v["candidate"]) for t, v in per_condition.items()),
                  key=lambda kv: kv[1], default=("", 1.0))
    return {
        "adopt": bool(gate_grid and gate_fading and gate_music),
        "gate_no_regression_ok": gate_grid,
        "gate_fading_improves_ok": bool(gate_fading),
        "gate_music_ok": gate_music,
        "v2_fading": {"committed": fading_0, "candidate": fading_c},
        "music_false_fraction": {"committed": music_0, "candidate": music_c},
        "regressed_conditions": regressions,
        "conditions_better_worse": [n_better, n_worse],
        "worst_candidate_condition": {"condition": worst_c[0], "frame_f1": worst_c[1]},
        "per_condition": per_condition,
        "recipe": recipe,
        "grid_artifact": grid_json,
        "real_artifact": real_json,
    }


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    out_path = resolve_out(os.path.join(wd, "RETRAIN_GATE_r05.json"))
    recipe, stages = plan(args)

    grid_json, cmd = stages["grid"]
    stage("stage 1 (grid)", grid_json, recipe,
          lambda: run(cmd, os.path.join(wd, "grid.log"), retries=2))
    real_json, cmd = stages["real"]
    data_dir = args.data_dir or RA.pygame_data_dir()
    missing = RA.missing_clips(data_dir)
    if missing and not os.path.exists(real_json):
        raise SystemExit(f"stage 2 (real-audio) needs the clips missing from "
                         f"{data_dir or '(no pygame)'}: {', '.join(missing)}; pass "
                         "--data-dir with pygame's examples/data (stage 1 is kept)")
    stage("stage 2 (real-audio)", real_json, recipe,
          lambda: run(cmd, os.path.join(wd, "real.log"), retries=2))

    out = verdict(load_json(grid_json), load_json(real_json),
                  committed("QUALITY_r04.json"), committed("QUALITY_r03_realaudio.json"),
                  recipe, grid_json, real_json)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "per_condition"}, indent=1),
          flush=True)
    print(f"wrote {out_path}", flush=True)
    return out


if __name__ == "__main__":
    main()
