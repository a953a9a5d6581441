"""Protected-placement confuser fine-tune: train → gate → verdict.

The port of ``scripts/ft_hisnr.py``.  The round-4 fine-tunes were rejected
with one collateral signature: marginal-SNR and reverberant conditions
regress when texture confusers enter the noise pool, while the
third-family textures transfer to real music well.  This experiment
isolates placement: the same extras and exposure as ``ft_synth3``, under
the **protected policy** (``train --noise-extra-policy protected``):
extras appear as pure negatives on silent rows and only at >= 10 dB SNR
under speech.  Stages (fingerprinted, ``tools.ftlib``):

  1. fine-tune the committed checkpoint (the .pth) with
     ``--noise-extra granular drone impact_chain crackle
     --noise-extra-policy protected`` (retried on the trainer's stall exit)
  2. the quality grid of the candidate (``tools.quality_grid``)
  3. the real-audio probe of the candidate (the music number)
  4. a verdict JSON against the committed ``docs/QUALITY_r04.json`` and
     ``docs/QUALITY_r03_realaudio.json``; a candidate grid that lacks a
     committed condition is refused

ADOPTION RULE (decided before measuring): adopt only if (a) NO grid
condition's parity frame F1 regresses more than 0.005, (b) the real-audio
music false_fraction falls below 0.10, and (c) the out-of-family worst
case does not regress (>= committed - 0.005).

    python -m softspoken_tpu_torch.tools.ft_hisnr [--workdir DIR]
        [--steps 8000] [--lr 1e-4] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import OUT_DIR, add_device_arg
from .ftlib import (committed, frame_f1_deltas, grid_cmd, load_json, music_false_fraction,
                    real_cmd, run_stages, train_cmd, v2_worst, write_verdict)

NAME = "ft_hisnr"
EXTRAS = ["granular", "drone", "impact_chain", "crackle"]
RULE = ("adopt iff no condition drops >0.005 frame F1, real-audio music "
        "false_fraction < 0.10, and the v2 worst case does not regress "
        "more than 0.005")
SUMMARY = ("adopt", "gate_no_regression_ok", "gate_music_ok", "gate_worst_no_regress_ok",
           "worst_out_of_family", "music_false_fraction", "regressed_conditions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, NAME))
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--extra-frac", type=float, default=0.2)
    ap.add_argument("--snr-floor", type=float, default=10.0,
                    help="protected SNR floor for extras under speech")
    ap.add_argument("--silent-prob", type=float, default=0.5,
                    help="probability a silent row draws an extras clip")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--quick", action="store_true",
                    help="tiny steps + --quick grids (plumbing smoke)")
    ap.add_argument("--data-dir", default=None, help="the real-audio clips (stage 3)")
    add_device_arg(ap)
    return ap


def plan(args) -> "tuple[dict, dict]":
    """(recipe, stages): the fingerprint, and each stage's (done path, argv)."""
    wd = os.path.abspath(args.workdir)
    steps = 4 if args.quick else args.steps
    bs = 2 if args.quick else args.batch_size
    recipe = {"steps": steps, "lr": args.lr, "extras": EXTRAS,
              "extra_frac": args.extra_frac, "policy": "protected",
              "snr_floor": args.snr_floor, "silent_prob": args.silent_prob,
              "batch_size": bs, "quick": bool(args.quick), "seed": 91504}
    cand = os.path.join(wd, "candidate.pth")
    grid_json = os.path.join(wd, "grid_candidate.json")
    real_json = os.path.join(wd, "realaudio_candidate.json")
    py = sys.executable
    flags = ["--noise-extra", *EXTRAS, "--noise-extra-frac", str(args.extra_frac),
             "--noise-extra-policy", "protected",
             "--noise-extra-snr-min", str(args.snr_floor),
             "--noise-extra-silent-prob", str(args.silent_prob)]
    return recipe, {
        "train": (cand, train_cmd(py, cand, steps, bs, args.lr, 91504, flags,
                                  args.quick, args.device)),
        "grid": (grid_json, grid_cmd(py, cand, grid_json, wd, args.quick, args.device)),
        "real": (real_json, real_cmd(py, cand, real_json, args.quick, args.device,
                                     args.data_dir)),
    }


def verdict(grid_c: dict, real_c: dict, grid_0: dict, real_0: dict, recipe: dict,
            cand: str) -> dict:
    """The pre-registered rule on the candidate's grid and real-audio probe
    against the committed ones.  A partial candidate grid must not pass:
    the worst case starts at 1.0 and only common tags are compared, so
    missing v2 conditions would satisfy the worst-case gate and hide
    regressions; it raises ``SystemExit``."""
    conds_c = grid_c.get("conditions") or {}
    conds_0 = grid_0.get("conditions") or {}
    missing = sorted(set(conds_0) - set(conds_c))
    if missing:
        raise SystemExit(
            f"candidate grid is missing {len(missing)} committed conditions "
            f"({missing[:5]}…) — refusing to gate on incomplete data; rerun "
            "stage 2 with the full condition set")
    regressions, per_condition, worst_c = frame_f1_deltas(conds_c, conds_0, 0.005)
    music_0, music_c = music_false_fraction(real_0), music_false_fraction(real_c)
    worst_0 = v2_worst(conds_0)
    gate_grid = not regressions
    gate_music = music_c < 0.10
    gate_worst = worst_c >= worst_0 - 0.005
    return {
        "adopt": bool(gate_grid and gate_music and gate_worst),
        "gate_no_regression_ok": gate_grid,
        "gate_music_ok": gate_music,
        "gate_worst_no_regress_ok": gate_worst,
        "worst_out_of_family": {"committed": worst_0, "candidate": worst_c},
        "music_false_fraction": {"committed": music_0, "candidate": music_c},
        "regressed_conditions": regressions,
        "per_condition": per_condition,
        "recipe": recipe,
        "candidate": cand,
        "extras": EXTRAS,
        "rule": RULE,
    }


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    recipe, stages = plan(args)
    run_stages(wd, recipe, stages, train_retries=2)
    out = verdict(load_json(stages["grid"][0]), load_json(stages["real"][0]),
                  committed("QUALITY_r04.json"), committed("QUALITY_r03_realaudio.json"),
                  recipe, stages["train"][0])
    write_verdict(out, os.path.join(wd, f"VERDICT_{NAME}.json"), SUMMARY)
    return out


if __name__ == "__main__":
    main()
