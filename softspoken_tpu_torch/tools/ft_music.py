"""Music-rejection fine-tune experiment: train → gate → verdict.

The port of ``scripts/ft_music.py``, motivated by
``docs/QUALITY_r03_realaudio.json`` (the checkpoint flags ~50% of real
music as speech; the opt-in synthetic "music" confuser reproduces the false
fire).  Stages, fingerprinted by ``tools.ftlib`` (a rerun with the same
parameters skips finished stages; other parameters in the same workdir
refuse):

  1. fine-tune the committed checkpoint (the .pth) with
     ``--noise-extra music`` into ``<workdir>/candidate.pth``
  2. the quality grid of the candidate (``tools.quality_grid``)
  3. the real-audio probe of the candidate (``tools.real_audio_check``)
  4. a verdict JSON comparing the candidate with the committed evidence
     (``docs/QUALITY_r03.json``, ``docs/QUALITY_r03_realaudio.json``)

ADOPTION RULE (decided before measuring): adopt only if (a) no synthetic
grid condition's parity frame F1 drops more than 0.01 and the worst case
stays >= the committed one - 0.005, AND (b) the real-audio music
false_fraction at least halves.

    python -m softspoken_tpu_torch.tools.ft_music [--workdir DIR]
        [--steps 8000] [--lr 1e-4] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import OUT_DIR, add_device_arg
from .ftlib import (committed, frame_f1_deltas, grid_cmd, load_json, music_false_fraction,
                    real_cmd, run_stages, train_cmd, v2_worst, write_verdict)

NAME = "ft_music"
RULE = ("adopt iff no condition drops >0.01, worst v2 within 0.005 "
        "of committed, and music false_fraction at least halves")
SUMMARY = ("adopt", "gate_grid_ok", "gate_music_ok", "worst_out_of_family",
           "music_false_fraction", "regressed_conditions")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, NAME))
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--lr", type=float, default=1e-4)
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
    recipe = {"steps": steps, "lr": args.lr, "extras": ["music"],
              "batch_size": bs, "quick": bool(args.quick), "seed": 77019}
    cand = os.path.join(wd, "candidate.pth")
    grid_json = os.path.join(wd, "grid_candidate.json")
    real_json = os.path.join(wd, "realaudio_candidate.json")
    py = sys.executable
    return recipe, {
        "train": (cand, train_cmd(py, cand, steps, bs, args.lr, 77019,
                                  ["--noise-extra", "music"], args.quick, args.device)),
        "grid": (grid_json, grid_cmd(py, cand, grid_json, wd, args.quick, args.device,
                                     workdir=False)),
        "real": (real_json, real_cmd(py, cand, real_json, args.quick, args.device,
                                     args.data_dir)),
    }


def conditions_of(grid: dict) -> dict:
    """quality_grid writes {"conditions": ...} at top level; the committed
    docs/QUALITY_r03.json wraps the round-3 grid under "grid_after_finetune"."""
    return (grid.get("conditions")
            or grid.get("grid_after_finetune", {}).get("conditions")
            or {})


def verdict(grid_c: dict, real_c: dict, grid_0: dict, real_0: dict, recipe: dict,
            cand: str) -> dict:
    """The pre-registered rule on the candidate's grid and real-audio probe
    against the committed ones."""
    conds_c, conds_0 = conditions_of(grid_c), conditions_of(grid_0)
    regressions, per_condition, worst_c = frame_f1_deltas(conds_c, conds_0, 0.01)
    music_0, music_c = music_false_fraction(real_0), music_false_fraction(real_c)
    worst_0 = v2_worst(conds_0)
    gate_grid = not regressions and worst_c >= worst_0 - 0.005
    gate_music = music_c <= 0.5 * music_0
    return {
        "adopt": bool(gate_grid and gate_music),
        "gate_grid_ok": gate_grid,
        "gate_music_ok": gate_music,
        "worst_out_of_family": {"committed": worst_0, "candidate": worst_c},
        "music_false_fraction": {"committed": music_0, "candidate": music_c},
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
    out = verdict(load_json(stages["grid"][0]), load_json(stages["real"][0]),
                  committed("QUALITY_r03.json"), committed("QUALITY_r03_realaudio.json"),
                  recipe, stages["train"][0])
    write_verdict(out, os.path.join(wd, f"VERDICT_{NAME}.json"), SUMMARY)
    return out


if __name__ == "__main__":
    main()
