"""Round-5 pre-registered from-scratch retrain (docs/ROUND5_PLAN.md).

The port of ``scripts/train_r05.py``: the supervisor of the one training
run that round 5 registered BEFORE running it (the plan's evidence table):

  - from scratch, >=48k steps, batch 128, lr 1e-3, seed 31337 (the
    directional probe's seed discipline, ``tools.probe_scratch_channels``)
  - augs: add_reverb + reduce_volume (committed lineage) + gain_ramp (the
    within-clip fading analog the probe validated)
  - confuser textures: granular drone impact_chain crackle at frac 0.2,
    placement PROTECTED (the only variant that closed the real-music class,
    docs/FT_HISNR_r04.json)
  - SNR range: committed -5..20 dB (the -12 floor was rejected,
    docs/FT_SNRFLOOR_r04.json); no boundary weighting (rejected,
    docs/FT_BOUNDARY_r04.json)

The trainer (``python -m softspoken_tpu_torch.cli train --synthetic``)
aborts with exit code 86 after ``--stall-abort`` seconds without a step;
this supervisor then RESUMES from the run's own checkpoint,
``<workdir>/ckpt_r05.pth`` (saved every 25 outer calls and at the end,
``train/fit.py``), instead of restarting from zero.  Any other exit code is
retried only when the checkpoint moved: a deterministic failure stops it.
Rerunning the supervisor resumes too; a workdir that holds another
recipe is refused.

The gate that follows is ``tools.retrain_gate_r05``.

    python -m softspoken_tpu_torch.tools.train_r05 [--workdir DIR]
        [--steps 48000] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

from ..ckpt import load_pth
from . import OUT_DIR, REPO_ROOT, add_device_arg
from .ftlib import STALL_EXIT, scratch_train_cmd

RECIPE = {
    "steps": 48000,
    "batch_size": 128,
    "lr": "1e-3",
    "seed": 31337,
    "augment": ["add_reverb", "reduce_volume", "gain_ramp"],
    "noise_extra": ["granular", "drone", "impact_chain", "crackle"],
    "noise_extra_frac": 0.2,
    "noise_extra_policy": "protected",
    "snr": (-5.0, 20.0),
    "from_scratch": True,
    "plan": "docs/ROUND5_PLAN.md",
}
QUICK_STEPS, QUICK_BATCH = 80, 2  # --quick: a smoke of the full flag set


def ckpt_epoch(path: str) -> int:
    """Completed steps of the run's checkpoint (``epoch`` of the .pth): 0
    when there is none or it cannot be read.  ``save_pth`` replaces the
    file atomically, so a crash mid-save leaves the previous checkpoint and
    a stray ``.tmp`` beside it, never half a file under this name."""
    if not os.path.exists(path):
        return 0
    try:
        _sd, epoch = load_pth(path)
    except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
        print(f"checkpoint {path} unreadable ({e}); treating as no checkpoint", flush=True)
        return 0
    return max(0, epoch)


def trainer_cmd(args, total: int, done: int, ckpt: str) -> list:
    """The trainer for the steps still to go, resuming from ``ckpt`` once
    it holds any (``--resume`` and ``--out`` are the same file)."""
    flags = ["--lr", RECIPE["lr"], "--seed", str(RECIPE["seed"]),
             "--augment", *RECIPE["augment"],
             "--noise-extra", *RECIPE["noise_extra"],
             "--noise-extra-frac", str(RECIPE["noise_extra_frac"]),
             "--noise-extra-policy", RECIPE["noise_extra_policy"],
             "--snr-min", str(RECIPE["snr"][0]), "--snr-max", str(RECIPE["snr"][1]),
             "--stall-abort", str(args.stall_abort)]
    bs = QUICK_BATCH if args.quick else RECIPE["batch_size"]
    return scratch_train_cmd(sys.executable, ckpt, total - done, bs, flags, args.quick,
                             args.device, resume=ckpt if done > 0 else None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, "work_r05"))
    ap.add_argument("--steps", type=int, default=RECIPE["steps"])
    ap.add_argument("--stall-abort", type=float, default=900.0)
    ap.add_argument("--max-attempts", type=int, default=12)
    ap.add_argument("--quick", action="store_true",
                    help="tiny smoke of the full flag set (CPU ok)")
    add_device_arg(ap)
    return ap


def check_recipe(wd: str, recipe: dict) -> None:
    """Writes ``recipe.json`` into a fresh workdir; refuses one that holds
    a run of another recipe."""
    rec_path = os.path.join(wd, "recipe.json")
    if os.path.exists(rec_path):
        with open(rec_path) as f:
            prev = json.load(f)
        if prev != json.loads(json.dumps(recipe)):
            raise SystemExit(f"{wd} holds a run with a different recipe ({prev}); "
                             "use a fresh --workdir")
    else:
        with open(rec_path, "w") as f:
            json.dump(recipe, f, indent=1)


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    ckpt = os.path.join(wd, "ckpt_r05.pth")
    log_path = os.path.join(wd, "train_r05.log")
    total = QUICK_STEPS if args.quick else args.steps
    recipe = dict(RECIPE, steps=total, quick=bool(args.quick))
    check_recipe(wd, recipe)

    attempt = 0
    t0 = time.time()
    while True:
        done = ckpt_epoch(ckpt)
        if done >= total:
            break
        cmd = trainer_cmd(args, total, done, ckpt)
        if done > 0:
            print(f"resuming from step {done} ({total - done} to go)", flush=True)
        print(f"+ {' '.join(cmd)}  (log: {log_path})", flush=True)
        with open(log_path, "a") as lf:
            lf.write(f"\n=== attempt {attempt} from step {done} "
                     f"at {time.strftime('%F %T')} ===\n")
            lf.flush()
            p = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=REPO_ROOT)
        if p.returncode == 0:
            continue  # the loop re-reads the epoch; it ends when total is reached
        attempt += 1
        if attempt >= args.max_attempts:
            raise SystemExit(f"giving up after {attempt} failed attempts "
                             f"(last rc={p.returncode}) — see {log_path}")
        # 86 = the stall watchdog: retry; any other code gets a bounded retry
        # too, but only while the checkpoint moves — a deterministic crash
        # would otherwise loop max_attempts times
        if p.returncode != STALL_EXIT and ckpt_epoch(ckpt) <= done:
            raise SystemExit(f"trainer exited rc={p.returncode} without progress "
                             f"(step {done}) — not retrying a deterministic failure; "
                             f"see {log_path}")
        print(f"trainer exited rc={p.returncode}; retry {attempt}/"
              f"{args.max_attempts} after checkpoint probe", flush=True)

    out = {"ckpt": ckpt, "steps": ckpt_epoch(ckpt),
           "wall_s": round(time.time() - t0, 1), "recipe": recipe}
    print(json.dumps(out), flush=True)
    print("training complete — next: python -m softspoken_tpu_torch.tools.retrain_gate_r05 "
          f"--workdir {wd}", flush=True)
    return out


if __name__ == "__main__":
    main()
