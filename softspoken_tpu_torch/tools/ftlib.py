"""Shared scaffold of the staged fine-tune experiments (``ft_music``,
``ft_synth3``, ``ft_hisnr``, ``ft_boundary``, ``ft_snrfloor``): subprocess
stages with logs, and restart safety by fingerprint, not by existence.

The port of ``scripts/ftlib.py``.  An output that exists from a run with
other parameters (a ``--quick`` smoke, another learning rate) in the same
workdir must never be reused under the current parameters' name: ``stage``
writes a ``<output>.fp.json`` fingerprint of the parameters that produced
each output; a rerun with the same parameters skips the stage, a rerun with
other parameters refuses and names the mismatch (use a fresh --workdir).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from . import DEFAULT_CKPT, DOCS, REPO_ROOT

STALL_EXIT = 86  # the trainer's stall-abort (train/fit.py, --stall-abort)


def run(cmd, log_path, retries=0, retry_rcs=(STALL_EXIT,)):
    """Run a stage command from the repository root, its output appended to
    ``log_path`` and its wall seconds printed; retry (at most ``retries``
    times) on a retryable exit code.

    86 is the trainer's stall-abort: no step completed within
    ``--stall-abort`` seconds, so the same command is run again."""
    for attempt in range(retries + 1):
        print(f"+ {' '.join(cmd)}  (log: {log_path})", flush=True)
        t0 = time.perf_counter()
        with open(log_path, "a") as lf:
            p = subprocess.run(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=REPO_ROOT)
        if p.returncode == 0:
            print(f"  done in {time.perf_counter() - t0:.1f} s", flush=True)
            return
        if attempt < retries and p.returncode in retry_rcs:
            print(f"stage exited {p.returncode} (retryable stall) — retry "
                  f"{attempt + 1}/{retries}", flush=True)
            continue
        raise SystemExit(f"stage failed ({p.returncode}): {' '.join(cmd)} — see {log_path}")


def stage(name: str, done_path: str, fingerprint: dict, fn) -> None:
    """Run ``fn()`` unless ``done_path`` already exists WITH a matching
    parameter fingerprint.  An existing output with a different (or
    missing) fingerprint aborts loudly instead of being silently reused."""
    fp_path = done_path.rstrip("/") + ".fp.json"
    if os.path.exists(done_path):
        prev = None
        if os.path.exists(fp_path):
            with open(fp_path) as f:
                prev = json.load(f)
        if prev == fingerprint:
            print(f"{name} skipped: {done_path} exists (same parameters)", flush=True)
            return
        raise SystemExit(
            f"{name}: {done_path} exists but was produced with different "
            f"parameters ({prev} != {fingerprint}) — refusing to reuse it; "
            "use a fresh --workdir")
    fn()
    if not os.path.exists(done_path):
        raise SystemExit(f"{name}: expected output {done_path} missing")
    with open(fp_path, "w") as f:
        json.dump(fingerprint, f)


# ---------------------------------------------------------------------------
# the stages' commands, as the JAX drivers build them, on the port's modules

def device_args(device) -> list:
    """``--device D`` for a stage when the driver was given one (the stages
    run on the card otherwise)."""
    return ["--device", device] if device else []


def train_cmd(py, cand, steps, bs, lr, seed, flags, quick, device) -> list:
    """Stage 1: fine-tune the committed checkpoint (``--resume``, a .pth)
    into ``cand`` with the recipe's own train ``flags``."""
    cmd = [py, "-m", "softspoken_tpu_torch.cli", "train", "--synthetic",
           "--resume", DEFAULT_CKPT, "--out", cand,
           "--steps", str(steps), "--batch-size", str(bs), "--lr", str(lr),
           *flags, "--seed", str(seed)]
    if quick:
        cmd += ["--n-inner", "2", "--pool-size", "16"]
    return cmd + device_args(device)


def scratch_train_cmd(py, out, steps, bs, flags, quick, device, resume=None) -> list:
    """Training from scratch (the round-5 retrain and its probe) into
    ``out`` with the recipe's own train ``flags``; ``resume`` continues a
    run of the same recipe from its own last checkpoint (never the
    committed one)."""
    cmd = [py, "-m", "softspoken_tpu_torch.cli", "train", "--synthetic",
           "--out", out, "--steps", str(steps), "--batch-size", str(bs), *flags]
    if quick:
        cmd += ["--n-inner", "2", "--pool-size", "16"]
    if resume:
        cmd += ["--resume", resume]
    return cmd + device_args(device)


def grid_cmd(py, cand, grid_json, wd, quick, device, workdir=True,
             postfilter_ab=True, files=None, seconds=None) -> list:
    """Stage 2: the quality grid of the candidate.  An explicit --out: the
    grid's --quick redirect only fires for its default path, so the output
    lands in the workdir."""
    cmd = [py, "-m", "softspoken_tpu_torch.tools.quality_grid", "--ckpt", cand,
           "--out", grid_json]
    if files is not None:
        cmd += ["--files", str(files), "--seconds", str(seconds)]
    cmd += ["--cache-dir", os.path.join(wd, "grid_cache")]
    if workdir:
        cmd += ["--workdir", os.path.join(wd, "grid_work")]
    if not postfilter_ab:
        cmd.append("--no-postfilter-ab")
    if quick:
        cmd.append("--quick")
    return cmd + device_args(device)


def real_cmd(py, cand, real_json, quick, device, data_dir=None, workdir=None) -> list:
    """Stage 3: the real-audio probe of the candidate."""
    cmd = [py, "-m", "softspoken_tpu_torch.tools.real_audio_check", "--ckpt", cand,
           "--out", real_json]
    if workdir:
        cmd += ["--workdir", workdir]
    if data_dir:
        cmd += ["--data-dir", data_dir]
    if quick:
        cmd.append("--quick")
    return cmd + device_args(device)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def committed(name: str) -> dict:
    """A committed record under ``docs/`` (the verdicts' baselines)."""
    return load_json(os.path.join(DOCS, name))


def write_verdict(verdict: dict, path: str, summary_keys) -> None:
    """The verdict JSON, and its headline keys on stdout."""
    with open(path, "w") as f:
        json.dump(verdict, f, indent=2)
    print(json.dumps({k: verdict[k] for k in summary_keys}, indent=2), flush=True)
    print(f"wrote {path}", flush=True)


def music_false_fraction(real: dict) -> float:
    return real["false_positives_on_real_audio"]["music_house"]["false_fraction"]


def frame_f1_deltas(conds_c: dict, conds_0: dict, drop: float):
    """(regressed tags, per-condition {committed, candidate, delta} of the
    parity frame F1, the v2 worst case of the candidate) over the
    candidate's conditions, as every driver computes them: a tag regresses
    when its F1 falls more than ``drop`` below the committed one."""
    regressions, per_condition = [], {}
    worst_c = 1.0
    for tag, res_c in conds_c.items():
        f1_c = res_c["parity"]["frame_f1"]
        if tag.startswith("v2"):
            worst_c = min(worst_c, f1_c)
        res_0 = conds_0.get(tag)
        if res_0 is None:
            continue
        f1_0 = res_0["parity"]["frame_f1"]
        per_condition[tag] = {"committed": f1_0, "candidate": f1_c,
                              "delta": round(f1_c - f1_0, 4)}
        if f1_c < f1_0 - drop:
            regressions.append(tag)
    return regressions, per_condition, worst_c


def v2_worst(conds: dict) -> float:
    return min(r["parity"]["frame_f1"] for t, r in conds.items() if t.startswith("v2"))


STAGE_LOGS = {"train": ("stage 1 (train)", "train.log"),
              "grid": ("stage 2 (grid)", "grid.log"),
              "real": ("stage 3 (real-audio)", "real.log")}


def run_stages(wd: str, recipe: dict, cmds: dict, train_retries: int = 0) -> None:
    """The driver's stages in order (``cmds``: "train", "grid" and, for the
    music-guarded drivers, "real", each ``(done path, argv)``), each one
    skipped or refused by ``stage`` under the recipe's fingerprint."""
    for key, (done, cmd) in cmds.items():
        label, log = STAGE_LOGS[key]
        retries = train_retries if key == "train" else 0
        stage(label, done, recipe,
              lambda cmd=cmd, log=log, retries=retries:
              run(cmd, os.path.join(wd, log), retries=retries))
