"""Compare two quality-grid JSONs (``tools/quality_grid.py`` or the JAX
``scripts/quality_grid.py`` output) condition by condition at the parity
operating point — the checkpoint A/B gate.  A copy of
``scripts/compare_grids.py``, so that a machine with the port alone runs it.

    python -m softspoken_tpu_torch.tools.compare_grids OLD.json NEW.json
        [--tol-frame 0.01 --tol-event 0.03]

Prints per-condition frame/event F1 deltas and the summary verdict line.
With the tolerances it also holds NEW to OLD at the parity point and with
the music post-filter (``parity_postfilter``), prints the largest
differences, and exits 1 when one is outside.
"""

from __future__ import annotations

import argparse
import json


def grid(d):
    # quality_grid output: per-condition results under "conditions"; an
    # evidence doc may nest a full grid under grid_after_finetune
    if "conditions" in d and isinstance(d["conditions"], dict):
        return d["conditions"]
    if "grid_after_finetune" in d:
        return grid(d["grid_after_finetune"])
    return {k: v for k, v in d.items()
            if isinstance(v, dict) and "parity" in v}


def hold(a, b, tol_frame, tol_event, keys=("parity", "parity_postfilter")):
    """Every (condition, key) of the conditions both grids hold: the frame
    and event F1 differences (new - old) and whether each is inside its
    tolerance.  A key that either side lacks (a post-filter A/B that was
    skipped) is reported as missing, never as held."""
    rows = []
    for k in (k for k in a if k in b):
        for key in keys:
            pa, pb = a[k].get(key) or {}, b[k].get(key) or {}
            if "frame_f1" not in pa or "frame_f1" not in pb:
                rows.append({"condition": k, "key": key, "missing": True, "ok": False})
                continue
            df = pb["frame_f1"] - pa["frame_f1"]
            de = pb["event_f1"] - pa["event_f1"]
            rows.append({"condition": k, "key": key, "d_frame": df, "d_event": de,
                         "ok": abs(df) <= tol_frame and abs(de) <= tol_event})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--tol-frame", type=float, default=None)
    ap.add_argument("--tol-event", type=float, default=None)
    args = ap.parse_args(argv)
    with open(args.old) as f:
        a = grid(json.load(f))
    with open(args.new) as f:
        b = grid(json.load(f))
    common = [k for k in a if k in b]
    print(f"{'condition':22s} {'frameF1':>8s} {'Δframe':>8s} "
          f"{'eventF1':>8s} {'Δevent':>8s}")
    worst_old = worst_new = ("", 1.0)
    n_better = n_worse = 0
    for k in common:
        pa, pb = a[k]["parity"], b[k]["parity"]
        df = pb["frame_f1"] - pa["frame_f1"]
        de = pb["event_f1"] - pa["event_f1"]
        n_better += df > 0
        n_worse += df < 0
        if pa["frame_f1"] < worst_old[1]:
            worst_old = (k, pa["frame_f1"])
        if pb["frame_f1"] < worst_new[1]:
            worst_new = (k, pb["frame_f1"])
        print(f"{k:22s} {pb['frame_f1']:8.4f} {df:+8.4f} "
              f"{pb['event_f1']:8.4f} {de:+8.4f}")
    print(f"\nconditions better/worse (frame): {n_better}/{n_worse}")
    print(f"worst condition: old {worst_old[0]} {worst_old[1]:.4f} -> "
          f"new {worst_new[0]} {worst_new[1]:.4f}")
    if args.tol_frame is None and args.tol_event is None:
        return 0
    tf = args.tol_frame if args.tol_frame is not None else float("inf")
    te = args.tol_event if args.tol_event is not None else float("inf")
    rows = hold(a, b, tf, te)
    print(f"\n{'condition':22s} {'key':18s} {'Δframe':>8s} {'Δevent':>8s}")
    for r in rows:
        if r.get("missing"):
            print(f"{r['condition']:22s} {r['key']:18s} missing")
        else:
            print(f"{r['condition']:22s} {r['key']:18s} {r['d_frame']:+8.4f} "
                  f"{r['d_event']:+8.4f}{'' if r['ok'] else '  OUTSIDE'}")
    measured = [r for r in rows if not r.get("missing")]
    bad = [r for r in rows if not r["ok"]]
    if measured:
        wf = max(measured, key=lambda r: abs(r["d_frame"]))
        we = max(measured, key=lambda r: abs(r["d_event"]))
        print(f"largest |Δframe| {abs(wf['d_frame']):.4f} ({wf['condition']} {wf['key']}); "
              f"largest |Δevent| {abs(we['d_event']):.4f} ({we['condition']} {we['key']})")
    print(f"held to frame {tf} / event {te}: {len(rows) - len(bad)}/{len(rows)} "
          f"(condition, key) pairs inside")
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    raise SystemExit(main())
