#!/usr/bin/env python3
"""The control: the plain reference in the program's place, one precision
lower than the configuration states, through the whole run and check.

    python3 benchmarks/control.py --workload <cell> --seeds 1 2 3 --seconds 5
    python3 benchmarks/control.py --workload <cell> --seeds 1 2 3 --fault half_batch

Each driver's ``use_control`` runs the control the configuration names
(``control``): a detection cell's detector answers every file with the
reference chain in fp8 (``reference/quant.py``) in the program's place; a
training cell runs the program's own bfloat16 path.  ``--fault`` plants one
of the driver's faults (``plant_fault``) instead.  The rest of the run and
its check are the run's own, and the check has to come out not correct:
each seed's compared numbers are the readings a limit's upper end is set
from.  The benchmark's own runs never run this.  Prints one JSON line per
seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", help="plant this fault instead of the control")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO_DIR)
    from benchmarks import run
    from benchmarks.harness import registry

    run.set_cache_env()
    precision = registry.find_cell(args.workload).config["control"]

    def hook(driver):
        if args.fault:
            driver.plant_fault(args.fault)
        else:
            driver.use_control(precision)

    for seed in args.seeds:
        result, checks = run.run_cell(args.workload, seed, args.seconds, False,
                                      driver_hook=hook)
        print(json.dumps({"seed": seed, "control": args.fault or precision,
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
