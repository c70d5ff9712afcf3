"""Readings that a cell's limits are set from, on the card:

    python3 -m port_bench.calibrate --workload design.rna --seeds 1,2,3 \\
        --seconds 10 [--controls tf32] [--fault token]

In one process, for each seed: one run of the cell with the program (its
numbers compared and its metrics) and, for each control precision, the
numbers the reference in that precision gives in the program's place on
the same requests. With ``--fault`` the program is broken first
(``faults.py``) and the numbers of the broken runs are read. One JSON line
per run on standard output, and in ``chiprun_out/calibration/`` where that
folder exists.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import faults
from .run import ROOT, forbidden_modules, run_cell


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--controls", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--trace", type=int, default=0)
    args = p.parse_args(argv)
    controls = tuple(c for c in args.controls.split(",") if c)
    plant = faults.FAULTS[args.fault] if args.fault else None
    out_dir = os.path.join(ROOT, "chiprun_out", "calibration")
    for seed in [int(s) for s in args.seeds.split(",")]:
        result, checks, extra = run_cell(args.workload, seed, args.seconds,
                                         bool(args.trace), "cuda", plant=plant,
                                         controls=controls)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault or None, "correct": result["correct"],
                           "readings": {k: v for k, v, _ in checks},
                           "controls": extra, "metrics": result["metrics"],
                           "attempted": result["attempted"],
                           "device": result["device"]})
        print(line, flush=True)
        if os.path.isdir(os.path.dirname(out_dir)):
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, args.workload + ".jsonl"), "a") as f:
                f.write(line + "\n")
    if forbidden_modules():
        print("forbidden modules loaded: " + ", ".join(forbidden_modules()), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
