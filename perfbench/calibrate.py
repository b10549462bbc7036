#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's checks on a
dozen seeds or more and the control's on three or more, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out <file.jsonl>]

The control is the cell's ``control`` parameters (its ``params`` with
the program's lower-precision path switched on).  Prints one JSON line a
run and, last, each number's lower reading (the largest the program gave)
and upper reading (the smallest the control gave).  The benchmark's own
runs never run it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    _, _, cell, _ = run.find_cell(run.ROOT, args.workload)
    sides = [("program", int(s), None) for s in args.seeds.split(",")]
    sides += [("control", int(s), cell["control"])
              for s in args.control_seeds.split(",") if s]
    lines, low, up = [], {}, {}
    for side, seed, over in sides:
        r = run.run_cell(args.workload, seed, args.seconds, 0, args.device,
                         overrides=over)
        line = {"workload": args.workload, "side": side, "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "failed": r["failed"], "compared": r["compared"],
                "check_s": r["check_s"],
                "checks": r["checks"], "card": r.get("card")}
        print(json.dumps(line), flush=True)
        lines.append(line)
        for name, c in r["checks"].items():
            if side == "program":
                low[name] = max(low.get(name, 0.0), c["value"])
            else:
                up[name] = min(up.get(name, float("inf")), c["value"])
    summary = {"workload": args.workload, "lower": low, "upper": up}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for line in lines + [summary]:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
