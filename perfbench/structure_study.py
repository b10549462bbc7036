#!/usr/bin/env python3
"""The chain cells' pools against independently drawn chains.

    python3 perfbench/structure_study.py --seeds 1,2,... [--config
        planck-chain-65k] [--precisions refine,device] [--out <file.jsonl>]

The cells' chains share the configuration's ``structure_seed`` (their
standard-normal points), so every seed does the same work.  This study
draws each seed's pool with its points from the seed as well, runs every
chain once through ``MCEvidence(...).evidence()`` at each precision, and
prints one JSON line a chain and precision: the kernel launches it took
(two or more: the guard reselected), its wall time and its widest gap
|ln Z - reference| over every k.  Last, for each precision, the share of
chains that reselected, the largest gap (the lower reading on these
chains) and the median wall.  The benchmark's own runs never run it.
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

from gen_chain import chain_pool  # noqa: E402
from reference.knn_evidence import log_evidence  # noqa: E402

# added to a seed to give the points a stream of their own
POINTS_OFFSET = 2 ** 62


def launches(hopper):
    return sum(w.launches for w in hopper.KERNEL_WRAPPERS)


def main(argv=None):
    p = argparse.ArgumentParser(prog="perfbench/structure_study.py")
    p.add_argument("--seeds", required=True)
    p.add_argument("--config", default="planck-chain-65k")
    p.add_argument("--precisions", default="refine,device")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch
    from mcevidence_tpu_torch import MCEvidence
    from mcevidence_tpu_torch.ops import knn_hopper
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as fh:
        cfg = json.load(fh)
    device = torch.device(args.device)
    precisions = args.precisions.split(",")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = chain_pool(seed, dict(cfg,
                                     structure_seed=seed + POINTS_OFFSET))
        for i, ch in enumerate(pool):
            ref = log_evidence(ch["samples"], ch["loglikes"], ch["weights"],
                               cfg["kmax"], device)
            for prec in precisions:
                n0 = launches(knn_hopper)
                t0 = time.perf_counter()
                lnz = MCEvidence(ch, kmax=cfg["kmax"], precision=prec,
                                 device=device, verbose=0).evidence()
                wall = time.perf_counter() - t0
                gap = float(np.max(np.abs(np.asarray(lnz, np.float64)
                                          - ref)))
                line = {"seed": seed, "chain": i, "precision": prec,
                        "launches": launches(knn_hopper) - n0,
                        "wall_s": wall, "max_dlnz": gap}
                print(json.dumps(line), flush=True)
                lines.append(line)
    summary = {}
    for prec in precisions:
        rows = [ln for ln in lines if ln["precision"] == prec]
        summary[prec] = {
            "chains": len(rows),
            "reselected": sum(ln["launches"] > 1 for ln in rows),
            "max_dlnz": max(ln["max_dlnz"] for ln in rows),
            "median_wall_s": statistics.median(ln["wall_s"] for ln in rows),
            "launches_per_estimate": (sum(ln["launches"] for ln in rows)
                                      / len(rows))}
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            for line in lines + [{"summary": summary}]:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
