"""Grid benchmark: the Planck grid program at its defaults, cold and warm.

The counterpart of the repository's ``scripts/bench_grid_r3.py``.  Runs
``mcevidence_tpu_torch.planck.main`` at its defaults (batched cells,
``device`` precision) ``runs`` times in ONE process over a grid directory,
in AllChains mode or per chain (``nchain`` > 0: ``-nc nchain``), with a
parse cache in a temporary directory: run 0 pays the kernel library's load
and a cold parse cache, later runs are the steady state.  Run i writes its
tables under ``<outbase>_run<i>``.

Usage::

    python -m mcevidence_tpu_torch.bench_grid <griddir> <outbase>
        [nchain] [runs] [--device cuda|cpu]

Prints each run's exit code and wall, then ONE JSON line last; exits 1 if
any run failed.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from argparse import ArgumentParser


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.bench_grid",
                       description="the Planck grid program's wall time, "
                                   "cold and warm in one process")
    p.add_argument("griddir")
    p.add_argument("outbase")
    p.add_argument("nchain", nargs="?", type=int, default=0,
                   help="per-chain mode with this many chains (default 0: "
                        "AllChains)")
    p.add_argument("runs", nargs="?", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = p.parse_args(argv)
    from .planck import main as planck_main
    from .utils.device import gpu_name_and_power_limit, resolve_device
    device = str(resolve_device(args.device))
    runs = []
    with tempfile.TemporaryDirectory(prefix="mce_pcache_") as cache:
        base = ["--rootdir", args.griddir, "-v", "0", "--parse-cache", cache,
                "--device", device]
        if args.nchain:
            base += ["-nc", str(args.nchain)]
        for i in range(args.runs):
            out = f"{args.outbase}_run{i}"
            t0 = time.perf_counter()
            rc = planck_main([*base, "-o", out])
            wall = time.perf_counter() - t0
            print(f"RUN {i}: rc={rc} wall={wall:.3f}s "
                  f"({'cold' if i == 0 else 'warm'} process-internal)",
                  flush=True)
            runs.append({"run": i, "rc": rc, "wall_s": wall, "out": out})
    print(json.dumps({
        "metric": "grid_wall_s", "device": device,
        "mode": f"-nc {args.nchain}" if args.nchain else "AllChains",
        "griddir": args.griddir, "runs": runs,
        "cold_wall_s": runs[0]["wall_s"] if runs else None,
        "warm_wall_s": [r["wall_s"] for r in runs[1:]],
        "gpu": gpu_name_and_power_limit()}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
