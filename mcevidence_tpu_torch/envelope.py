"""One card's N envelope: the fast and device paths end to end as N grows.

The counterpart of the repository's ``scripts/bench_envelope.py``.  Run as

    python -m mcevidence_tpu_torch.envelope [max_pow] [d]
        [--min-pow P] [--device cuda|cpu]

For N = 2^P .. 2^max_pow (defaults 17, 20) at width d (default 8) and
kmax = 5 it draws the chain of ``chain`` (a standard normal, seed 0, lnL =
-0.5 sum theta^2) and times ``fast_auto_evidence`` and
``device_refine_auto_evidence`` end to end (host prep, copies, the card's
work, the fetch), each on its second call after a warm one (``timed``).
Beside each point it prints the device path's memory plan
(``estimate_device_refine_bytes`` at k_sel = kmax + 4) and the budget
(``device_budget_bytes``).

Prints a table, and after each row one JSON line: ``n``, ``d``, ``kmax``,
``plan_gib``, ``budget_gib``, ``fast_s``, ``fast_pairs_per_s``,
``device_s``, ``dlnz_fast_dev`` (max |fast - device| over k), both ln Z
rows, ``launches`` (the kernel wrappers' launch counts over the point, and
``plain_on_cuda``, the CUDA tensors that reached the plain selection) and
``gpu``.  A point whose estimate raises prints a line with ``error``; the
run goes on past a failed device estimate, stops at a failed fast one, and
exits 1 if any point failed.
"""

from __future__ import annotations

import json
import sys
import time
from argparse import ArgumentParser

import numpy as np

KMAX = 5


def chain(n, d, seed=0):
    """The envelope's chain: standard-normal rows, lnL = -0.5 |theta|^2."""
    rng = np.random.default_rng(seed)
    th = rng.normal(size=(n, d))
    lnl = -0.5 * np.sum(th * th, axis=1)
    return th, lnl


def timed(fn, *args, **kw):
    """(seconds, result) of the second of two calls: the first warms."""
    fn(*args, **kw)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return time.perf_counter() - t0, out


def _launches(kh):
    out = {w.__name__: w.launches for w in kh.KERNEL_WRAPPERS}
    out["plain_on_cuda"] = kh.plain_cuda_calls
    return out


def point(n, d, dev, gpu=None):
    """One envelope point; returns its record (``error`` and ``failed``,
    the path that raised, when one did)."""
    from .ops import knn_hopper as kh
    from .ops import pipeline
    th, lnl = chain(n, d)
    plan = pipeline.estimate_device_refine_bytes(n, n, d, KMAX + 4)
    budget = pipeline.device_budget_bytes(dev)
    rec = {"n": n, "d": d, "kmax": KMAX, "plan_gib": plan / 2 ** 30,
           "budget_gib": None if budget is None else budget / 2 ** 30}
    kh.reset_launch_counts()
    for path, fn in (("fast", pipeline.fast_auto_evidence),
                     ("device", pipeline.device_refine_auto_evidence)):
        try:
            sec, lnz = timed(fn, th, lnl, kmax=KMAX, device=dev)
        except Exception as exc:       # reported, and the run exits 1
            rec.update(failed=path, error=f"{type(exc).__name__}: {exc}")
            break
        rec[f"{path}_s"] = sec
        rec[f"lnz_{path}"] = np.asarray(lnz, np.float64).tolist()
        if path == "fast":
            rec["fast_pairs_per_s"] = float(n) * n / sec
    if "lnz_device" in rec:
        rec["dlnz_fast_dev"] = float(np.max(np.abs(
            np.asarray(rec["lnz_fast"]) - np.asarray(rec["lnz_device"]))))
    rec["launches"] = _launches(kh)
    rec["gpu"] = gpu
    return rec


def main(argv=None) -> int:
    p = ArgumentParser(prog="python -m mcevidence_tpu_torch.envelope",
                       description="fast and device evidence end to end "
                                   "from 2^min_pow to 2^max_pow rows; one "
                                   "JSON line a point")
    p.add_argument("max_pow", nargs="?", type=int, default=20)
    p.add_argument("d", nargs="?", type=int, default=8)
    p.add_argument("--min-pow", type=int, default=17)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails without a GPU) or 'cpu' "
                        "(the plain PyTorch selection)")
    args = p.parse_args(argv)
    from .ops.pipeline import device_budget_bytes
    from .utils.device import gpu_name_and_power_limit, resolve_device
    dev = resolve_device(args.device)
    gpu = gpu_name_and_power_limit() if dev.type == "cuda" else None
    budget = device_budget_bytes(dev)
    print(f"device={dev} gpu={gpu} d={args.d} kmax={KMAX} budget="
          + ("none" if budget is None else f"{budget / 2 ** 30:.1f} GiB"))
    print(f"{'N':>9} {'plan GiB':>9} {'fast s':>8} {'fast pairs/s':>13} "
          f"{'device s':>9} {'dlnz fast-dev':>13}", flush=True)
    failed = False
    for pw in range(args.min_pow, args.max_pow + 1):
        rec = point(2 ** pw, args.d, dev, gpu)
        n, plan = rec["n"], rec["plan_gib"]
        if "fast_s" in rec:
            head = (f"{n:>9} {plan:>9.2f} {rec['fast_s']:>8.2f} "
                    f"{rec['fast_pairs_per_s']:>13.3g}")
        else:
            head = f"{n:>9} {plan:>9.2f}"
        if "error" in rec:
            failed = True
            print(f"{head} {rec['failed']} FAILED: {rec['error']}")
        else:
            print(f"{head} {rec['device_s']:>9.2f} "
                  f"{rec['dlnz_fast_dev']:>13.2e}")
        print(json.dumps(rec), flush=True)
        if rec.get("failed") == "fast":
            break
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
