"""One caller, closed loop: ln Z estimates of a pool of chains through the
program's entry, back to back, as a single-chain user calls it:

    MCEvidence({"samples", "loglikes", "weights"}, kmax, precision,
               device).evidence()

from host numpy arrays.  The pool (``pool`` distinct chains of the
configuration's shape, from the seed) is cycled.  Parameters:
``precision`` and ``warmup`` (estimates in set-up).  Every estimate the
window produced is compared with the plain reference of its chain.
"""

import time
import traceback

import numpy as np

from gen_chain import chain_pool
from yardstick import self_selection


def setup(ctx):
    from mcevidence_tpu_torch import MCEvidence
    from mcevidence_tpu_torch.ops import knn_hopper
    cfg, p = ctx.config, ctx.params
    state = {"ctx": ctx, "pool": chain_pool(ctx.seed, cfg),
             "MCEvidence": MCEvidence, "knn_hopper": knn_hopper,
             "work": self_selection(cfg["rows"], cfg["ndim"], cfg["kmax"])}
    for i in range(p.get("warmup", 3)):
        estimate(state, i % len(state["pool"]))
    return state


def estimate(state, i):
    from torch.profiler import record_function
    ctx = state["ctx"]
    with record_function("perfbench.MCEvidence"):
        mce = state["MCEvidence"](state["pool"][i], kmax=ctx.config["kmax"],
                                  precision=ctx.params["precision"],
                                  device=ctx.device, verbose=0)
    with record_function("perfbench.evidence"):
        out = mce.evidence()
    return out, dict(mce.timings)


def window(state, seconds, tracer):
    from torch.profiler import record_function
    hopper = state["knn_hopper"]
    hopper.reset_launch_counts()
    npool = len(state["pool"])
    units, errors = [], []
    t0 = time.perf_counter()
    tracer.start_window()
    i = 0
    while time.perf_counter() - t0 < seconds:
        tracer.before_unit()
        ts = time.perf_counter()
        try:
            with record_function("perfbench.estimate"):
                out, timings = estimate(state, i % npool)
        except Exception:
            out, timings = None, {}
            errors.append(traceback.format_exc(limit=3))
        te = time.perf_counter()
        tracer.after_unit(*state["work"])
        units.append({"chain": i % npool, "lnz": out, "wall_s": te - ts,
                      "timings": timings})
        i += 1
    wall = time.perf_counter() - t0
    launches = sum(w.launches for w in hopper.KERNEL_WRAPPERS)
    done = [u for u in units if u["lnz"] is not None]
    return {"units": units, "wall_s": wall, "launches": launches,
            "attempted": len(units), "failed": len(units) - len(done),
            "completed": len(done), "errors": errors, "compared": 0}


def release(state):
    """Free what the program holds on the card before the reference runs."""
    import gc

    import torch
    gc.collect()
    if state["ctx"].device.type == "cuda":
        torch.cuda.empty_cache()


def check(state, rec, limits):
    """The widest gap |ln Z - reference| over every k of every estimate."""
    from reference.knn_evidence import log_evidence
    ctx = state["ctx"]
    refs = {}
    worst = 0.0
    for u in rec["units"]:
        if u["lnz"] is None:
            continue
        c = u["chain"]
        if c not in refs:
            ch = state["pool"][c]
            refs[c] = log_evidence(ch["samples"], ch["loglikes"],
                                   ch["weights"], ctx.config["kmax"],
                                   ctx.device)
        gap = np.abs(np.asarray(u["lnz"], np.float64) - refs[c])
        worst = max(worst, float(np.max(gap)) if np.all(np.isfinite(gap))
                    else float("inf"))
        rec["compared"] += 1
    return [{"name": "max_dlnz", "value": worst,
             "limit": limits["max_dlnz"]}]


def end_to_end(state, rec):
    if not rec["completed"]:
        return {}
    return {"estimate_s": rec["wall_s"] / rec["completed"]}


def layer_inputs(state, rec):
    done = [u for u in rec["units"] if u["lnz"] is not None]
    return {"units": done, "launches": rec["launches"],
            "launches_units": rec["attempted"]}
