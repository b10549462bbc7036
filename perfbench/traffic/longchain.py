"""One caller, closed loop, over a pool of long chains: ``chain.py``'s
set-up, estimate, release and readings as they are, with a window that
ends on whole passes over the pool and a check against the long-chain
reference.

The window runs at least ``seconds`` and then on to the end of the pool's
current pass, so that each chain counts the same number of times in every
run: chains whose estimate costs more (a thin-margin retry) would
otherwise weigh by where a run happens to stop.  Every estimate of the
window is compared with ``reference/knn_evidence_long.py``, one reference
a pool chain.
"""

import importlib.util
import os
import time
import traceback

import numpy as np


def _load_chain():
    """``chain.py`` beside this file (the traffic directory is not on the
    import path)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chain.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_traffic_longchain_chain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_chain = _load_chain()
setup, estimate, release = _chain.setup, _chain.estimate, _chain.release
end_to_end, layer_inputs = _chain.end_to_end, _chain.layer_inputs


def window(state, seconds, tracer):
    from torch.profiler import record_function
    hopper = state["knn_hopper"]
    hopper.reset_launch_counts()
    npool = len(state["pool"])
    units, errors = [], []
    t0 = time.perf_counter()
    tracer.start_window()
    i = 0
    while i % npool or time.perf_counter() - t0 < seconds:
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


def check(state, rec, limits):
    """The widest gap |ln Z - reference| over every k of every estimate."""
    from reference.knn_evidence_long import log_evidence
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
