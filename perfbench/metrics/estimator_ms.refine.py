"""Mean milliseconds per estimate over the window in the host f64 estimator,
from the program's own ``MCEvidence.timings["estimator_s"]``."""


def read(r):
    vals = [u["timings"]["estimator_s"] for u in r["units"]
            if "estimator_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
