"""Mean milliseconds per estimate over the window in the host f64 refine,
from the program's ``host_refine`` spans
(``MCEvidence.timings["host_refine_s"]``): the candidates' distances
recomputed in f64, sorted, and the guard's margin test, on every pass, the
reselection's included.  Nothing where the program has no such span."""


def read(r):
    vals = [u["timings"]["host_refine_s"] for u in r["units"]
            if "host_refine_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
