"""Mean milliseconds per estimate over the window in the selection, host f64
refine and guard, from the program's own ``MCEvidence.timings["knn_s"]``."""


def read(r):
    vals = [u["timings"]["knn_s"] for u in r["units"]
            if "knn_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
