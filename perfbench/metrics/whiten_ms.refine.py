"""Mean milliseconds per estimate over the window in the host f64 whitening,
from the program's own ``MCEvidence.timings["whiten_s"]``."""


def read(r):
    vals = [u["timings"]["whiten_s"] for u in r["units"]
            if "whiten_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
