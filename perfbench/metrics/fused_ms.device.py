"""Mean milliseconds per estimate over the window in the device pipeline
(whitening prep, selection, f64 refine and reduction on the card, the
scalar fetch), from the program's own ``MCEvidence.timings["fused_s"]``."""


def read(r):
    vals = [u["timings"]["fused_s"] for u in r["units"]
            if "fused_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
