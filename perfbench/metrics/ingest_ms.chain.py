"""Mean milliseconds per estimate over the window in the array ingest (the
constructor: the chain's records, burn, thin and split), from the program's
own ``MCEvidence.timings["ingest_s"]``."""


def read(r):
    vals = [u["timings"]["ingest_s"] for u in r["units"]
            if "ingest_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
