"""Mean milliseconds per estimate over the window in the selection, from the
program's ``select`` spans (``MCEvidence.timings["select_s"]``): the
kernel's launch and the host's wait for the index copy, on every pass,
the guard's reselection included.  Nothing where the program has no such
span."""


def read(r):
    vals = [u["timings"]["select_s"] for u in r["units"]
            if "select_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
