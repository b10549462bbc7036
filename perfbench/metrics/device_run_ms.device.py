"""Mean milliseconds per estimate over the window in the device path's run,
from the program's ``device_run`` spans
(``MCEvidence.timings["device_run_s"]``): the launches of
``fused_refine_dotp`` and the host's wait for its kmax+1 scalars, the
retry's included.  Nothing where the program has no such span."""


def read(r):
    vals = [u["timings"]["device_run_s"] for u in r["units"]
            if "device_run_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
