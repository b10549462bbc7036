"""Mean milliseconds per estimate over the window in the refine path's host
prep before the upload, from the program's ``host_prep`` spans
(``MCEvidence.timings["host_prep_s"]``): the f64 centring and the f32 cast
on the host in ``ops/knn.py:exact_knn``.  Nothing where the program has no
such span."""


def read(r):
    vals = [u["timings"]["host_prep_s"] for u in r["units"]
            if "host_prep_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
