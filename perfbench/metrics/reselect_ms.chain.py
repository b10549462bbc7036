"""Milliseconds per estimate over the window in the guard's reselection,
from the program's ``reselect`` spans (``MCEvidence.timings["reselect_s"]``:
at refine the second selection and refine of ``ops/knn.py``'s guard, at
device the thin-margin re-run of ``ops/pipeline.py``): their sum over every
completed estimate, over the number of those estimates, so that an
estimate that did not reselect counts 0.  Nothing where the program has
no spans (no ``evidence_s``, the root span of every estimate)."""


def read(r):
    units = [u for u in r["units"] if "evidence_s" in u["timings"]]
    if not units:
        return None
    return 1e3 * sum(u["timings"].get("reselect_s", 0.0)
                     for u in units) / len(units)
