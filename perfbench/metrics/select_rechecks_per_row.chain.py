"""Pairs the small-k selection body's screen passed to its exact recheck, a
selected query row, from the program's ``select_rechecks`` and
``select_rows`` counts (``ops/knn_hopper.py``: the kernel's counter on the
card, read once an estimate by the collector ``MCEvidence`` holds around
it) over the window's units: the sum of the rechecks over the sum of the
rows.  Nothing where the program keeps no such counts or launched no
small-k body."""


def read(r):
    units = r["units"]
    rows = sum(u["timings"].get("select_rows", 0) for u in units)
    if not rows:
        return None
    return sum(u["timings"].get("select_rechecks", 0) for u in units) / rows
