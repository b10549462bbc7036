"""Cells a pass of the grid driver re-runs synchronously
(``device_refine_evidence``) because their first result had a thin margin
or a value that is not finite, from the program's ``grid_reruns`` count
(``planck.py``) under the collector held around each pass, over the
window's completed passes.  Nothing where the program has no grid
counts."""


def read(r):
    units = [u for u in r["units"] if "grid_cells" in u["timings"]]
    if not units:
        return None
    return sum(u["timings"].get("grid_reruns", 0)
               for u in units) / len(units)
