"""Milliseconds a pass of the grid driver spends in its models' prologue
(``.paramnames``, ``.ranges``, the H0 column and the H0 reweight), from the
program's ``grid_prologue`` spans (``planck.py``) under the collector held
around each pass: their sum over the window's completed passes, over the
number of those passes.  Nothing where the program has no grid spans (no
``grid_cells`` count in a pass)."""


def read(r):
    units = [u for u in r["units"] if "grid_cells" in u["timings"]]
    if not units:
        return None
    return 1e3 * sum(u["timings"].get("grid_prologue_s", 0.0)
                     for u in units) / len(units)
