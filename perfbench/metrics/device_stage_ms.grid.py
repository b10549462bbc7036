"""Milliseconds a pass of the grid driver spends on the card's stage of its
cells: each cell's prepare and launch (``grid_launch``) and its fetch and
finalize (``grid_fetch``), from the program's spans (``planck.py``) under
the collector held around each pass, summed over the window's completed
passes, over the number of those passes.  The synchronous re-run of a
thin-margin cell is not in it (``reruns_per_pass.grid`` counts those).
Nothing where the program has no grid spans."""


def read(r):
    units = [u for u in r["units"] if "grid_cells" in u["timings"]]
    if not units:
        return None
    return 1e3 * sum(u["timings"].get("grid_launch_s", 0.0)
                     + u["timings"].get("grid_fetch_s", 0.0)
                     for u in units) / len(units)
