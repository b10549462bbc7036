"""Row slices a file of the grid driver's pass was decoded in, one thread a
slice, from the program's ``parse_slices`` and ``parse_files`` counts
(``chains/reader.py``, handed back by ``planck.py``'s prefetch threads)
under the collector held around each pass: the sum of the slices over the
sum of the files, over the window's completed passes.  Nothing where the
program has no grid counts (no ``grid_cells`` count in a pass), or counts
no parsed file."""


def read(r):
    units = [u for u in r["units"] if "grid_cells" in u["timings"]]
    files = sum(u["timings"].get("parse_files", 0) for u in units)
    if not files:
        return None
    return sum(u["timings"].get("parse_slices", 0) for u in units) / files
