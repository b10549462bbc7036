"""Percent of the fields a pass of the grid driver converts from text that
the native parser's fixed-layout decoder takes (CosmoMC's ``%16.7E``), from
the program's ``parse_fields`` and ``parse_fields_fixed`` counts
(``chains/reader.py``, handed back by ``planck.py``'s prefetch threads)
under the collector held around each pass: 100 times the sum of the fixed
over the sum of all, over the window's completed passes.  Nothing where
the program has no grid counts (no ``grid_cells`` count in a pass), or
counts no parsed field."""


def read(r):
    units = [u for u in r["units"] if "grid_cells" in u["timings"]]
    fields = sum(u["timings"].get("parse_fields", 0) for u in units)
    if not fields:
        return None
    return 100.0 * sum(u["timings"].get("parse_fields_fixed", 0)
                       for u in units) / fields
