"""Estimates that asked for ``device`` precision and were handed to the host
refine path (a chain wider than the kernels' layouts, a plan over the
memory budget, a non-finite sum, an unsupported request), a unit of the
window, from the program's ``device_fallbacks`` count
(``ops/pipeline.py``, ``evidence.py``: counted at 0 when the device path
is entered) in each unit's timings.  Nothing where the program keeps no
such count."""


def read(r):
    units = [u for u in r["units"] if "device_fallbacks" in u["timings"]]
    if not units:
        return None
    return sum(u["timings"]["device_fallbacks"] for u in units) / len(units)
