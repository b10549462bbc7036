"""Estimates whose first device pass had a thin candidate margin and ran
again with more candidates, a unit of the window, from the program's
``device_reruns`` count (``ops/pipeline.py:device_refine_evidence``,
counted at 0 on entry) in each unit's timings.  Nothing where the program
keeps no such count."""


def read(r):
    units = [u for u in r["units"] if "device_reruns" in u["timings"]]
    if not units:
        return None
    return sum(u["timings"]["device_reruns"] for u in units) / len(units)
