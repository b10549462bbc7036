"""Mean milliseconds per estimate over the window in the uploads to the card,
from the program's ``upload`` spans (``MCEvidence.timings["upload_s"]``):
the copies to the card alone, at refine of the centred f32 coordinates
(``ops/knn.py:exact_knn``), at device of the whitened f64 coordinates and
the scalars (``ops/pipeline.py:_device_refine_prepare``).
Nothing where the program has no such span."""


def read(r):
    vals = [u["timings"]["upload_s"] for u in r["units"]
            if "upload_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
