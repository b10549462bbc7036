"""Mean milliseconds per estimate over the window in the device path's host
prep, from the program's ``device_prep`` spans
(``MCEvidence.timings["device_prep_s"]``): the f64 cast, centring,
covariance, whitening statistics, rotation, ``exp`` and contiguous copies
of ``ops/pipeline.py:_device_refine_prepare``, the retry's included.
Nothing where the program has no such span."""


def read(r):
    vals = [u["timings"]["device_prep_s"] for u in r["units"]
            if "device_prep_s" in u["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
