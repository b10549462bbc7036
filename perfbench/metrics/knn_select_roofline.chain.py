"""The selection kernels' share of their roofline over the traced slice,
in %: the least f32 work of the slice's self selections, counted from the
shapes the benchmark generated (``yardstick.self_selection``), at the
card's published peaks, over the device time of the port's selection
kernels, found by the name pattern below.  Nothing when no such kernel
ran in the slice."""

from devtrace import kernel_seconds
from yardstick import bound_seconds

PATTERN = r"knn_(small_k|large_k|warp|list)_kernel"


def read(r):
    t = r["tracer"]
    if not t.done or not t.units:
        return None
    kernel = kernel_seconds(t.events, PATTERN)
    if kernel <= 0:
        return None
    return 100.0 * bound_seconds(t.flops, t.nbytes) / kernel
