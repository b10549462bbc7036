"""The small-k selection kernel's share of its roofline over the traced
slice of whole grid passes, in %: the least f32 work of the slice's self
selections, one a model a pass, counted from the shapes the benchmark
generated (``yardstick.self_selection`` at the configuration's kmax), at
the card's published peaks, over the device time of the kernels named
below.  Nothing when no such kernel ran in the slice."""

from devtrace import kernel_seconds
from yardstick import bound_seconds

PATTERN = r"knn_small_k_kernel"


def read(r):
    t = r["tracer"]
    if not t.done or not t.units:
        return None
    kernel = kernel_seconds(t.events, PATTERN)
    if kernel <= 0:
        return None
    return 100.0 * bound_seconds(t.flops, t.nbytes) / kernel
