"""The roofline yardstick: the H100's published peaks and the least work
of a self selection, counted from the shapes a cell generates.

Frozen here so that a change to the program cannot move the yardstick:
the peaks and the bound are those of ``mcevidence_tpu_torch/kernel_bench.py``
(``FP32_PEAK``, ``HBM_RATE``, ``bound``), restated for the least work a cell
needs rather than for the kernel that ran.
"""

FP32_PEAK = 67e12    # H100 SXM, f32 outside the tensor cores, flop/s at 700 W
HBM_RATE = 3.35e12   # H100 SXM HBM3, bytes/s


def self_selection(n, d, k):
    """The least f32 work of one self selection of ``n`` rows of width
    ``d`` keeping ``k`` neighbours a row: 2*d flops a pair by the matrix
    identity and 2*d a row for the norms, the rows read once and the
    distances and indices written once.  Returns (flops, bytes)."""
    return 2.0 * d * (n * n + 2.0 * n), 4.0 * n * d + 8.0 * n * k


def bound_seconds(flops, nbytes):
    """The least time the card could take for that work: the larger of the
    operations over the f32 peak and the bytes over the memory rate."""
    return max(flops / FP32_PEAK, nbytes / HBM_RATE)
