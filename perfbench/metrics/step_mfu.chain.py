"""The whole step's share of the card's f32 peak over the traced slice, in
%: the least f32 work of the slice's self selections (counted from the
generated shapes) over the slice's length at 67 TFLOP/s.  It bounds the
kernels' share from above whatever kernel runs."""

from yardstick import FP32_PEAK


def read(r):
    t = r["tracer"]
    if not t.done or not t.units or not t.window_s:
        return None
    return 100.0 * t.flops / (t.window_s * FP32_PEAK)
