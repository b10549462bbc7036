"""100 less the device-busy share of the traced slice, in %: the union of
kernel, copy and set spans over the slice's host-clock length."""


def read(r):
    t = r["tracer"]
    if not t.done or not t.window_s:
        return None
    return 100.0 * (1.0 - r["busy_s"] / t.window_s)
