"""The share of the card's idle time inside the traced estimates that no
span of the program covers, in %.  Over the union of the slice's
``perfbench.estimate`` annotations, the idle time is what the union of
kernel, copy and set spans leaves; of it, the part under no ``mce.*``
annotation of the program (``mce.evidence``, the root of every estimate,
left out) is the idle time that the program's spans cannot yet put down
to a step.  Nothing where the trace holds no ``mce.*`` annotation."""

from devtrace import device_spans

ROOT = "mce.evidence"


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _subtract(keep, cut):
    """The parts of ``keep`` outside ``cut``, both disjoint and sorted."""
    out, j = [], 0
    for a, b in keep:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append([a, cut[k][0]])
            a = max(a, cut[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _annotations(events, keep):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and keep(e["name"])]


def read(r):
    t = r["tracer"]
    if not t.done:
        return None
    spans = _annotations(t.events, lambda n: n.startswith("mce."))
    if not spans:
        return None
    estimates = _union(_annotations(t.events,
                                    lambda n: n == "perfbench.estimate"))
    idle = _subtract(estimates,
                     _union((a, b) for a, b, _ in device_spans(t.events)))
    steps = _union(_annotations(
        t.events, lambda n: n.startswith("mce.") and n != ROOT))
    idle_us = sum(b - a for a, b in idle)
    if idle_us <= 0:
        return None
    return 100.0 * sum(b - a for a, b in _subtract(idle, steps)) / idle_us
