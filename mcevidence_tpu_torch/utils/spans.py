"""Spans inside the estimate path.

``span(name)`` marks one step of an estimate.  Under a collector
(``collect(timings, spans)``, which ``MCEvidence`` holds around its
constructor's ingest and around each ``evidence()`` call) a span adds its
``perf_counter`` seconds to ``timings[name + "_s"]``, summed over the
step's runs, and appends ``(name, parent, start, end)`` to ``spans``
(``parent`` is the name of the span it ran in, or None).  A collector
entered inside another also hands each record to the one around it, so
the caller of a driver that holds its own collector (the grid driver holds
one for each dataset) sees the driver's spans too.  ``count(name)`` adds to
``timings[name]`` under the same collectors: counts keep their bare name.
``device_count(name, device)`` gives a kernel an int64 counter on the card
for the count ``name``: the collector reads it once, when its block ends
(after the block's own last fetch, so the read waits for nothing new), and
adds it as ``count(name, n)``; with no collector it gives None, and nothing
is read.

While a ``torch.profiler`` profile is on, a span is also a
``record_function("mce.<name>")``, a ``user_annotation`` on the profiler's
clock beside the kernels and copies.  With no profile on, no
``record_function`` is entered (it costs ~10 us a span; the check costs
well under one), and with no collector either, a span only makes that
check: calls under no collector record nothing.

The collector sits in a ``contextvars.ContextVar``, so the steps deep in
``ops/`` find it without new arguments, and a thread (the service's
workers) sees only its own.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from time import perf_counter

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "mce."

_ACTIVE = contextvars.ContextVar("mce_span_collector", default=None)


class _Collector:
    __slots__ = ("timings", "spans", "open", "outer", "on_device")

    def __init__(self, timings: dict, spans: list, outer):
        self.timings = timings
        self.spans = spans
        self.open: list = []           # names of the spans entered, not left
        self.outer = outer             # the collector this one runs inside
        self.on_device: dict = {}      # (name, device) -> int64 counter


@contextmanager
def collect(timings: dict, spans: list):
    """Record the spans run inside this block into ``timings`` and
    ``spans``, and into the collectors around the block; when the block
    ends without an exception, read its ``device_count`` counters."""
    col = _Collector(timings, spans, _ACTIVE.get())
    token = _ACTIVE.set(col)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
    for (name, _), counter in col.on_device.items():
        _add(col, name, int(counter.item()))


def _add(col, name: str, n) -> None:
    while col is not None:
        col.timings[name] = col.timings.get(name, 0) + n
        col = col.outer


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``timings[name]`` of the active collectors."""
    _add(_ACTIVE.get(), name, n)


def device_count(name: str, device):
    """The active collector's int64 counter on ``device`` for the count
    ``name`` (a 0-d tensor, made at its first use in the block), or None
    with no collector."""
    col = _ACTIVE.get()
    if col is None:
        return None
    key = (name, str(device))
    counter = col.on_device.get(key)
    if counter is None:
        import torch
        counter = col.on_device[key] = torch.zeros((), dtype=torch.int64,
                                                   device=device)
    return counter


class span:
    """``with span(name):`` around one step; see the module docstring."""

    __slots__ = ("name", "_rf", "_col", "_parent", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = record_function(PREFIX + self.name)
            self._rf.__enter__()
        col = self._col = _ACTIVE.get()
        if col is not None:
            c = col
            while c is not None and not c.open:
                c = c.outer
            self._parent = c.open[-1] if c is not None else None
            col.open.append(self.name)
            self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        col = self._col
        if col is not None:
            t1 = perf_counter()
            col.open.pop()
            key = self.name + "_s"
            rec = (self.name, self._parent, self._t0, t1)
            while col is not None:
                timings = col.timings
                timings[key] = timings.get(key, 0.0) + (t1 - self._t0)
                col.spans.append(rec)
                col = col.outer
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False
