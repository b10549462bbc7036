"""The traced slice of a window: a ``torch.profiler`` trace over whole
units of work (estimates), read back for the device-busy
share, the selection kernels' time and the run's breakdown.

The busy share is the union of kernel, copy and set spans over the traced
window, as ``chip_smoke.py:trace_summary`` takes it.
"""

import json
import os
import re
import time

GPU_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_EVENT_CATS = ("cpu_op", "user_annotation", "python_function")


class Tracer:
    """Starts the profiler at the first unit boundary ``skip_s`` into the
    window and stops it at the first boundary ``slice_s`` after that, so
    the trace holds whole units.  The driver calls ``before_unit`` and
    ``after_unit(flops, nbytes)`` around each unit, with the least
    selection work of that unit; ``finish`` stops a trace still open.
    Disabled, it does nothing."""

    def __init__(self, enabled, device, tmpdir, skip_s=1.0, slice_s=3.0):
        self.enabled = enabled
        self.device = device
        self.tmpdir = tmpdir
        self.skip_s = skip_s
        self.slice_s = slice_s
        self.prof = None
        self.t_window = None
        self.t_start = self.t_stop = None
        self.active = False
        self.done = False
        self.units = 0
        self.flops = 0.0
        self.nbytes = 0.0
        self.events = None

    def warm(self):
        """Start and stop one empty trace, so that the profiler's own first
        start falls into set-up and not into the window."""
        if not self.enabled:
            return
        prof = self._profile()
        prof.start()
        self._sync()
        prof.stop()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def start_window(self):
        self.t_window = time.perf_counter()

    def before_unit(self):
        if not self.enabled or self.done:
            return
        now = time.perf_counter()
        if not self.active and now - self.t_window >= self.skip_s:
            self.prof = self._profile()
            self._sync()
            self.prof.start()
            self.t_start = time.perf_counter()
            self.active = True
        elif self.active and now - self.t_start >= self.slice_s:
            self._stop()

    def after_unit(self, flops, nbytes):
        if self.active:
            self.units += 1
            self.flops += flops
            self.nbytes += nbytes

    def _stop(self):
        self._sync()
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self.active = False
        self.done = True
        path = os.path.join(self.tmpdir, "perfbench_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as fh:
            self.events = [e for e in json.load(fh)["traceEvents"]
                           if e.get("ph") == "X" and "dur" in e]
        os.remove(path)
        self.prof = None

    def finish(self):
        if self.active:
            self._stop()

    @property
    def window_s(self):
        return (self.t_stop - self.t_start) if self.done else None


def device_spans(events):
    """(start, end, name) of every kernel, copy and set span, in us."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in events
                  if e.get("cat") in GPU_EVENT_CATS)


def busy_seconds(events):
    """The union of the device spans, in seconds."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in device_spans(events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6


def kernel_seconds(events, pattern):
    """Seconds of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return 1e-6 * sum(float(e["dur"]) for e in events
                      if e.get("cat") == "kernel" and rx.search(e["name"]))


def _short(name, width=96):
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(events, top=10):
    """The device operations that took the most time, and the longest idle
    gaps between device spans, each named by the host spans around it
    (the outermost and the innermost that cover the gap's middle)."""
    ops = {}
    spans = device_spans(events)
    for a, b, name in spans:
        key = _short(name)
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for a, b, _ in spans:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("cat")) for e in events if e.get("cat") in HOST_EVENT_CATS]
    idle = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        cover = sorted((h for h in host if h[0] <= mid <= h[1]),
                       key=lambda h: h[0] - h[1])
        label = " > ".join(h[2] for h in cover[:2]) or "outside any span"
        # the host op that launched the work ending the gap
        nxt = [h for h in host if a <= h[0] <= b and h[3] == "cpu_op"]
        if nxt:
            label += f" (then {max(nxt)[2]})"
        idle.append([_short(label), length * 1e-6])
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": idle}
