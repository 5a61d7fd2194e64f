"""A run's device trace: ``torch.profiler`` over the measured window,
exported as a Chrome trace into a temporary directory (under ``TMPDIR``),
read back and reduced to what the per-layer metrics and the result's
``breakdown`` need.

The window is the ``record_function`` range that the cell's kind module opens
around it (``WINDOW``). Busy time is the union of the device's records
(kernels, copies, sets) inside it; an idle gap is charged to the innermost
host range open on the window's thread at that moment (the program's
stages, which ``common.span_timer`` marks, or the kind module's own ranges), or
to the window itself where none is. The arithmetic follows
``bliss_tpu_torch/utils/profiling.py::device_trace`` and ``chip_smoke.py``'s
``device_trace`` (commit 18c3400), which read the same records.
"""

from __future__ import annotations

import json
import os
import tempfile

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU and, where there is one, CUDA
    activity); returns (its result, the ``Trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return out, Trace(events)


def _union(intervals):
    """Merged, sorted (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The records of one window. Times are in seconds."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        w = wins[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.tid = w.get("tid")
        self.device = []  # (start, end, name, cat) clipped to the window, microseconds
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                a, b = max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.device.append((a, b, e.get("name", ""), e["cat"]))
        self.spans = []  # (start, end, name) of host ranges on the window's thread
        for e in xs:
            if e.get("cat") == "user_annotation" and e is not w and e.get("tid") == self.tid:
                a, b = max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.spans.append((a, b, e["name"]))
        self.busy_intervals = _union((a, b) for a, b, _, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    @property
    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    @property
    def kernel_s(self) -> float:
        return sum(b - a for a, b, _, _ in self.kernels) / 1e6

    def idle_share(self) -> float | None:
        """Percent of the window with nothing on the device; None where
        the trace holds no device record."""
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for a, b, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n[:96], s] for n, s in by.items()), key=lambda x: -x[1])[:top]

    def gaps(self) -> list:
        """The window's idle intervals (start, end), microseconds."""
        out, t = [], self.t0
        for a, b in self.busy_intervals:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds by the innermost host range open at the time."""
        cuts = sorted({self.t0, self.t1, *(x for a, b, _ in self.spans for x in (a, b))})
        segs = []  # (start, end, name) where one innermost range holds
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            inner = [s for s in self.spans if s[0] <= mid < s[1]]
            segs.append((a, b, max(inner)[2] if inner else WINDOW))
        by, i = {}, 0
        for ga, gb in self.gaps():
            while i < len(segs) and segs[i][1] <= ga:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < gb:
                a, b, name = segs[j]
                by[name] = by.get(name, 0.0) + (min(b, gb) - max(a, ga)) / 1e6
                j += 1
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}
