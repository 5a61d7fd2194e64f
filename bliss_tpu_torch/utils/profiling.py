"""Profiling hooks: per-stage wall timers and ``torch.profiler``
(counterpart of ``bliss_tpu/utils/profiling.py``: ``StageTimer`` with the
same stage names and ``report()`` keys; ``trace_annotation`` and
``device_trace`` over ``torch.profiler`` where ``bliss_tpu``'s wrap
``jax.profiler``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall time, thread CPU time, and counts per named stage.

    ``cpu_seconds`` uses ``time.thread_time()`` (CLOCK_THREAD_CPUTIME_ID):
    CPU actually burned by the thread running the stage, excluding time it
    sat descheduled behind other threads. On a contended host wall and CPU
    diverge widely, so capacity projections are built from cpu_seconds,
    never from wall (the pad stage's wall time absorbs decode-thread CPU)."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.cpu_seconds = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.cpu_seconds[name] += time.thread_time() - c0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(self.seconds[name], 4),
                "cpu_seconds": round(self.cpu_seconds[name], 4),
                "count": self.counts[name],
            }
            for name in sorted(self.seconds)
        }


_NO_SPAN = contextlib.nullcontext()


def trace_annotation(name: str):
    """The program's span: a ``record_function`` range named ``name`` in a
    ``torch.profiler`` trace, to be used as a context manager.

    With no profiler running it enters nothing: one check of
    ``torch.autograd._profiler_enabled()`` (~0.3 us), where entering and
    leaving a ``record_function`` range costs 13-15 us on the host even
    untraced (torch 2.13). A range's device time is read by correlation
    (each kernel, copy or set carries the id of the runtime call that
    launched it, and that call lies inside the range), not by overlapping
    times: the host enqueues work ahead of the device."""
    import torch

    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block's CPU and, where a GPU is present, CUDA activity
    with ``torch.profiler`` and write it as a Chrome trace
    (``trace-<pid>-<ns>.json``) into ``log_dir``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    )
