"""Per-stage wall and CPU timers (the ``StageTimer`` of
``bliss_tpu/utils/profiling.py``, same stage names and ``report()`` keys).

The JAX package's ``trace_annotation`` and ``device_trace`` wrap
``jax.profiler`` and have no counterpart here; the port's device traces come
from ``torch.profiler`` (``chip_smoke.device_trace``).
"""

from __future__ import annotations

import contextlib
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
