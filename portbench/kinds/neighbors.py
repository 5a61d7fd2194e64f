"""Traffic of kind ``neighbors``: one caller asks for every library entry's
k nearest others (``bliss store neighbors``, ``store dupes``) through
``sim.distance.nearest_neighbors_all``, call after call, each waited for.

Set-up makes the library on the device from the seed
(``generators.library_rows``) and makes one call. The window starts with
the first call and ends at the end of the first call that finishes
``seconds`` or more after the start; ``neighbors_s`` is the window's time
over its calls. Afterwards every call's answers for a sample of query rows
drawn from the seed, with every planted row, are held to the plain
reference (``reference/knn.py``).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, generators, tracing, work
from portbench.reference import knn

# the numbers compared and their limits (PERF.md gives the readings that
# set them)
LIMITS = {"dist_err": 1e-5, "self_hits": 0, "twin_miss": 0}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def query_sample(n: int, pairs: np.ndarray, size: int, seed: int) -> np.ndarray:
    """``size`` rows drawn from the seed, and every planted row, sorted."""
    drawn = np.random.default_rng(seed).choice(n, size=min(size, n), replace=False)
    return np.unique(np.concatenate([drawn, pairs.ravel()]))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> common.Outcome:
    import torch
    from torch.profiler import record_function

    from bliss_tpu_torch.sim.distance import nearest_neighbors_all

    t_in = time.perf_counter()
    conf, mix = cell.config, cell.traffic
    n, dim, k, block = conf["library_entries"], conf["columns"], conf["top_k"], conf["block"]
    rows, pairs = generators.library_rows(n, dim, seed, device, **mix["rows"])
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    nearest_neighbors_all(rows, k, block)
    _sync(device)
    setup = {"inputs_s": t_warm - t_in, "warm_s": time.perf_counter() - t_warm}
    calls = []

    def window():
        with record_function(tracing.WINDOW):
            t0 = time.perf_counter()
            while True:
                with record_function("nearest_neighbors_all"):
                    calls.append(nearest_neighbors_all(rows, k, block))
                with record_function("synchronize"):
                    _sync(device)
                if time.perf_counter() - t0 >= seconds:
                    return t0, time.perf_counter()

    if trace:
        (t0, t1), tr = tracing.profiled(window)
    else:
        (t0, t1), tr = window(), None
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    queries = query_sample(n, pairs, mix["check_queries"], seed)
    qi = torch.as_tensor(queries, device=rows.device)
    answers = [(d[qi].cpu().numpy(), i[qi].cpu().numpy()) for d, i in calls]
    rows_host = rows.cpu().numpy()
    ncalls = len(calls)
    del calls, rows, qi
    got = knn.compare(rows_host, queries, pairs, knn.nearest(rows_host, queries, k), answers)
    return common.Outcome(
        metrics={"neighbors_s": (t1 - t0) / ncalls},
        checks=[common.Check(name, got[name], limit) for name, limit in LIMITS.items()],
        attempted=ncalls,
        failed=0,
        memory_peak_bytes=peak,
        setup_s=t0 - t_start,
        context={"setup": setup, "calls": ncalls, "least_s": ncalls * work.knn_least_s(n, dim, k)},
        trace=tr,
    )

