"""Scale demonstrations on one GPU (the port's counterpart of
``scripts/demo_scale.py``):

1. whole-library pairwise similarity: 10k x 10k distance matrix + per-song
   top-100 neighbors (``parallel.sharded_distance_topk`` over every visible
   card), on the device
2. 100k-song k-means clustering (radio playlists)
3. end-to-end library scan: a 384-song library written by
   ``tools.gen_library``, host decode (threaded) -> device analysis under
   ``AnalysisConfig.for_gpu()`` (the prepass and K1 once a batch)

Each time is the mean of warm calls, each ended by a device synchronize.
Runs on ``--device`` (default ``cuda``).

Run: python -m bliss_tpu_torch.tools.demo_scale [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from bliss_tpu_torch.tools import add_device_arg, card_line, device_arg, sync


def timed(fn, *args, device, iters=5):
    """(mean seconds of ``iters`` calls of ``fn(*args)`` after a warm one,
    the last result); the device is synchronized before the clock starts
    and after the last call."""
    r = fn(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    sync(device)
    return (time.perf_counter() - t0) / iters, r


def _count(n: int) -> str:
    """10000 as "10k", as the script prints its sizes."""
    return f"{n // 1000}k" if n % 1000 == 0 else str(n)


def similarity(device, n_pairs: int = 10_000, n_kmeans: int = 100_000, top: int = 100,
               clusters: int = 32, iters: int = 50, log=print) -> dict:
    """Parts 1 and 2 on ``device``: seconds of the distance matrix, of the
    all-song top-``top`` and of the k-means."""
    from bliss_tpu_torch.parallel import analysis_mesh, sharded_distance_topk
    from bliss_tpu_torch.sim.distance import distance_matrix
    from bliss_tpu_torch.sim.kmeans import kmeans

    rng = np.random.RandomState(0)
    out = {}

    # --- 1: 10k x 10k distance matrix + top-k ------------------------------
    feats = torch.from_numpy(rng.randn(n_pairs, 4).astype(np.float32) * 4).to(device)
    out["distance_matrix"], _ = timed(distance_matrix, feats, device=device)
    dt = out["distance_matrix"]
    log(f"{_count(n_pairs)} x {_count(n_pairs)} distance matrix: {dt*1000:.1f} ms "
        f"({n_pairs * n_pairs / dt / 1e9:.2f}G pairs/s)")

    if device.type == "cuda":
        mesh = analysis_mesh(torch.cuda.device_count(), 1)
    else:
        mesh = analysis_mesh(1, 1, devices=[device])
    out["topk"], _ = timed(lambda f: sharded_distance_topk(f, mesh, k=top)[0], feats,
                           device=device)
    log(f"{_count(n_pairs)}-song top-{top} neighbors (all songs): {out['topk']*1000:.1f} ms")

    # --- 2: 100k-song k-means ----------------------------------------------
    feats = torch.from_numpy(rng.randn(n_kmeans, 4).astype(np.float32) * 4).to(device)
    out["kmeans"], _ = timed(lambda f: kmeans(f, k=clusters, iters=iters)[1], feats,
                             device=device, iters=3)
    log(f"{_count(n_kmeans)}-song k-means (k={clusters}, {iters} iters): "
        f"{out['kmeans']*1000:.1f} ms")
    return out


def scan(device, n_songs: int = 384, seconds: int = 11, batch_size: int = 64,
         log=print):
    """Part 3: ``n_songs`` files from ``gen_library.make_library`` scanned by
    ``pipeline.analyze_library`` under ``for_gpu()`` on ``device``; returns
    (the ScanResult, its seconds)."""
    from bliss_tpu_torch.config import AnalysisConfig
    from bliss_tpu_torch.pipeline import analyze_library
    from bliss_tpu_torch.tools.gen_library import make_library

    tmp = tempfile.mkdtemp(prefix="bliss_scale_")
    try:
        files = make_library(tmp, n_songs, seconds)
        t0 = time.perf_counter()
        result = analyze_library(files, cfg=AnalysisConfig.for_gpu(), batch_size=batch_size,
                                 device=device)
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    ok = int(result.ok.sum())
    log(f"e2e library scan ({ok}/{n_songs} songs, decode+analyze): "
        f"{dt:.1f} s = {ok/dt:.1f} songs/s")
    log("stage seconds: " + str({k: v["seconds"] for k, v in result.stats.items()
                                 if isinstance(v, dict)}))
    return result, dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bliss_tpu_torch.tools.demo_scale",
                                 description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "demo_scale")
    if device.type == "cuda":
        print(card_line(), flush=True)
    similarity(device)
    scan(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
