"""Similarity-workload throughput on the device: full-library k-NN (the
port's counterpart of ``scripts/bench_similarity.py``, with its library,
timing, spot check and JSON line).

The `store neighbors` / `store dupes` / playlist workloads reduce to an
all-pairs distance + top-k (``sim.distance.nearest_neighbors_all``: on a
card one launch of the k-NN kernel, float64 products and a running top-k;
on the CPU a float64 [block, N] Gram block + top-k per block). This
measures that path end-to-end at library scale — the N x N compute a
100k-song library pays on every `store dupes` — and prints ONE JSON line,
after a line with the card's name and power limit on a GPU.

Usage: python -m bliss_tpu_torch.tools.bench_similarity [--n 100000]
           [--dim 4] [--k 5] [--block 4096] [--trials 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from bliss_tpu_torch.tools import add_device_arg, card_line, device_arg


def bench(n: int = 100_000, dim: int = 4, k: int = 5, block: int = 4096,
          trials: int = 3, device="cuda"):
    """(the JSON line's dict, the last call's distances [n, k] as numpy):
    ``nearest_neighbors_all`` over ``RandomState(0)``'s ``randn(n, dim) * 3``
    on ``device``, the best of ``trials`` warm calls, each ended by copying
    its distances to the host; row 0 checked against a brute force on the
    host."""
    from bliss_tpu_torch.sim.distance import nearest_neighbors_all

    device = torch.device(device)
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(n, dim).astype(np.float32) * 3).to(device)

    # warm: the first call's allocations
    d, idx = nearest_neighbors_all(feats, k=k, block=block)
    d.cpu()

    best = float("inf")
    for _ in range(trials):
        t0 = time.time()
        d, idx = nearest_neighbors_all(feats, k=k, block=block)
        d = d.cpu().numpy()  # fetch = sync
        best = min(best, time.time() - t0)

    # spot-check one row against brute force on host
    f = feats.cpu().numpy()
    brute = np.sqrt(((f - f[0]) ** 2).sum(1))
    brute[0] = np.inf
    ok = bool(np.allclose(np.sort(brute)[:k], d[0], rtol=1e-3, atol=1e-3))

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    return {
        "metric": "full-library k-NN (store dupes/neighbors path)",
        "n": n,
        "dim": dim,
        "k": k,
        "block": block,
        "device": name,
        "seconds": round(best, 3),
        "pairs_per_sec": round(n * n / best),
        "correct_row0": ok,
    }, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bliss_tpu_torch.tools.bench_similarity",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=4,
                    help="4 = core vectors; 49 = core+extended")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--trials", type=int, default=3)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_arg(args.device, "bench_similarity")

    record, _ = bench(args.n, args.dim, args.k, args.block, args.trials, device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
