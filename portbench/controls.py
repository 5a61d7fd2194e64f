"""The controls of the cells' checks: the plain reference put in the
program's place and computed in the precision below the one the
configuration states, held to the same comparison as a run's answers. Each
must come out not correct. The benchmark's runs do not run them; run them
at a cell's own size, on several seeds, with

    python3 portbench/controls.py --workload <name> --seeds 1,2,3 [--device cuda]

which prints one JSON line a seed with every number compared, its limit and
whether the control failed it.

- ``scan``: the sampled songs' rows from ``reference/analysis.py`` with
  every stored array rounded to bfloat16 (the configuration computes in
  float32), against the float64 reference;
- ``neighbors``: the sampled queries' k nearest by a float32 Gram matrix
  (``knn.nearest_float32``; the configuration's distances are float64),
  against the exact reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import common, generators  # noqa: E402
from portbench.kinds import neighbors, scan  # noqa: E402
from portbench.reference import analysis, knn  # noqa: E402


def scan_control(cell_, seed: int, device) -> dict:
    conf, mix = cell_.config, cell_.traffic
    lengths = generators.song_lengths(mix["songs"], conf["song_min_samples"], conf["song_max_samples"])
    durations = lengths // (2 * conf["sample_rate"])
    library = generators.songs(lengths, seed, device, sample_rate=conf["sample_rate"])
    songs = scan.check_songs(len(lengths), lengths, mix["check_songs"], seed)
    jobs = [(library[i, : lengths[i]], int(durations[i])) for i in songs]
    ref = dict(zip(songs, scan.reference_rows(jobs)))
    control = np.array(scan.reference_rows(jobs, analysis.to_bfloat16), np.float32)
    got = scan.compare(control, np.arange(len(songs)), np.array(songs), ref, durations)
    got["rows_missing"] = 0
    return {name: got[name] for name in scan.LIMITS}


def neighbors_control(cell_, seed: int, device) -> dict:
    conf, mix = cell_.config, cell_.traffic
    n, k = conf["library_entries"], conf["top_k"]
    rows, pairs = generators.library_rows(n, conf["columns"], seed, device, **mix["rows"])
    rows = rows.cpu().numpy()
    queries = neighbors.query_sample(n, pairs, mix["check_queries"], seed)
    ref = knn.nearest(rows, queries, k)
    got = knn.compare(rows, queries, pairs, ref, [knn.nearest_float32(rows, queries, k)])
    return {name: got[name] for name in neighbors.LIMITS}


CONTROLS = {"scan": (scan_control, scan.LIMITS), "neighbors": (neighbors_control, neighbors.LIMITS)}


def readings(cell_, seed: int, device) -> dict:
    """{name: (reading, limit, failed)} of the control of ``cell_`` on
    ``seed``; the control has failed the check where any is failed."""
    fn, limits = CONTROLS[cell_.traffic["kind"]]
    got = fn(cell_, seed, device)
    return {name: (got[name], limits[name], not common.Check(name, got[name], limits[name]).ok)
            for name in limits}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        cell_ = common.cell(args.workload)
    except KeyError:
        cell_ = common.cell_from_files(args.workload)
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell_, seed, args.device)
        failed = any(f for _, _, f in r.values())
        ok &= failed
        print(json.dumps({"workload": args.workload, "seed": seed, "control_failed": failed,
                          "readings": {k: {"value": v, "limit": lim, "failed": f}
                                       for k, (v, lim, f) in r.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
