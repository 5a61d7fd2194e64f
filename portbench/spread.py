"""Runs a cell several times, one process a run, one run after another, and
reports each run's result with the spread of each metric, as the bounds in
``BENCHMARK.json`` are set from it:

    python3 portbench/spread.py --workload <name> --seeds 11,12,13 --seconds 10 \\
        [--trace 0|1] [--out <dir>]

Each run's standard output and error go to ``<dir>/<workload>.<seed>.<k>.out``
and ``.err`` where ``--out`` is given. The summary is one JSON line a run,
then one a metric with its median and spreads (all as a share of the
median): ``iqr``, the distance between the quartiles of all the runs
(``statistics.quantiles(values, n=4)``); ``iqr_drop`` and ``range_drop``,
the same and the whole range once the run farthest from the median is
left out, where that narrows it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def iqr(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return q3 - q1


def drop_farthest(values) -> list:
    """``values`` without the one farthest from their median."""
    m = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - m))
    return [v for i, v in enumerate(values) if i != far]


def spreads(values) -> dict:
    """The median and the spreads of ``values`` as shares of the median."""
    values = [float(v) for v in values]
    m = statistics.median(values)
    out = {"median": m, "n": len(values)}
    if len(values) >= 2:
        kept = drop_farthest(values) if len(values) >= 3 else values
        out["iqr"] = iqr(values) / m
        out["iqr_drop"] = min(iqr(values), iqr(kept) if len(kept) >= 2 else iqr(values)) / m
        out["range_drop"] = min(max(values) - min(values), max(kept) - min(kept)) / m
    return out


def run_once(workload, seed, seconds, trace, out_dir, k):
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=os.path.dirname(HERE))
    wall = time.perf_counter() - t0
    if out_dir:
        base = os.path.join(out_dir, f"{workload}.{seed}.{k}")
        with open(base + ".out", "w") as f:
            f.write(proc.stdout)
        with open(base + ".err", "w") as f:
            f.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "rc": proc.returncode, "wall_s": wall, "result": result,
            "stderr_tail": proc.stderr[-1500:] if result is None else ""}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    runs = []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        r = run_once(args.workload, seed, args.seconds, args.trace, args.out, k)
        runs.append(r)
        print(json.dumps(r), flush=True)
    by_metric = {}
    for r in runs:
        for name, m in ((r["result"] or {}).get("metrics") or {}).items():
            by_metric.setdefault(name, []).append(m["value"])
    for name, values in by_metric.items():
        print(json.dumps({"workload": args.workload, "metric": name, "values": values,
                          **spreads(values)}), flush=True)
    return 0 if all(r["result"] and r["result"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
