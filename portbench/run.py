"""Runs one cell of ``BENCHMARK.json`` on the GPUs of this machine and prints
the result as one JSON line, the last of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
trace of the same window. Every run checks what its timed path produced
against a plain reference and prints each number compared beside its
limit, as the last lines of standard error and under ``checks`` in the
result. It exits with another code than 0, and prints no result, without
the GPUs the cell asks for, and when JAX or ``bliss_tpu`` was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({type(exc).__name__})"
    return out.stdout.strip().replace("\n", "; ") or "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[0] = ROOT
    from portbench import common

    try:
        cell = common.cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"no workload {args.workload!r} here: {exc!r}", file=sys.stderr)
        return 2
    t_import = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    t_cuda = time.perf_counter()
    out = common.kind_module(cell.traffic).run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = common.forbidden_loaded()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    if args.trace:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
    line = common.result_line(cell, out, bool(args.trace), device)
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"setup: python and the harness {t_import - T_START:.3f} s, import torch "
          f"{t_torch - t_import:.3f} s, CUDA context {t_cuda - t_torch:.3f} s, the cell "
          f"{json.dumps(out.context.get('setup', {}))}", file=sys.stderr)
    print(f"context: {json.dumps({k: v for k, v in out.context.items() if k not in ('stages', 'setup')})}",
          file=sys.stderr)
    print(f"stages: {json.dumps(out.context.get('stages', {}))}", file=sys.stderr)
    print("\n".join(common.check_lines(out.checks)), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
