"""Device seconds of a cell's traced window by the program's span that
launched them: a record's launching range, by correlation. Each kernel, copy
and set in a ``torch.profiler`` Chrome trace carries ``args.correlation``, as
does the runtime or driver call that launched it; the record goes to the
innermost ``user_annotation`` range open on that call's thread when the call
began (``None``: no correlation, no such call, or no range open). Times that
overlap would not do: the host enqueues far ahead of the card.

    python3 portbench/stages.py --workload <name> --seed <n> --seconds <s>

runs the cell's own traced run (its kind, window and checks, as ``run.py
--trace 1`` does) and prints one JSON line: the device seconds a call of
each launching range (the k-NN's ``knn.*`` spans, where the program opens
them), the share of the busy time that the ``knn.*`` ranges launched, and
the count of records that start before their launch and the largest such
lead in microseconds (none where the host's and the device's clocks agree).
The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from unittest import mock

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import common, tracing  # noqa: E402

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def _innermost(ranges, times) -> list:
    """For each of ``times``, the name of the innermost of ``ranges``
    ((start, end, name)) open then (start <= t < end), or None."""
    marks = [m for i, (a, b, _) in enumerate(ranges) if b > a for m in ((a, 1, i), (b, 0, i))]
    marks += [(t, 2, j) for j, t in enumerate(times)]
    marks.sort()  # at one time: ends, then starts, then the times asked about
    open_, out = {}, [None] * len(times)
    for _, kind, i in marks:
        if kind == 0:
            del open_[i]
        elif kind == 1:
            open_[i] = ranges[i]
        elif open_:
            out[i] = max(open_.values(), key=lambda r: (r[0], -r[1]))[2]
    return out


def launches(events) -> list:
    """(start, end, launching range or None, launch start or None) of each
    device record of ``events``, unclipped, microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    ranges = {}
    for e in xs:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    calls = {_correlation(e): e for e in xs
             if e.get("cat") in LAUNCH_CATS and _correlation(e) is not None}
    out, asked = [], {}  # asked: thread -> [(index into out, launch start)]
    for e in xs:
        if e.get("cat") not in tracing.DEVICE_CATS:
            continue
        call = calls.get(_correlation(e))
        at = float(call["ts"]) if call is not None else None
        if call is not None:
            asked.setdefault(call.get("tid"), []).append((len(out), at))
        out.append([float(e["ts"]), float(e["ts"]) + float(e["dur"]), None, at])
    for tid, qs in asked.items():
        for (k, _), name in zip(qs, _innermost(ranges.get(tid, []), [t for _, t in qs])):
            out[k][2] = name
    return [tuple(r) for r in out]


def device_s_by_range(records, t0: float, t1: float) -> dict:
    """Device seconds of ``launches``' records by launching range (None: see
    the module), each clipped to the window [t0, t1) in microseconds, as
    ``Trace.device`` is."""
    by = {}
    for a, b, name, _ in records:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return by


class _Keeping(tracing.Trace):
    """A ``Trace`` that also keeps the raw events."""

    def __init__(self, events):
        super().__init__(events)
        self.events = events


def report(cell_, seed: int, seconds: float, device="cuda") -> dict:
    """The cell's traced run on ``device``, reduced as the module says."""
    import torch

    with mock.patch.object(tracing, "Trace", _Keeping):
        out = common.kind_module(cell_.traffic).run(cell_, seed, seconds, True, device, time.perf_counter())
    tr, calls = out.trace, out.attempted
    recs = launches(tr.events)
    by = device_s_by_range(recs, tr.t0, tr.t1)
    inside = [(a, at) for a, b, _, at in recs if max(a, tr.t0) < min(b, tr.t1)]
    leads = [at - a for a, at in inside if at is not None and a < at]
    knn = sum(s for name, s in by.items() if name and name.startswith("knn."))
    return {
        "workload": cell_.name, "seed": seed, "correct": out.correct, "calls": calls,
        "window_s": tr.window_s, "busy_s": tr.busy_s,
        "device_s_a_call": {str(name): s / calls for name, s in sorted(by.items(), key=lambda x: -x[1])},
        "knn_share_of_busy": 100.0 * knn / tr.busy_s if tr.busy_s > 0 else None,
        "records_before_launch": len(leads),
        "largest_lead_us": max(leads, default=0.0),
        "records_without_launch": sum(at is None for _, at in inside),
        "spans": dict(sorted(Counter(e["name"] for e in tr.events if e.get("ph") == "X"
                                     and e.get("cat") == "user_annotation").items())),
        "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else str(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    torch.zeros(1, device="cuda")
    print(json.dumps(report(common.cell(args.workload), args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
