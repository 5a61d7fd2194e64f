"""What every cell of the benchmark shares: reading ``BENCHMARK.json`` and a
cell's files, the program's stage timer with spans, the checks that decide
``correct``, the device's description, and the result line.

Nothing here imports the program or the JAX package; ``run.py`` checks
after the window that neither JAX nor ``bliss_tpu`` was loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (compared whole: the port's
# own name, bliss_tpu_torch, begins with bliss_tpu)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bliss_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN_MODULES))


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration's and traffic's
    files read, and the per-layer metrics that it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``; raises
    KeyError for a name it does not hold."""
    spec = load_spec(root)
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        workload, w["chips"], config, traffic,
        [m for m in spec["end_to_end"] if _reports(m, workload)],
        [m for m in spec["per_layer"] if _reports(m, workload)],
    )


def cell_from_files(workload: str) -> Cell:
    """A cell named ``<config>.<traffic>`` made from
    ``portbench/configs/<config>.json`` and ``portbench/traffic/<traffic>.json``
    alone, on one chip and with no metrics: for a pairing that
    ``BENCHMARK.json`` does not hold (its controls, its tests)."""
    config, traffic = workload.split(".", 1)
    with open(HERE / "configs" / f"{config}.json") as f:
        conf = json.load(f)
    with open(HERE / "traffic" / f"{traffic}.json") as f:
        mix = json.load(f)
    return Cell(workload, 1, conf, mix, [], [])


def kind_module(traffic: dict):
    """The module that generates and drives a traffic mix of this kind:
    ``portbench/kinds/<kind>.py``."""
    return importlib.import_module(f"portbench.kinds.{traffic['kind']}")


def metric_reader(name: str):
    """``read(ctx)`` of ``portbench/metrics/<name>.py``: the per-layer
    metric's value from the run's context, or None where the run holds
    nothing to read it from."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span_timer(base, annotate: bool = False):
    """An instance of the program's ``StageTimer`` (its class ``base``) that
    also keeps each stage's span, (name, thread, start, end) on
    ``time.perf_counter``, and with ``annotate`` marks the span in a
    ``torch.profiler`` trace under the stage's name."""
    import threading

    import torch

    class SpanTimer(base):
        def __init__(self):
            super().__init__()
            self.spans = []

        @contextlib.contextmanager
        def stage(self, name):
            t0 = time.perf_counter()
            mark = torch.profiler.record_function(name) if annotate else contextlib.nullcontext()
            try:
                with mark, super().stage(name):
                    yield
            finally:
                self.spans.append((name, threading.get_ident(), t0, time.perf_counter()))

    return SpanTimer()


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``: it passes while ``value`` is at
    most ``limit`` (a NaN fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back: the end-to-end metrics it measured by
    name (before the trace's), the per-layer context, the checks, the
    counts, the device's memory peak and, for a traced run, the trace."""

    metrics: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    setup_s: float
    context: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.attempted > 0 and all(c.ok for c in self.checks)


def check_lines(checks) -> list[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in checks]


def result_line(cell_: Cell, out: Outcome, trace: bool, device: dict) -> dict:
    """The contract's result object: with ``trace`` the cell's per-layer
    metrics that found something to read, else its end-to-end metrics;
    the checks come last."""
    metrics = {}
    if trace:
        ctx = dict(out.context, trace=out.trace)
        for m in cell_.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_.end_to_end:
            v = out.setup_s if m["name"] == "setup_s" else out.metrics.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {
        "correct": out.correct,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": device,
    }
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit} for c in out.checks}
    return line


def _finite(v):
    """A JSON number, or null for a NaN or an infinity (which JSON lacks)."""
    v = float(v)
    return v if math.isfinite(v) else None
