"""``BENCHMARK.json`` against the benchmark's contract (names, units, keys,
files, bounds, the time a full check takes), every cell's files present,
no module under ``portbench/`` importing JAX or ``bliss_tpu`` (top-level
names compared whole), and the harness refusing to run where it should."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import common

ROOT = common.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text)


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"]) and (ROOT / word).exists()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[part]]
    assert all(NAME.match(n) for n in names)
    for part in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[part]}) == len(SPEC[part])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        cell = common.cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        assert w["config"] in configs


def test_metric_workloads_name_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_cell_files_exist_and_are_named_from_names():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        conf = json.loads(path.read_text())
        assert set(c["reduced"]) <= set(conf) and conf["name"] == c["name"]
    for w in SPEC["workloads"]:
        traffic = json.loads((common.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (common.HERE / "kinds" / f"{traffic['kind']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (common.HERE / "metrics" / f"{m['name']}.py").is_file()
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.suffix == ".pyc":
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert PATH.match(rel) and all(NAME.match(part) for part in rel.split("/")), rel


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(node.args[0].value)
    return out


def test_nothing_under_portbench_imports_jax_or_bliss_tpu():
    files = sorted(common.HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert common.forbidden_loaded(_imports(f)) == [], f


def test_the_reference_imports_nothing_of_the_program():
    for f in (common.HERE / "reference").glob("*.py"):
        assert not any(m.split(".")[0] == "bliss_tpu_torch" for m in _imports(f)), f


def test_top_level_names_are_compared_whole():
    assert common.forbidden_loaded(["bliss_tpu_torch", "bliss_tpu_torch.sim", "jaxtyping"]) == []
    assert common.forbidden_loaded(["bliss_tpu.api", "jaxlib.xla", "flax"]) == ["bliss_tpu", "flax", "jaxlib"]


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_the_gpus_it_asks_for_no_result_is_printed():
    p = _run(ROOT, "--workload", "ext49.neighbors", "--seed", "5", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and "{" not in p.stdout
    p = _run(ROOT, "--workload", "nope", "--seed", "5", "--seconds", "1")
    assert p.returncode != 0 and "{" not in p.stdout


def test_the_benchmark_alone_does_not_run(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, "--workload", SPEC["workloads"][0]["name"], "--seed", "5", "--seconds", "1")
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_result_line_puts_the_checks_last():
    cell = common.cell(SPEC["workloads"][0]["name"])
    out = common.Outcome(metrics={m["name"]: 1.0 for m in cell.end_to_end}, checks=[
        common.Check("a", 0.5, 1.0), common.Check("b", math.nan, 1.0)], attempted=3, failed=0,
        memory_peak_bytes=7, setup_s=2.0)
    line = common.result_line(cell, out, False, {"platform": "gpu"})
    assert list(line)[-1] == "checks" and line["correct"] is False
    assert line["checks"]["b"]["value"] is None and json.loads(json.dumps(line)) == line
    assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
    assert line["metrics"]["setup_s"]["value"] == 2.0


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in SPEC["workloads"]:
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"], "--seed",
                            "2147483659", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"], p.stderr[-3000:]
