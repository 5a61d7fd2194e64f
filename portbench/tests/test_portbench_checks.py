"""The checks that decide ``correct``, at a size a test run can hold, on the
CPU: the program's sound answers pass them; each cell's control (the
reference in the precision below the configuration's) fails them; and a
run driven whole, the look for a chip skipped, with the timed path broken
underneath in each way the cell can break, comes out not correct."""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from portbench import common, controls
from portbench.kinds import neighbors, scan

SEED = 2**31 + 1234


def small(name):
    c = common.cell_from_files(name)
    if c.traffic["kind"] == "neighbors":
        c.config.update(library_entries=2000, block=512)
        c.traffic.update(check_queries=2000)
        c.traffic["rows"].update(dupes=40)
    else:
        c.config.update(batch_size=4, song_min_samples=180_000, song_max_samples=262_144)
        c.traffic.update(songs=8, check_songs=8)
    return c


def run_small(name, seconds=1.0):
    c = small(name)
    return common.kind_module(c.traffic).run(c, SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["ext49.neighbors", "core4.scan"])
def test_the_program_passes(name):
    out = run_small(name)
    assert out.correct, common.check_lines(out.checks)
    assert out.attempted > 0 and out.failed == 0
    assert out.setup_s > 0 and all(v > 0 for v in out.metrics.values())


@pytest.mark.parametrize("name", ["ext49.neighbors", "core4.scan"])
def test_the_control_fails(name):
    got = controls.readings(small(name), SEED, "cpu")
    assert any(failed for _, _, failed in got.values()), got


def _broken_knn(monkeypatch, fault):
    distance = importlib.import_module("bliss_tpu_torch.sim.distance")
    real = distance.nearest_neighbors_all

    def broken(features, k, block=4096, **kw):
        d, idx = real(features, k, block, **kw)
        d, idx = d.clone(), idx.clone()
        if fault == "answer_altered":
            idx[17, 0] = (idx[17, 0] + 1) % features.shape[0]
        elif fault == "half_left_out":
            half = features.shape[0] // 2
            d[half:] = 0.0
            idx[half:] = 0
        return d, idx

    monkeypatch.setattr(distance, "nearest_neighbors_all", broken)


def _broken_scan(monkeypatch, fault):
    from bliss_tpu_torch import pipeline

    real = pipeline._dispatch_analysis
    last = {}

    def broken(*args, **kw):
        fin = real(*args, **kw)

        def wrong():
            rows = np.array(fin(), copy=True)
            if fault == "answer_altered":
                rows[0, 2] += 1e-2
            elif fault == "half_left_out":
                half = len(rows) // 2
                rows[half:] = rows[:half].mean(0)
            elif fault == "state_unchanged":
                prev = last.get("rows")
                last["rows"] = rows.copy()
                if prev is not None and prev.shape == rows.shape:
                    rows = prev
            return rows

        return wrong

    monkeypatch.setattr(pipeline, "_dispatch_analysis", broken)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_neighbours_faults_come_out_not_correct(monkeypatch, fault):
    _broken_knn(monkeypatch, fault)
    out = run_small("ext49.neighbors", seconds=0.5)
    assert not out.correct, common.check_lines(out.checks)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "state_unchanged"])
def test_scan_faults_come_out_not_correct(monkeypatch, fault):
    _broken_scan(monkeypatch, fault)
    out = run_small("core4.scan")
    assert not out.correct, common.check_lines(out.checks)


def test_scan_batches_replay_the_buckets():
    lengths = np.array([10, 5000, 10, 5000, 10, 10])
    got = scan.batches_of([0, 1, 2, 3, 4, 5, 1, 3], lengths, 2, 1024)
    assert got == [(2048, [0, 2]), (6144, [1, 3]), (2048, [4, 5]), (6144, [6, 7])]


def test_neighbours_sample_holds_every_planted_row():
    pairs = np.array([[3, 9], [40, 41]])
    q = neighbors.query_sample(100, pairs, 10, SEED)
    assert set(pairs.ravel()) <= set(q.tolist()) and len(q) >= 10
    assert np.array_equal(q, neighbors.query_sample(100, pairs, 10, SEED))
