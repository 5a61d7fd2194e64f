"""Device records charged to the host range that launched them, by
correlation (``portbench/stages.py``), on hand-made traces, and the stage
report of a small neighbours cell driven whole on the CPU."""

from __future__ import annotations

from unittest import mock

import pytest

from portbench import stages, tracing
from portbench.tests.test_portbench_checks import SEED, small
from portbench.tests.test_portbench_trace import _trace, _x


def _dev(name, cat, ts, dur, corr=None, tid=7):
    e = _x(name, cat, ts, dur, tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(corr, ts, tid=1, name="cudaLaunchKernel", cat="cuda_runtime"):
    return dict(_x(name, cat, ts, 2, tid), args={"correlation": corr})


def _events():
    # window 0..1000 us on thread 1: nearest_neighbors_all 0..600 holds
    # knn.gram 10..100 and knn.topk 100..500 (knn.d2 150..200 nested in it);
    # thread 2 holds its own range 0..900, thread 3 none. The device runs
    # behind the host.
    return [
        _x(tracing.WINDOW, "user_annotation", 0, 1000),
        _x("nearest_neighbors_all", "user_annotation", 0, 600),
        _x("knn.gram", "user_annotation", 10, 90),
        _x("knn.topk", "user_annotation", 100, 400),
        _x("knn.d2", "user_annotation", 150, 50),
        _x("other_thread", "user_annotation", 0, 900, tid=2),
        _launch(1, 20),
        _launch(2, 160, name="cuLaunchKernel", cat="cuda_driver"),
        _launch(3, 300),
        _launch(4, 50, tid=2),
        _launch(5, 550, name="cudaMemsetAsync"),
        _launch(6, 650),
        _launch(7, 700, tid=3),
        _dev("gemm", "kernel", 200, 100, corr=1),
        _dev("elementwise", "kernel", 300, 50, corr=2),
        _dev("radix", "kernel", 350, 300, corr=3),
        _dev("side", "kernel", 400, 20, corr=4),
        _dev("Memset", "gpu_memset", 660, 10, corr=5),
        _dev("late", "kernel", 900, 200, corr=6),
        _dev("no_range", "kernel", 720, 10, corr=7),
        _dev("Memcpy DtoD", "gpu_memcpy", 680, 5),
        _dev("no_call", "kernel", 690, 5, corr=99),
    ]


def _by_range(t0, t1):
    return stages.device_s_by_range(stages.launches(_events()), t0, t1)


def test_each_record_goes_to_the_innermost_range_of_its_launch():
    by = _by_range(0.0, 1000.0)
    # the gemm runs 200..300, under the host's knn.topk and knn.d2, and is
    # charged to knn.gram, where it was launched
    assert by["knn.gram"] == pytest.approx(100e-6)
    assert by["knn.d2"] == pytest.approx(50e-6)  # nested in knn.topk: the inner wins
    assert by["knn.topk"] == pytest.approx(300e-6)
    assert by["nearest_neighbors_all"] == pytest.approx(10e-6)  # the memset
    assert by[tracing.WINDOW] == pytest.approx(100e-6)  # launched after the call, clipped
    assert by["other_thread"] == pytest.approx(20e-6)  # its launching thread's range


def test_records_without_a_launch_or_a_range_go_under_none():
    by = _by_range(0.0, 1000.0)
    # the copy has no correlation, one kernel's has no call, one call's
    # thread has no range
    assert by[None] == pytest.approx((5 + 5 + 10) * 1e-6)
    assert sum(by.values()) == pytest.approx(600e-6)


def test_records_are_clipped_to_the_window():
    by = _by_range(250.0, 950.0)
    assert by["knn.gram"] == pytest.approx(50e-6)  # 250..300 of 200..300
    assert by["knn.topk"] == pytest.approx(300e-6)
    assert by[tracing.WINDOW] == pytest.approx(50e-6)  # 900..950 of 900..1100
    assert sum(by.values()) == pytest.approx(500e-6)
    assert _by_range(1100.0, 1200.0) == {}


def test_launches_keep_each_launch_time():
    recs = {r[:2]: r[2:] for r in stages.launches(_events())}
    assert recs[(200.0, 300.0)] == ("knn.gram", 20.0)
    assert recs[(680.0, 685.0)] == (None, None)
    assert recs[(720.0, 730.0)] == (None, 700.0)


def test_a_range_that_ends_as_the_launch_starts_holds_it_not():
    ev = [_x("a", "user_annotation", 0, 10), _x("b", "user_annotation", 10, 10),
          _launch(1, 10), _dev("k", "kernel", 30, 1, corr=1)]
    assert stages.launches(ev) == [(30.0, 31.0, "b", 10.0)]


def test_the_kept_trace_reads_as_the_harness_s():
    with mock.patch.object(tracing, "Trace", stages._Keeping):
        kept = [_trace(), stages._Keeping(_events())]
    for k in kept:
        plain = tracing.Trace(k.events)
        assert (k.busy_s, k.idle_share(), k.breakdown()) == (plain.busy_s, plain.idle_share(), plain.breakdown())
        assert (k.device, k.spans, k.t0, k.t1) == (plain.device, plain.spans, plain.t0, plain.t1)
    assert kept[0].busy_s == pytest.approx(380e-6) and kept[0].idle_share() == pytest.approx(62.0)


def test_the_stage_report_of_a_small_cell_on_the_cpu():
    """The cell's own traced run keeps its raw events; a CPU trace has no
    device record, so nothing is charged, and every call opens the k-NN's
    spans (2000 rows in blocks of 512: 4 blocks)."""
    c = small("ext49.neighbors")
    r = stages.report(c, SEED, 0.5, "cpu")
    assert r["correct"] and r["calls"] >= 1 and r["device"] == "cpu"
    assert r["device_s_a_call"] == {} and r["knn_share_of_busy"] is None
    calls, spans = r["calls"], r["spans"]
    assert spans["nearest_neighbors_all"] == calls
    assert spans["knn.widen"] == spans["knn.concat"] == calls
    for name in ("knn.gram", "knn.d2", "knn.keys", "knn.topk", "knn.unpack"):
        assert spans[name] == 4 * calls
    assert r["records_before_launch"] == r["records_without_launch"] == r["largest_lead_us"] == 0
