"""The trace's arithmetic (busy time, idle share, idle gaps by host range)
and the per-layer readers and rooflines, on hand-made traces."""

from __future__ import annotations

import pytest

from portbench import common, tracing, work
from portbench.reference import bounds


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def _trace():
    # window 0..1000 us on thread 1; spans pad 0..300, dispatch 300..600
    # (a copy 350..550 under it), wait 600..900; kernels 580..620 and
    # 610..700 overlapping; a kernel half outside the window; a memset
    return tracing.Trace([
        _x(tracing.WINDOW, "user_annotation", 0, 1000),
        _x("pad", "user_annotation", 0, 300),
        _x("device_dispatch", "user_annotation", 300, 300),
        _x("finalize_wait", "user_annotation", 600, 300),
        _x("device_finalize", "user_annotation", 600, 350, tid=2),
        _x("Memcpy HtoD", "gpu_memcpy", 350, 200, tid=7),
        _x("k1", "kernel", 580, 40, tid=7),
        _x("k2", "kernel", 610, 90, tid=7),
        _x("k3", "kernel", 950, 100, tid=7),
        _x("Memset", "gpu_memset", 800, 10, tid=7),
        _x("aten::add", "cpu_op", 0, 5),
    ])


def test_busy_idle_and_kernels():
    tr = _trace()
    # busy: 350..550, 580..700, 800..810, 950..1000 = 200 + 120 + 10 + 50
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(380e-6)
    assert tr.idle_share() == pytest.approx(62.0)
    assert len(tr.kernels) == 3
    assert tr.kernel_s == pytest.approx((40 + 90 + 50) * 1e-6)


def test_idle_gaps_go_to_the_innermost_range():
    gaps = dict(_trace().idle_gaps())
    # 0..350: pad 300, dispatch 50; 550..580 dispatch; 700..800, 810..900
    # wait 190; 900..950 the window itself
    assert gaps["pad"] == pytest.approx(300e-6)
    assert gaps["device_dispatch"] == pytest.approx(80e-6)
    assert gaps["finalize_wait"] == pytest.approx(190e-6)
    assert gaps[tracing.WINDOW] == pytest.approx(50e-6)
    assert "device_finalize" not in gaps  # another thread's range
    assert sum(gaps.values()) == pytest.approx(1e-3 - 380e-6)


def test_device_ops_by_time():
    ops = _trace().device_ops()
    assert ops[0] == ["Memcpy HtoD", pytest.approx(200e-6)]
    assert [n for n, _ in ops] == ["Memcpy HtoD", "k2", "k3", "k1", "Memset"]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tracing.Trace([_x("k", "kernel", 0, 1)])


def test_no_device_record_reads_nothing():
    tr = tracing.Trace([_x(tracing.WINDOW, "user_annotation", 0, 10)])
    assert tr.idle_share() is None
    ctx = {"trace": tr, "batches": 2, "least_s": 1e-3, "stages": {}}
    for name in ("launches.scan", "device_pass_roofline.scan", "idle_share.scan",
                 "pad_s.scan", "dispatch_s.scan"):
        assert common.metric_reader(name)(ctx) is None


def test_scan_readers():
    tr = _trace()
    ctx = {"trace": tr, "batches": 2, "least_s": 90e-6,
           "stages": {"pad": {"seconds": 0.6, "count": 2},
                      "device_dispatch": {"seconds": 0.3, "count": 2}}}
    read = common.metric_reader
    assert read("pad_s.scan")(ctx) == pytest.approx(0.3)
    assert read("dispatch_s.scan")(ctx) == pytest.approx(0.15)
    assert read("launches.scan")(ctx) == pytest.approx(1.5)
    assert read("device_pass_roofline.scan")(ctx) == pytest.approx(50.0)
    assert read("idle_share.scan")(ctx) == pytest.approx(62.0)
    assert read("knn_roofline.neighbors")(ctx) is None  # not a neighbours run


def test_neighbours_readers():
    ctx = {"trace": _trace(), "calls": 3, "least_s": 190e-6}
    assert common.metric_reader("knn_roofline.neighbors")(ctx) == pytest.approx(50.0)
    assert common.metric_reader("idle_share.neighbors")(ctx) == pytest.approx(62.0)
    assert common.metric_reader("idle_share.scan")(ctx) is None


def test_knn_least_time():
    # 2 N^2 D float64 operations at 67 TFLOP/s beat the bytes
    assert work.knn_least_s(100_000, 49, 5) == pytest.approx(2 * 1e10 * 49 / 67e12)
    assert work.knn_work(10, 2, 3) == {"bytes": 4 * 10 * 2 + 8 * 10 * 3, "fp64_tc": 2 * 100 * 2}
    # a tiny library is bound by its bytes
    assert work.knn_least_s(10, 2, 3) == pytest.approx((80 + 240) / 3.35e12)


def test_device_pass_least_time():
    lengths = [8_388_608] * 63 + [6_000_000]
    w = work.device_pass_work(lengths)
    valid = sum(lengths)
    assert w["bytes"] == 2 * valid + 24 * 64
    assert w["fp64_tc"] == bounds.stats_work(1, valid)["fp64"]
    frames = sum(n // 1024 for n in lengths)
    assert w["fp32"] == bounds.stats_work(1, valid)["fp32"] + bounds.power_work(frames, 64)["fp32"]
    ms, by = bounds.bound_ms(w)
    assert by == "operations" and ms == pytest.approx(w["fp64_tc"] / 67e12 * 1e3)
    assert work.device_pass_least_s([lengths, lengths[:2]]) == pytest.approx(
        (ms + bounds.bound_ms(work.device_pass_work(lengths[:2]))[0]) / 1e3)


def test_frozen_bounds_copy_keeps_the_program_s_bounds():
    # the bounds PERF.md quotes for B=64, L=2^23 (kernels/bounds.py at 18c3400)
    B, L = 64, 1 << 23
    assert bounds.bound_ms(bounds.stats_work(B, L)) == (pytest.approx(0.66812795), "operations")
    assert bounds.bound_ms(bounds.stats_work(B, L, fir_pipe="fp64_tc")) == (
        pytest.approx(0.37060119), "bytes")
    assert bounds.bound_ms(bounds.power_work(B * L // 1024, B)) == (pytest.approx(0.32053959), "bytes")
    assert bounds.bound_ms(bounds.prepass_work(B * L, B)) == (pytest.approx(0.32052033), "bytes")
    assert bounds.PEAK == {"bytes": 3.35e12, "fp32": 67e12, "fp64": 34e12, "fp64_tc": 67e12}
